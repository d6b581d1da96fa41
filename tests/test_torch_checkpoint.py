"""The port's checkpoint manager against the JAX reference's.

Twins of tests/test_checkpoint.py (round trip, LATEST, specific steps,
atomicity, GC of orphaned tmp dirs, re-saves, structure and config-hash
mismatches, the checksum sidecar and its fallbacks) on tensors, plus the
cross-package checks: a snapshot written by either manager restores in
the other bitwise, with the same leaf names, dtypes and files. With a
`repro_torch.obs.Telemetry` the ``checkpoint_*`` metrics and events
equal the reference's. `restore_resharded` restores onto a 2-rank
gloo mesh (`distributed.run_ranks`), each rank keeping its pieces.
"""

import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.obs import Telemetry as JTelemetry
from repro_torch.checkpoint import CheckpointManager, config_hash
from repro_torch.obs import Telemetry


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(rng.normal(size=(8, 8)).astype(np.float32)),
                   "layers": [{"a": torch.from_numpy(rng.normal(size=(4,)).astype(np.float32))}]},
        "step": torch.tensor(7, dtype=torch.int32),
        "mask": torch.from_numpy(rng.random(5) < 0.5),
    }


def _jstate(seed=0):
    s = _state(seed)
    return {
        "params": {"w": jnp.asarray(s["params"]["w"].numpy()),
                   "layers": [{"a": jnp.asarray(s["params"]["layers"][0]["a"].numpy())}]},
        "step": jnp.asarray(7, jnp.int32),
        "mask": jnp.asarray(s["mask"].numpy()),
    }


def _leaves(tree):
    from repro_torch.checkpoint.manager import _flatten_with_names

    return _flatten_with_names(tree)[1]


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


class TestRoundtrip:
    def test_save_restore_identical(self, tmp_path):
        m = CheckpointManager(str(tmp_path))
        s = _state()
        m.save(s, 10)
        back = m.restore(s)
        _assert_trees_equal(back, s)
        assert isinstance(back["params"]["layers"], list)

    def test_latest_pointer(self, tmp_path):
        m = CheckpointManager(str(tmp_path))
        m.save(_state(), 1)
        m.save(_state(), 5)
        assert m.latest_step() == 5

    def test_restore_specific_step(self, tmp_path):
        m = CheckpointManager(str(tmp_path), keep_last=10)
        m.save(_state(0), 1)
        m.save(_state(1), 2)
        b1 = m.restore(_state(0), step=1)
        b2 = m.restore(_state(0), step=2)
        assert not torch.equal(b1["params"]["w"], b2["params"]["w"])

    def test_config_hash_is_the_reference_s(self):
        from repro.checkpoint import config_hash as jconfig_hash

        for obj in (("a", 1, (2, 3)), "fastmatch", {"k": 5}):
            assert config_hash(obj) == jconfig_hash(obj)


class TestAcrossPackages:
    def test_reference_writes_port_restores(self, tmp_path):
        JManager(str(tmp_path), config_hash="h").save(_jstate(3), 4)
        back = CheckpointManager(str(tmp_path), config_hash="h").restore(_state(0))
        _assert_trees_equal(back, _state(3))

    def test_port_writes_reference_restores(self, tmp_path):
        CheckpointManager(str(tmp_path), config_hash="h").save(_state(3), 4)
        back = JManager(str(tmp_path), config_hash="h").restore(_jstate(0))
        _assert_trees_equal(back, _jstate(3))

    def test_same_layout_as_reference(self, tmp_path):
        """The same files, the same META.json leaves, the same bytes in
        every array file and the sidecar over the same names."""
        CheckpointManager(str(tmp_path / "port")).save(_state(2), 3)
        JManager(str(tmp_path / "ref")).save(_jstate(2), 3)
        port, ref = tmp_path / "port" / "step_3", tmp_path / "ref" / "step_3"
        assert sorted(p.name for p in port.iterdir()) == sorted(p.name for p in ref.iterdir())
        meta_p, meta_r = (json.loads((d / "META.json").read_text()) for d in (port, ref))
        assert meta_p["leaves"] == meta_r["leaves"] and meta_p["step"] == meta_r["step"]
        for f in port.glob("arr_*.npy"):
            assert f.read_bytes() == (ref / f.name).read_bytes()
        sums_p, sums_r = (json.loads((d / "CHECKSUMS.json").read_text()) for d in (port, ref))
        assert sorted(sums_p) == sorted(sums_r)
        assert (tmp_path / "port" / "LATEST").read_text() == "step_3"

    def test_each_rejects_the_others_hash(self, tmp_path):
        JManager(str(tmp_path), config_hash="aaaa").save(_jstate(), 1)
        with pytest.raises(ValueError, match="config hash"):
            CheckpointManager(str(tmp_path), config_hash="bbbb").restore(_state())


class TestFaultTolerance:
    def test_no_tmp_left_after_save(self, tmp_path):
        CheckpointManager(str(tmp_path)).save(_state(), 3)
        assert not list(tmp_path.glob("*.tmp.*"))

    def test_missing_latest_falls_back(self, tmp_path):
        m = CheckpointManager(str(tmp_path))
        m.save(_state(), 4)
        (tmp_path / "LATEST").unlink()
        assert m.latest_step() == 4

    def test_corrupt_latest_ignored(self, tmp_path):
        m = CheckpointManager(str(tmp_path))
        m.save(_state(), 4)
        (tmp_path / "LATEST").write_text("step_99999")
        assert m.latest_step() == 4

    def test_keep_last_gc(self, tmp_path):
        m = CheckpointManager(str(tmp_path), keep_last=2)
        for i in range(5):
            m.save(_state(), i)
        assert m.all_steps() == [3, 4]

    def test_structure_mismatch_rejected(self, tmp_path):
        m = CheckpointManager(str(tmp_path))
        m.save(_state(), 1)
        with pytest.raises(ValueError, match="structure"):
            m.restore({"different": torch.zeros(3)})

    def test_config_hash_mismatch_rejected(self, tmp_path):
        CheckpointManager(str(tmp_path), config_hash="aaaa").save(_state(), 1)
        with pytest.raises(ValueError):
            CheckpointManager(str(tmp_path), config_hash="bbbb").restore(_state())

    def test_same_step_resave_never_deletes_before_commit(self, tmp_path):
        m = CheckpointManager(str(tmp_path))
        m.save(_state(0), 5)
        m.save(_state(1), 5)
        back = m.restore(_state(0), step=5)
        assert torch.equal(back["params"]["w"], _state(1)["params"]["w"])
        assert not list(tmp_path.glob("*.old.tmp.*"))
        assert m.all_steps() == [5]

    def test_gc_sweeps_orphaned_tmp_dirs(self, tmp_path):
        m = CheckpointManager(str(tmp_path))
        dead_dir = tmp_path / "step_7.tmp.4190001"
        dead_dir.mkdir()
        (dead_dir / "arr_0.npy").write_bytes(b"junk")
        dead_latest = tmp_path / "LATEST.tmp.4190002"
        dead_latest.write_text("step_7")
        m.save(_state(), 8)
        assert not dead_dir.exists() and not dead_latest.exists()
        assert m.all_steps() == [8] and m.gc_swept == 2

    def test_gc_spares_live_owners_tmp(self, tmp_path):
        m = CheckpointManager(str(tmp_path))
        live = tmp_path / f"step_9.tmp.{os.getppid()}"
        live.mkdir()
        m.save(_state(), 10)
        assert live.exists() and m.all_steps() == [10]

    def test_failed_save_counted_and_raised(self, tmp_path):
        m = CheckpointManager(str(tmp_path / "ckpt"))
        (tmp_path / "ckpt").rmdir()
        (tmp_path / "ckpt").write_text("not a directory")
        with pytest.raises(OSError):
            m.save(_state(), 1)
        assert m.save_failures == 1

    def test_restore_resharded_refused(self, tmp_path):
        """A placement tree that does not match the snapshot is refused."""
        m = CheckpointManager(str(tmp_path))
        m.save(_state(), 1)
        with pytest.raises(ValueError, match="pspecs"):
            m.restore_resharded(_state(), None, None)

    def test_telemetry_refused(self, tmp_path):
        """The manager takes a `Telemetry` and records its saves into it:
        the same counters, bytes and events as the reference's."""
        out = {}
        for pkg, cls, tel, state in (("port", CheckpointManager, Telemetry(device="cpu"), _state),
                                     ("ref", JManager, JTelemetry(), _jstate)):
            m = cls(str(tmp_path / pkg), telemetry=tel, keep_last=1)
            m.save(state(0), 1)
            m.save(state(1), 2)
            reg = tel.registry
            assert reg.get("checkpoint_saves_total").value == 2
            assert reg.get("checkpoint_save_seconds").count == 2
            out[pkg] = (reg.get("checkpoint_save_bytes_total").value,
                        tel.tracer.skeleton("checkpoint_save"))
        assert out["port"] == out["ref"]
        assert out["port"][0] == 2 * (64 * 4 + 4 * 4 + 4 + 5)


def _resharded_rank(rank, world, directory):
    """Restore onto a (1, 2) mesh: ``w`` sliced over the model axis, the
    rest whole; returns this rank's leaves."""
    from repro_torch.core import distributed

    mesh = distributed.init_mesh((1, 2), device_type="cpu")
    s = _state()
    pspecs = {"params": {"w": distributed.DimSplit(("model",)),
                         "layers": [{"a": distributed.WHOLE}]},
              "step": distributed.WHOLE, "mask": distributed.WHOLE}
    back = CheckpointManager(directory).restore_resharded(s, mesh, pspecs)
    return {name: leaf.numpy() for name, leaf in zip(*_leaves_named(back))}


def _leaves_named(tree):
    from repro_torch.checkpoint.manager import _flatten_with_names

    names, leaves, _ = _flatten_with_names(tree)
    return names, leaves


class TestElasticReshard:
    @pytest.mark.slow
    def test_restore_resharded_roundtrip(self, tmp_path):
        """Saved whole, restored onto a 2-rank mesh: each rank holds its
        rows of ``w`` and every other leaf whole, bitwise."""
        from repro_torch.core import distributed

        s = _state()
        CheckpointManager(str(tmp_path)).save(s, 1)
        ranks = distributed.run_ranks(_resharded_rank, 2, str(tmp_path), timeout=120)
        names, leaves = _leaves_named(s)
        for rank, got in enumerate(ranks):
            assert list(got) == names
            for name, want in zip(names, leaves):
                if name == "params/w":
                    want = want[4 * rank : 4 * (rank + 1)]
                np.testing.assert_array_equal(got[name], want.numpy(), err_msg=name)


class TestChecksums:
    def test_corrupt_counter_and_event_with_telemetry(self, tmp_path):
        out = {}
        for pkg, cls, tel, state in (("port", CheckpointManager, Telemetry(device="cpu"), _state),
                                     ("ref", JManager, JTelemetry(), _jstate)):
            m = cls(str(tmp_path / pkg), telemetry=tel, keep_last=10)
            m.save(state(0), 1)
            m.save(state(1), 2)
            next((tmp_path / pkg / "step_2").glob("arr_*.npy")).write_bytes(b"junk")
            m.restore(state(0))
            assert tel.registry.get("checkpoint_corrupt_steps_total").value == 1
            (ev,) = tel.tracer.events("checkpoint_corrupt")
            assert ev["step"] == 2
            out[pkg] = tel.tracer.skeleton("checkpoint_corrupt")
        assert out["port"] == out["ref"]

    def test_sidecar_written_and_covers_every_file(self, tmp_path):
        m = CheckpointManager(str(tmp_path))
        m.save(_state(), 3)
        step = tmp_path / "step_3"
        sums = json.loads((step / "CHECKSUMS.json").read_text())
        assert set(sums) == {p.name for p in step.iterdir()} - {"CHECKSUMS.json"}
        for fname, want in sums.items():
            assert hashlib.sha256((step / fname).read_bytes()).hexdigest() == want, fname
        assert m.verify_step(3)

    def test_truncated_snapshot_falls_back_to_previous(self, tmp_path):
        m = CheckpointManager(str(tmp_path), keep_last=10)
        m.save(_state(0), 1)
        m.save(_state(1), 2)
        victim = next((tmp_path / "step_2").glob("arr_*.npy"))
        victim.write_bytes(victim.read_bytes()[:-16])
        assert not m.verify_step(2) and m.verify_step(1)
        back = m.restore(_state(0))
        _assert_trees_equal(back, m.restore(_state(0), step=1))
        assert m.corrupt_steps == 1

    def test_explicit_corrupt_step_raises(self, tmp_path):
        m = CheckpointManager(str(tmp_path))
        m.save(_state(), 5)
        next((tmp_path / "step_5").glob("arr_*.npy")).write_bytes(b"\x00" * 32)
        with pytest.raises(ValueError, match="checksum"):
            m.restore(_state(), step=5)

    def test_all_steps_corrupt_is_explicit(self, tmp_path):
        m = CheckpointManager(str(tmp_path))
        m.save(_state(), 1)
        next((tmp_path / "step_1").glob("arr_*.npy")).write_bytes(b"junk")
        with pytest.raises(FileNotFoundError, match="checksum"):
            m.restore(_state())

    def test_legacy_snapshot_without_sidecar_accepted(self, tmp_path):
        m = CheckpointManager(str(tmp_path))
        s = _state()
        m.save(s, 2)
        (tmp_path / "step_2" / "CHECKSUMS.json").unlink()
        assert m.verify_step(2)
        _assert_trees_equal(m.restore(s), s)

    def test_corrupt_step_from_reference_skipped(self, tmp_path):
        """A truncated newest snapshot written by the reference: the port
        falls back to the older one, as the reference does."""
        j = JManager(str(tmp_path), keep_last=10)
        j.save(_jstate(0), 1)
        j.save(_jstate(1), 2)
        victim = next((tmp_path / "step_2").glob("arr_*.npy"))
        victim.write_bytes(victim.read_bytes()[:-8])
        m = CheckpointManager(str(tmp_path))
        _assert_trees_equal(m.restore(_state(5)), _state(0))
        assert m.corrupt_steps == 1
