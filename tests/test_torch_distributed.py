"""The port's mesh rounds against the JAX reference's, on the CPU.

The reference runs in a subprocess over 8 forced host devices
(``--xla_force_host_platform_device_count=8``), as its own multi-device
tests do; the port runs in gloo ranks (`distributed.run_ranks`), one
process a rank, at the reference's test shapes (64 x 16, 300K tuples,
blocks of 512, windows of 32; `tests/test_pump.py`):

  * `make_distributed_round` at 2 x 2 (data x model) over the blocks a
    single-device scheduler read (`tests/test_distributed.py`);
  * `DistributedPump` in lockstep over 12 shuffled global windows at
    2 x 1 and 2 x 2, with a mid-stream admission and retirements;
  * `MatchServer(mesh=, pump=True)` answers at 2 x 2.

Ids, counters, rounds, read masks, counts and n are equal; tau within
2e-5 (`tests/test_kernels.py`); ``log(delta_upper)`` within the
Theorem-1 bound of `tests/test_torch_rounds.py` derived from the
measured tau gap. Also here: `histogram_matmul` with f32, bf16 and f16
one-hots bitwise `histogram_ref` on counts past 256, and the mesh paths
refusing to run without a process group.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import distributed, histsim
from repro_torch.core import multiquery as mq
from repro_torch.kernels import ops, ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAU_ATOL = 2e-5

_REFERENCE = r"""
import sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.core import histsim, multiquery as mq
from repro.core.distributed import make_distributed_round, multi_state_pspecs
from repro.core.pump import DistributedPump
from repro.data.layout import block_layout
from repro.data.synth import SynthSpec, make_dataset, perturb_distribution
from repro.serve.fastmatch_server import MatchServer

ds = make_dataset(SynthSpec(v_z=64, v_x=16, num_tuples=300_000, k=5, n_close=5, seed=3))
blocked = block_layout(ds.z, ds.x, v_z=64, v_x=16, block_size=512, seed=3)
spec = mq.MultiQuerySpec(v_z=64, v_x=16, max_queries=4)
rng = np.random.default_rng(9)
targets = [ds.target] + [perturb_distribution(ds.target, d, rng) for d in (0.01, 0.03, 0.05)]
out = {"z_blocks": blocked.z_blocks}

def mesh_of(d, m):
    return Mesh(np.array(jax.devices()[: d * m]).reshape(d, m), ("data", "model"))

sched = mq.SharedCountsScheduler(blocked, spec, window=64, seed=0, start_block=0)
for t in targets:
    sched.admit(t, k=5, eps=0.08, delta=0.05)
for p in range(0, 6 * 64, 64):
    sched.run_window(sched.order[p : p + 64])
state = mq.init_multi_state(spec)
for slot, t in enumerate(targets):
    q = np.asarray(t, np.float64).ravel(); q = (q / q.sum()).astype(np.float32)
    state = mq.admit_slot(state, jnp.asarray(slot, jnp.int32), jnp.asarray(q),
                          jnp.asarray(5, jnp.int32), jnp.asarray(0.08, jnp.float32),
                          jnp.asarray(0.05, jnp.float32), spec=spec)
read = np.where(sched.read_mask)[0]
z = blocked.z_blocks[read].reshape(-1); x = blocked.x_blocks[read].reshape(-1)
mesh = mesh_of(2, 2)
state = jax.device_put(state, jax.tree.map(lambda s: NamedSharding(mesh, s), multi_state_pspecs()))
zs = jax.device_put(jnp.asarray(z), NamedSharding(mesh, P("data")))
xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))
with mesh:
    a = make_distributed_round(mesh, spec)(state, zs, xs)
out.update(A_read=read, A_counts=np.asarray(a.counts), A_n=np.asarray(a.n),
           A_tau=np.asarray(a.tau), A_du=np.asarray(a.delta_upper), A_eps_i=np.asarray(a.eps_i),
           A_ids=np.stack([np.asarray(histsim.top_k_ids(mq.slot_state(a, s), 5))
                           for s in range(4)]))

order = np.random.default_rng(1).permutation(blocked.num_blocks)
for d, m in ((2, 1), (2, 2)):
    pmp = DistributedPump(blocked, spec, mesh=mesh_of(d, m), window=32, seed=0, start_block=7)
    for t in targets[:3]:
        pmp.admit(t, k=5, eps=0.08, delta=0.02)
    rec = {k: [] for k in ("counts", "n", "tau", "du", "eps_i", "mask", "ctr", "live")}
    for r in range(12):
        if r == 3:
            pmp.admit(targets[3], k=3, eps=0.1, delta=0.02)
        pmp.run_window(order[r * 32 : (r + 1) * 32])
        pmp._poll_terminated()
        st = pmp.state
        rec["counts"].append(np.asarray(st.counts)); rec["n"].append(np.asarray(st.n))
        rec["tau"].append(np.asarray(st.tau)); rec["du"].append(np.asarray(st.delta_upper))
        rec["eps_i"].append(np.asarray(st.eps_i)); rec["mask"].append(pmp.read_mask.copy())
        rec["ctr"].append([pmp.blocks_read, pmp.blocks_considered, pmp.tuples_read, pmp.rounds])
        rec["live"].append([s in pmp.tickets for s in range(4)])
    for k, v in rec.items():
        out[f"B{d}{m}_{k}"] = np.asarray(v)
    out[f"B{d}{m}_ids"] = np.stack([pmp.outcomes[q].ids for q in sorted(pmp.outcomes)])

srv = MatchServer(blocked, max_queries=4, lookahead=64, seed=11, mesh=mesh_of(2, 2), pump=True)
rids = [srv.submit(t, k=5, eps=0.08, delta=0.05) for t in targets]
res = srv.run_until_idle()
for f in ("ids", "rounds", "blocks_read", "tuples_read", "passes", "exact"):
    out[f"C_{f}"] = np.asarray([np.asarray(getattr(res[r], f)) for r in rids])
for f in ("tau", "n", "counts", "eps_i"):
    out[f"C_{f}"] = np.stack([np.asarray(getattr(res[r].state, f)) for r in rids])
out["C_du"] = np.asarray([float(res[r].delta_upper) for r in rids])
out["C_sched"] = np.asarray([srv.scheduler.rounds, srv.scheduler.host_syncs,
                             srv.scheduler.tuples_read])
out["C_mask"] = srv.scheduler.read_mask.copy()
np.savez(sys.argv[1], **out)
"""


def _scenario():
    """The port's copy of the reference scenario's data (bit for bit)."""
    from repro_torch.data.layout import block_layout
    from repro_torch.data.synth import SynthSpec, make_dataset, perturb_distribution

    ds = make_dataset(SynthSpec(v_z=64, v_x=16, num_tuples=300_000, k=5, n_close=5, seed=3))
    blocked = block_layout(ds.z, ds.x, v_z=64, v_x=16, block_size=512, seed=3)
    spec = mq.MultiQuerySpec(v_z=64, v_x=16, max_queries=4)
    rng = np.random.default_rng(9)
    targets = [ds.target] + [perturb_distribution(ds.target, d, rng) for d in (0.01, 0.03, 0.05)]
    return blocked, spec, targets


def _port_ranks(rank, world, shape, parts):
    """One gloo rank of the port's side of the scenario (rank 0 returns
    the records): "A" the distributed round, "B" the pump lockstep, "C"
    the pump server."""
    from repro_torch.core.pump import DistributedPump
    from repro_torch.serve import MatchServer

    blocked, spec, targets = _scenario()
    mesh = distributed.init_mesh(shape, device_type="cpu")
    axes = distributed.mesh_axes(mesh, ("data",), "model")
    out = {"z_blocks": blocked.z_blocks}
    if "A" in parts:
        sched = mq.SharedCountsScheduler(blocked, spec, window=64, seed=0, start_block=0,
                                         device="cpu")
        for t in targets:
            sched.admit(t, k=5, eps=0.08, delta=0.05)
        for p in range(0, 6 * 64, 64):
            sched.run_window(sched.order[p : p + 64])
        state = mq.init_multi_state(spec, device="cpu")
        for slot, t in enumerate(targets):
            q = np.asarray(t, np.float64).ravel()
            state = mq.admit_slot(state, slot, (q / q.sum()).astype(np.float32), 5, 0.08, 0.05)
        placed = distributed.multi_state_pspecs()
        state = mq.MultiQueryState(*(distributed.place_leaf(v, p, mesh)
                                     for v, p in zip(state, placed)))
        read = np.flatnonzero(sched.read_mask)
        z = torch.from_numpy(blocked.z_blocks[read].reshape(-1))
        x = torch.from_numpy(blocked.x_blocks[read].reshape(-1))
        mine = distributed._split_slice(z.shape[0], axes.num_workers, axes.worker)
        a = distributed.make_distributed_round(mesh, spec)(state, z[mine], x[mine])
        counts, n = distributed.gather_counts(a.counts, a.n, axes, spec.v_z)
        out.update(A_read=read, A_counts=counts.numpy(), A_n=n.numpy(), A_tau=a.tau.numpy(),
                   A_du=a.delta_upper.numpy(), A_eps_i=a.eps_i.numpy(),
                   A_ids=np.stack([histsim.top_k_ids(mq.slot_state(a, s), 5).numpy()
                                   for s in range(4)]))
    if "B" in parts:
        order = np.random.default_rng(1).permutation(blocked.num_blocks)
        pmp = DistributedPump(blocked, spec, mesh=mesh, window=32, seed=0, start_block=7)
        for t in targets[:3]:
            pmp.admit(t, k=5, eps=0.08, delta=0.02)
        rec = {k: [] for k in ("counts", "n", "tau", "du", "eps_i", "mask", "ctr", "live")}
        for r in range(12):
            if r == 3:
                pmp.admit(targets[3], k=3, eps=0.1, delta=0.02)
            pmp.run_window(order[r * 32 : (r + 1) * 32])
            pmp._poll_terminated()
            counts, n = pmp._full_counts()
            st = pmp.state
            rec["counts"].append(counts.numpy()); rec["n"].append(n.numpy())
            rec["tau"].append(st.tau.numpy()); rec["du"].append(st.delta_upper.numpy())
            rec["eps_i"].append(st.eps_i.numpy()); rec["mask"].append(pmp.read_mask.copy())
            rec["ctr"].append([pmp.blocks_read, pmp.blocks_considered, pmp.tuples_read,
                               pmp.rounds])
            rec["live"].append([s in pmp.tickets for s in range(4)])
        tag = f"B{shape[0]}{shape[1]}"
        out.update({f"{tag}_{k}": np.asarray(v) for k, v in rec.items()})
        out[f"{tag}_ids"] = np.stack([pmp.outcomes[q].ids for q in sorted(pmp.outcomes)])
    if "C" in parts:
        srv = MatchServer(blocked, max_queries=4, lookahead=64, seed=11, mesh=mesh, pump=True)
        rids = [srv.submit(t, k=5, eps=0.08, delta=0.05) for t in targets]
        res = srv.run_until_idle()
        for f in ("ids", "rounds", "blocks_read", "tuples_read", "passes", "exact"):
            out[f"C_{f}"] = np.asarray([np.asarray(getattr(res[r], f)) for r in rids])
        for f in ("tau", "n", "counts", "eps_i"):
            out[f"C_{f}"] = np.stack([getattr(res[r].state, f).numpy() for r in rids])
        out["C_du"] = np.asarray([float(res[r].delta_upper) for r in rids])
        out["C_sched"] = np.asarray([srv.scheduler.rounds, srv.scheduler.host_syncs,
                                     srv.scheduler.tuples_read])
        out["C_mask"] = srv.scheduler.read_mask.copy()
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference records, port records): the reference's subprocess runs
    while the port's 4 ranks (A, B at 2 x 2, C) and 2 ranks (B at 2 x 1)
    run here."""
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(path)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = distributed.run_ranks(_port_ranks, 4, (2, 2), "ABC", device_type="cpu",
                                         timeout=300)[0]
        port.update(distributed.run_ranks(_port_ranks, 2, (2, 1), "B", device_type="cpu",
                                                   timeout=300)[0])
    finally:
        _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return dict(np.load(path)), port


def _theorem1_gap_ok(du_port, du_ref, tau_port, tau_ref, n, eps_i):
    """|log du_port - log du_ref| <= max_i n_i (eps_i + 2D) 2D + 1e-6, D
    the tau gap (`tests/test_torch_rounds.py`), slot by slot."""
    d = float(np.abs(np.asarray(tau_port, np.float64) - np.asarray(tau_ref, np.float64)).max())
    assert d <= TAU_ATOL, d
    n = np.asarray(n, np.float64)
    for s in range(len(du_ref)):
        bound = float(np.max(n * (np.asarray(eps_i[s], np.float64) + 2 * d) * 2 * d)) + 1e-6
        if du_ref[s] == 0.0 or du_port[s] == 0.0:
            assert du_ref[s] == du_port[s]
            continue
        assert abs(np.log(float(du_port[s])) - np.log(float(du_ref[s]))) <= bound, (s, bound)


@pytest.mark.slow
def test_same_dataset(runs):
    want, got = runs
    np.testing.assert_array_equal(got["z_blocks"], want["z_blocks"])


@pytest.mark.slow
def test_distributed_round_matches_reference(runs):
    """One `make_distributed_round` at 2 x 2 over the same read blocks."""
    want, got = runs
    np.testing.assert_array_equal(got["A_read"], want["A_read"])
    np.testing.assert_array_equal(got["A_counts"], want["A_counts"])
    np.testing.assert_array_equal(got["A_n"], want["A_n"])
    np.testing.assert_array_equal(got["A_ids"], want["A_ids"])
    _theorem1_gap_ok(got["A_du"], want["A_du"], got["A_tau"], want["A_tau"], want["A_n"],
                     want["A_eps_i"])


@pytest.mark.slow
@pytest.mark.parametrize("shape", ["21", "22"])
def test_pump_lockstep_matches_reference(runs, shape):
    """`DistributedPump` round by round: counts, n, read mask, counters and
    the live slots equal, tau within 2e-5, delta_upper within Theorem 1."""
    want, got = runs
    tag = f"B{shape}"
    for key in ("counts", "n", "mask", "ctr", "live"):
        np.testing.assert_array_equal(got[f"{tag}_{key}"], want[f"{tag}_{key}"], err_msg=key)
    for r in range(12):
        _theorem1_gap_ok(got[f"{tag}_du"][r], want[f"{tag}_du"][r], got[f"{tag}_tau"][r],
                         want[f"{tag}_tau"][r], want[f"{tag}_n"][r], want[f"{tag}_eps_i"][r])
    assert len(want[f"{tag}_ids"]) > 0  # the drive retired queries
    np.testing.assert_array_equal(got[f"{tag}_ids"], want[f"{tag}_ids"])


@pytest.mark.slow
def test_pump_server_matches_reference(runs):
    """`MatchServer(mesh=, pump=True)` at 2 x 2: the same answers."""
    want, got = runs
    for f in ("ids", "rounds", "blocks_read", "tuples_read", "passes", "exact", "counts", "n",
              "sched", "mask"):
        np.testing.assert_array_equal(got[f"C_{f}"], want[f"C_{f}"], err_msg=f)
    for i in range(len(want["C_du"])):
        _theorem1_gap_ok(got["C_du"][i : i + 1], want["C_du"][i : i + 1], got["C_tau"][i],
                         want["C_tau"][i], want["C_n"][i], want["C_eps_i"][i][None])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_histogram_matmul_bitwise(dtype):
    """The one-hot product gives `histogram_ref`'s counts bit for bit,
    also past 256 (bf16) and 2048 (f16) a cell, in f32."""
    rng = np.random.default_rng(0)
    z = torch.from_numpy(rng.integers(-1, 5, 100_000).astype(np.int32))  # 4: out of range
    x = torch.from_numpy(rng.integers(-1, 3, 100_000).astype(np.int32))
    want = ref.histogram_ref(z, x, v_z=4, v_x=2)
    assert want.max() > 2048
    got = ref.histogram_matmul(z, x, v_z=4, v_x=2, onehot_dtype=dtype, chunk=32_768)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    h, rows = ops.histogram_with_rowsums(z, x, v_z=4, v_x=2, impl="matmul", onehot_dtype=dtype)
    assert torch.equal(h, want) and torch.equal(rows, want.sum(1))


def test_mesh_paths_need_a_process_group():
    """No process group, no mesh round: the mesh paths raise."""
    from repro_torch.core.pump import DistributedPump

    blocked, spec, _ = _scenario()
    with pytest.raises(RuntimeError, match="process group"):
        DistributedPump(blocked, spec, mesh=object())
    with pytest.raises(RuntimeError, match="process group"):
        mq.SharedCountsScheduler(blocked, spec, mesh=object(), device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        distributed.make_pump_round(object(), spec, blocks_per_worker=8)


def test_run_ranks_runs_on_the_card_unless_asked():
    """`run_ranks` spawns its ranks on the card by default, as every entry
    point of the port runs there unless the caller asks for the CPU;
    without a GPU it raises, naming the CPU option, rather than fall back."""
    import inspect

    assert inspect.signature(distributed.run_ranks).parameters["device_type"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device_type='cpu'"):
            distributed.run_ranks(_port_ranks, 2, (2, 1), "B")
