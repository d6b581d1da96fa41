"""The port stands alone: it loads neither JAX nor the reference package,
and it never runs on the CPU unless asked to."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import resolve_device
from repro_torch.core import engine, histsim
from repro_torch.data.layout import block_layout

SRC = Path(repro_torch.__file__).resolve().parents[1]


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(repro_torch.__path__, prefix="repro_torch.")
    )


def test_every_module_is_covered():
    names = _modules()
    for expected in (
        "repro_torch.convert", "repro_torch.core.engine", "repro_torch.core.multiquery",
        "repro_torch.kernels._build", "repro_torch.kernels.ops", "repro_torch.io.block_source",
        "repro_torch.data.synth", "repro_torch.serve", "repro_torch.serve.fastmatch_server",
        "repro_torch.kernels.autotune", "repro_torch.io.faults", "repro_torch.io.prefetch",
        "repro_torch.checkpoint.manager", "repro_torch.serve.supervisor",
        "repro_torch.obs", "repro_torch.obs.registry", "repro_torch.obs.tracer",
        "repro_torch.obs.telemetry", "repro_torch.core.distributed", "repro_torch.core.pump",
    ):
        assert expected in names


def test_imports_neither_jax_nor_reference():
    code = (
        "import importlib, sys\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.startswith('jax') or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_kernel_sources_exist():
    csrc = Path(repro_torch.__file__).resolve().parent / "kernels" / "csrc"
    assert sorted(p.name for p in csrc.glob("*.cu")) == [
        "anyactive.cu", "distance.cu", "histogram.cu",
    ]


def test_build_key_covers_headers(tmp_path, monkeypatch):
    """An edited header under csrc/ rebuilds the kernels that include it."""
    from repro_torch.kernels import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in _build.CSRC.iterdir():
        (csrc / p.name).write_bytes(p.read_bytes())
    assert (csrc / "row_divisor.cuh").exists()
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path("distance")
    with open(csrc / "row_divisor.cuh", "a") as f:
        f.write("// edited\n")
    assert _build.library_path("distance") != before


def test_profile_marks_in_wide_tile():
    """tools/torch_wide_profile.py stamps at PROFILE-MARK 0 to 6, in order,
    all inside kernel C's wide tile."""
    import importlib.util

    tool = SRC.parent / "tools" / "torch_wide_profile.py"
    spec = importlib.util.spec_from_file_location("torch_wide_profile", tool)
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    text = (SRC / "repro_torch" / "kernels" / "csrc" / "distance.cu").read_text()
    lines = text.split("\n")
    marks = [(i, int(m.group(1))) for i, line in enumerate(lines) if (m := prof.MARK.match(line))]
    assert [k for _, k in marks] == list(range(len(prof.PHASES) + 1))
    start = next(i for i, line in enumerate(lines) if "void wide_tile_tau(" in line)
    end = next(i for i in range(start + 1, len(lines)) if lines[i] == "}")
    assert all(start < i < end for i, _ in marks)
    assert prof.stamped_source(text).count("%%globaltimer") == len(marks)


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present, so the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    rng = np.random.default_rng(0)
    blocked = block_layout(
        rng.integers(0, 8, 4096), rng.integers(0, 4, 4096), v_z=8, v_x=4, block_size=64
    )
    params = histsim.HistSimParams(v_z=8, v_x=4, k=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.run_engine(blocked, np.ones(4), params)
    res = engine.run_engine(blocked, np.ones(4), params, device="cpu")
    assert res.state.counts.device.type == "cpu"


def test_unsupported_device_rejected():
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
