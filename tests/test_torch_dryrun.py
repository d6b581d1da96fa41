"""The dry-run launcher (`repro_torch.launch.dryrun`, `launch.specs`,
`launch.roofline`) against the JAX reference's and against real ranks.

The reference compiles each cell with XLA; the port runs one rank's step
on the meta device under a `VirtualMesh` whose groups record their
collectives. What can be held here without an XLA compile:

* `cell_supported` and `input_specs` equal the reference's for every
  arch × shape;
* each cell's useful FLOPs, and the bytes of parameters and optimizer
  state a rank holds on the production meshes, equal those computed
  from the reference's config, `param_pspecs` and `opt_state_pspecs`
  (each leaf's bytes over the mesh axes its spec splits it on);
* the recorder is honest: one train step and one decode tick on the
  meta device record the all-reduce calls and bytes that four gloo CPU
  ranks issue for the same step and tick, rank by rank, and the FLOPs
  counted on meta equal the same counter over the real rank's step;
* the CLI writes its JSONs and `roofline.render` reads them;
* the port's FLOPs a device on five production cells stay within
  `FLOPS_BAR` of the reference's (each rank attends only its q heads
  where the kv heads do not divide "model", and runs only its own MoE
  pairs), and on four cells whose heads do not divide "model" either
  (recurrentgemma-2b's 10 q heads, xlstm-125m's 4 heads, on 16 ranks),
  measured at a busiest model rank (each rank attends or recurs only its
  own heads, `transformer.rank_heads`).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.distributed import sharding as jsh
from repro.launch import specs as jspecs
from repro.models.model_zoo import get_model as jget_model
from repro.optimizer import get_optimizer as jget_optimizer
from repro_torch.configs import base as tbase
from repro_torch.core import distributed
from repro_torch.core.distributed import VirtualMesh
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import make_virtual_mesh
from repro_torch.launch.specs import build_case, input_specs, make_case
from repro_torch.models.base import TensorSpec
from repro_torch.models.layers import TP
from repro_torch.models.transformer import rank_heads
from repro_torch.optimizer.base import tree_leaves

import torch_shard_ranks as R

# the reference's dryrun sets XLA_FLAGS for 512 host devices when imported;
# this process keeps its own (no jax backend starts during the import)
_saved = os.environ.get("XLA_FLAGS")
try:
    from repro.launch import dryrun as jdryrun
finally:
    if _saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = _saved

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


class _Mesh:
    """A mesh description the reference's rules read (axis names, shape)."""

    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_cells_and_inputs_equal_reference(arch):
    """For every shape: whether the cell runs, and each input's name,
    global shape and dtype."""
    for shape_name in jbase.SHAPES:
        assert dryrun.cell_supported(arch, shape_name) == jdryrun.cell_supported(arch,
                                                                               shape_name)
        want = jspecs.input_specs(jbase.get_config(arch), jbase.SHAPES[shape_name])
        got = input_specs(tbase.get_config(arch), tbase.SHAPES[shape_name])
        assert list(got) == list(want), shape_name
        for k, v in want.items():
            assert got[k] == TensorSpec(tuple(v.shape), getattr(torch, str(v.dtype))), (k, v)


def _rank_bytes(tree, specs, sizes: dict) -> int:
    """A rank's bytes of ``tree`` (ShapeDtypeStructs) placed by ``specs``
    (the reference's PartitionSpecs): each leaf over the axes its spec
    splits it on (the specs are divisibility-guarded)."""
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        parts = 1
        for axes in spec:
            for ax in (axes if isinstance(axes, tuple) else (axes,) if axes else ()):
                parts *= sizes[ax]
        n = int(np.prod(leaf.shape)) * leaf.dtype.itemsize
        assert n % parts == 0
        total += n // parts
    return total


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_rank_bytes_equal_reference_specs(arch):
    """train_4k on the first rank of the pod and of the 2-pod mesh (the
    dense, MoE and vlm families stacked, as the dry run trains them):
    the useful FLOPs 6 N_active B S of the reference's config; the bytes
    of parameters and of optimizer state the rank holds equal the
    reference's leaves over their specs' split axes."""
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    if tcfg.family in dryrun.SCANNABLE:
        jcfg = dataclasses.replace(jcfg, scan_layers=True)
        tcfg = dataclasses.replace(tcfg, scan_layers=True)
    shape = jbase.SHAPES["train_4k"]
    params = jax.eval_shape(jget_model(jcfg).init, jax.random.PRNGKey(0))
    opt = jax.eval_shape(jget_optimizer(jcfg.optimizer, 1e-3).init, params)
    for kind, (sizes, names) in MESHES.items():
        desc = _Mesh(names, sizes)
        p_specs = jsh.param_pspecs(params, desc)
        saved, jspecs._MESH[0] = jspecs._MESH[0], desc
        try:
            o_specs = jspecs.opt_state_pspecs(opt, p_specs)
        finally:
            jspecs._MESH[0] = saved
        axes = dict(zip(names, sizes))
        case = build_case(arch, "train_4k", make_virtual_mesh(multi_pod=kind == "multipod"),
                          cfg=tcfg)
        assert case.model_flops == 6.0 * jcfg.active_param_count * shape.global_batch \
            * shape.seq_len
        got_p = sum(p.numel() * p.element_size() for p in case.model.parameters())
        got_o = sum(t.numel() * t.element_size()
                    for t in tree_leaves(case.state.opt_state))
        assert got_p == _rank_bytes(params, p_specs, axes), kind
        assert got_o == _rank_bytes(opt, o_specs, axes), kind


@pytest.fixture(scope="module")
def real_ranks():
    toks = np.random.default_rng(5).integers(0, 256, (4, 16)).astype(np.int32)
    return distributed.run_ranks(R.dryrun_rank, 4, toks, device_type="cpu", timeout=300)


def test_recorder_matches_real_ranks(real_ranks):
    """On every rank of a 2 x 2 mesh: the meta run of each train step
    (qwen2.5-3b stacked; mixtral-8x7b stacked at capacity factor 0.5,
    whose expert counts are exchanged) records the all-reduce calls and
    payload bytes the gloo rank issued, and counts its FLOPs; one decode
    tick records the tick's calls and bytes. The wire bytes are twice
    the payload (the reference's all-reduce charge)."""
    for r in real_ranks:
        coord = (r["coord"]["data"], r["coord"]["model"])
        for case, arch, kw in R.DRY_CASES:
            mesh = VirtualMesh((2, 2), ("data", "model"), coord)
            c = make_case(R.dry_cfg(arch, **kw), mesh, "train",
                          {"tokens": TensorSpec((4, 16), torch.int32)}, lr=R.FSDP_LR)
            m = dryrun.measure(c.fn, c.args, mesh)
            assert m["totals"] == r[case]["collectives"], (coord, case)
            assert m["flops"] == r[case]["flops"] > 0, (coord, case)
            assert m["colls"] == {"all-reduce": {"count": m["totals"]["calls"],
                                                 "bytes": 2 * m["totals"]["bytes"]}}
        mesh = VirtualMesh((2, 2), ("data", "model"), coord)
        c = make_case(R.dry_cfg(R.DRY_CASES[0][1]), mesh, "decode",
                      {"token": TensorSpec((4,), torch.int32)}, max_len=R.DRY_MAX_LEN)
        m = dryrun.measure(c.fn, c.args, mesh)
        assert m["totals"] == r["decode"]["collectives"] and m["totals"]["calls"] > 0, coord


def test_cli_writes_and_roofline_reads(tmp_path, capsys):
    """`dryrun.main` writes xlstm-125m x decode_32k x pod and the
    FastMatch round on the pod, each ``ok`` with FLOPs, a bottleneck and
    the H100's denominators; `roofline.render` reads both."""
    out = str(tmp_path)
    assert dryrun.main(["--arch", "xlstm-125m", "--shape", "decode_32k", "--mesh", "pod",
                        "--out", out]) == 0
    assert dryrun.main(["--arch", "fastmatch_round", "--mesh", "pod", "--out", out]) == 0
    capsys.readouterr()
    for name in ("xlstm_125m_decode_32k_pod", "fastmatch_round_pod"):
        d = json.loads((tmp_path / f"{name}.json").read_text())
        assert d["ok"] and d["flops_per_device"] > 0 and d["chips"] == 256
        assert d["roofline"]["bottleneck"] in ("compute", "memory", "collective")
        assert d["hardware"]["peak_flops"] == 989e12 and "H100" in d["hardware"]["card"]
        assert d["collectives"]["all-reduce"]["count"] > 0
        assert d["memory"]["argument_bytes"] > 0 and d["memory"]["temp_bytes"] > 0
    table = roofline.render("pod", results=out)
    assert "| xlstm_125m | decode_32k |" in table and "| fastmatch_round |" in table


# The reference's FLOPs a device (XLA's cost_analysis) on rank (0, 0) of
# the pod's (16, 16) ("data", "model") mesh, baseline profile, each from
#   python -m repro.launch.dryrun --arch <arch> --shape <shape> --mesh pod
# on the CPU (not compiled here: 256 placeholder devices a cell). XLA
# counts a loop's body once, and the reference's chunked attention loops
# over KV chunks of 1,024 where the keys are longer than 2,048, so the
# figures of the 32k and 4k cells below count one chunk's attention: they
# are lower bounds, which makes their bars stricter than they read
REFERENCE_FLOPS = {
    ("qwen2.5-3b", "train_4k"): 1.045e14,
    ("mixtral-8x7b", "train_4k"): 6.711e14,
    ("llama3-405b", "train_4k"): 1.266e16,
    ("llama3-405b", "prefill_32k"): 3.346e15,
    ("llama3-405b", "decode_32k"): 7.283e11,
}
FLOPS_BAR = 1.5


@pytest.fixture(scope="module")
def pod_cells():
    """`dryrun.run_cell` of each `REFERENCE_FLOPS` cell on the pod (the
    meta device; ~2 min together)."""
    return {cell: dryrun.run_cell(*cell, "pod", verbose=False) for cell in REFERENCE_FLOPS}


@pytest.mark.parametrize("cell", list(REFERENCE_FLOPS), ids=lambda c: f"{c[0]}-{c[1]}")
def test_pod_flops_near_reference(pod_cells, cell):
    """The port's FLOPs a device at most `FLOPS_BAR` times the
    reference's: no rank attends heads, or runs expert rows, that the
    reference's partitioned program does not (qwen2.5-3b's 2 kv heads
    and llama3-405b's and mixtral-8x7b's 8 do not divide the 16-way
    model axis: their ranks attend their own q heads, "q_heads")."""
    got = pod_cells[cell]
    assert got["ok"] and got["coordinate"] == {"data": 0, "model": 0}
    assert 0 < got["flops_per_device"] <= FLOPS_BAR * REFERENCE_FLOPS[cell], \
        f"{got['flops_per_device']:.4g} against the reference's {REFERENCE_FLOPS[cell]:.4g}"


# Cells whose heads do not divide the pod's 16 model ranks: the
# reference's FLOPs a device as above, the two chunked cells with every
# attention in one KV chunk (one trip of the loop XLA counts once, the
# same math), from
#   PYTHONPATH=src python tools/ref_dryrun_one_trip.py --arch recurrentgemma-2b --shape <shape>
# and the decode cells' plain figures from the reference's dry run
REFERENCE_FLOPS_UNEVEN = {
    ("recurrentgemma-2b", "train_4k"): 1.167e14,  # one trip (XLA's count: 9.179e13)
    ("recurrentgemma-2b", "prefill_32k"): 1.128e14,  # one trip (XLA's count: 2.688e13)
    ("recurrentgemma-2b", "decode_32k"): 3.909e9,
    ("xlstm-125m", "decode_32k"): 2.039e8,
}


def _busiest(arch: str) -> int:
    """The last model rank of the pod holding the most heads (rank 0
    holds as many; `transformer.rank_heads`)."""
    h = tbase.get_config(arch).num_heads
    counts = [hi - lo for lo, hi in (rank_heads(h, TP(None, r, 16)) for r in range(16))]
    return max(r for r in range(16) if counts[r] == max(counts))


@pytest.fixture(scope="module")
def uneven_cells():
    """`dryrun.run_cell` of each `REFERENCE_FLOPS_UNEVEN` cell on the pod
    at data rank 0 and its busiest model rank (the meta device)."""
    return {cell: dryrun.run_cell(*cell, "pod", verbose=False,
                                  coordinate=(0, _busiest(cell[0])))
            for cell in REFERENCE_FLOPS_UNEVEN}


@pytest.mark.parametrize("cell", list(REFERENCE_FLOPS_UNEVEN), ids=lambda c: f"{c[0]}-{c[1]}")
def test_uneven_heads_flops_near_reference(uneven_cells, cell):
    """The port's FLOPs a device at a busiest model rank at most
    `FLOPS_BAR` times the reference's: each rank attends (recurrentgemma-2b)
    or recurs (xlstm-125m's mLSTM and sLSTM) only its own heads, though
    they do not divide "model"; a rank with fewer heads does less."""
    got = uneven_cells[cell]
    busiest = _busiest(cell[0])
    assert got["ok"] and got["coordinate"] == {"data": 0, "model": busiest} and busiest > 0
    assert 0 < got["flops_per_device"] <= FLOPS_BAR * REFERENCE_FLOPS_UNEVEN[cell], \
        f"{got['flops_per_device']:.4g} against the reference's {REFERENCE_FLOPS_UNEVEN[cell]:.4g}"
    if cell[1] == "decode_32k":  # cheap enough to run every model rank: none does more
        flops = [dryrun.run_cell(*cell, "pod", verbose=False, coordinate=(0, r))[
            "flops_per_device"] for r in range(16)]
        assert max(flops) == got["flops_per_device"] == flops[0] > min(flops)
