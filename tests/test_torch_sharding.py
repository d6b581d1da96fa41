"""The port's sharding rules against the JAX reference's, leaf by leaf,
with no ranks: the rules are pure functions of names, shapes and a mesh
description.

Every configuration (the ten `ARCH_IDS`), at its smoke size and at its
full size as shapes only (`jax.eval_shape` of the reference's init; the
port's model built on the "meta" device), on the meshes (1, 1), (2, 2),
(2, 4), (16, 16) as ("data", "model") and (2, 16, 16) as ("pod",
"data", "model"): `param_pspecs` and `serving_param_pspecs` equal, by
parameter name; the scan-stacked tree's tail match; `cache_pspecs` in
both modes; `batch_pspec`; the guard's fallbacks; the logical-axis
helpers of `models.layers`; `param_shardings`' blocks tiling every leaf.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.distributed import sharding as jsh
from repro.models import layers as jL
from repro.models.model_zoo import get_model as jget_model
from repro_torch.configs import base as tbase
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import mesh as tmesh
from repro_torch.models import layers as tL
from repro_torch.models import model_zoo

MESHES = {
    "1x1": (("data", "model"), (1, 1)),
    "2x2": (("data", "model"), (2, 2)),
    "2x4": (("data", "model"), (2, 4)),
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
}


class _Mesh:
    """The reference's rules read a mesh's ``axis_names`` and ``shape``
    only: a stand-in with no devices."""

    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


def _cfgs(arch: str, kind: str, **kw):
    get = "get_smoke_config" if kind == "smoke" else "get_config"
    return (dataclasses.replace(getattr(jbase, get)(arch), **kw),
            dataclasses.replace(getattr(tbase, get)(arch), **kw))


def _name(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _flat_specs(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {_name(path): tuple(s) for path, s in leaves}


@functools.lru_cache(maxsize=None)
def _shapes(arch: str, kind: str, **kw):
    """(the reference's parameter shapes, the port's meta model)."""
    jc, tc = _cfgs(arch, kind, **kw)
    shapes = jax.eval_shape(jget_model(jc).init, jax.random.PRNGKey(0))
    return shapes, model_zoo.build(tc, torch.device("meta"))


@pytest.mark.parametrize("kind", ("smoke", "full"))
@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_param_pspecs_equal(arch, kind):
    """Both placements, every leaf, every mesh; the names are the
    reference's tree paths."""
    shapes, model = _shapes(arch, kind)
    for label, (names, sizes) in MESHES.items():
        ref_mesh, desc = _Mesh(names, sizes), dict(zip(names, sizes))
        for fn in ("param_pspecs", "serving_param_pspecs"):
            want = _flat_specs(getattr(jsh, fn)(shapes, ref_mesh))
            got = {k: tuple(v) for k, v in getattr(tsh, fn)(model, desc).items()}
            assert got == want, (label, fn)


@pytest.mark.parametrize("arch", ("llama3_405b", "mixtral_8x7b", "recurrentgemma_2b",
                                  "xlstm_125m"))
def test_scan_stacked_tail_match(arch):
    """The reference's ``scan_layers`` tree (every layer leaf stacked on a
    leading dim) through both packages' rules: the tail match keeps the
    stack dim whole."""
    jc, _ = _cfgs(arch, "smoke", scan_layers=True)
    shapes = jax.eval_shape(jget_model(jc).init, jax.random.PRNGKey(0))
    for label, (names, sizes) in MESHES.items():
        want = _flat_specs(jsh.param_pspecs(shapes, _Mesh(names, sizes)))
        got = tsh.param_pspecs(shapes, dict(zip(names, sizes)))
        got = {_name(p): tuple(s) for p, s in jax.tree_util.tree_flatten_with_path(
            got, is_leaf=lambda x: isinstance(x, tsh.PSpec))[0]}
        assert got == want, label
        if arch == "llama3_405b":
            assert got["layers.attn.wq"][0] is None


def _cache_leaves(cache) -> list:
    """The cache's tensor leaves (and 0-d lengths) in tree order."""
    out = []
    if cache is None:
        return out
    if isinstance(cache, (list, tuple)) and not isinstance(cache, tsh.PSpec):
        for c in cache:
            out += _cache_leaves(c)
        return out
    out.append(cache)
    return out


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_cache_and_batch_pspecs_equal(arch):
    """`cache_pspecs` in both modes on each family's decode state, and
    `batch_pspec`, on every mesh and several batch sizes (4 over 16-way
    data falls back to "data" alone or to whole)."""
    jc, tc = _cfgs(arch, "smoke")
    jcache = jax.eval_shape(lambda: jget_model(jc).init_cache(32, 64))
    tcache = model_zoo.build(tc, torch.device("meta")).init_cache(32, 64)
    ref_leaves = jax.tree_util.tree_leaves(jcache)
    port_leaves = [x for x in _cache_leaves(tcache)]
    assert [tuple(np.shape(a)) for a in ref_leaves] == [
        () if isinstance(a, int) else tuple(a.shape) for a in port_leaves]
    for label, (names, sizes) in MESHES.items():
        ref_mesh, desc = _Mesh(names, sizes), dict(zip(names, sizes))
        for batch in (1, 4, 32, 64):
            assert tuple(tsh.batch_pspec(desc, batch)) == tuple(jsh.batch_pspec(ref_mesh, batch))
            assert tuple(tsh.batch_pspec(desc, batch, 3)) == tuple(
                jsh.batch_pspec(ref_mesh, batch, 3))
        for seq_shard in (False, True):
            want = [tuple(s) for s in jax.tree_util.tree_leaves(
                jsh.cache_pspecs(jcache, ref_mesh, 32, seq_shard=seq_shard),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
            got = [tuple(s) for s in _cache_leaves(
                tsh.cache_pspecs(tcache, desc, 32, seq_shard=seq_shard))]
            assert got == want, (label, seq_shard)


def test_rules_resolution():
    """tests/test_distributed.py's four resolved rules (granite smoke on
    a 1 x 1 mesh), and the same names under the serving placement."""
    model = model_zoo.build(tbase.get_smoke_config("granite_8b"), torch.device("meta"))
    flat = tsh.param_pspecs(model, {"data": 1, "model": 1})
    assert flat["embed.table"] == tsh.PSpec("model", "data")
    assert flat["layers.0.attn.wq"] == tsh.PSpec("data", "model")
    assert flat["layers.0.attn.wo"] == tsh.PSpec("model", "data")
    assert flat["layers.0.mlp.w_down"] == tsh.PSpec("model", "data")
    assert flat["layers.0.attn_norm.scale"] == tsh.PSpec(None)
    assert flat["lm_head.w"] == tsh.PSpec("data", "model")
    serving = tsh.serving_param_pspecs(model, {"data": 1, "model": 1})
    assert serving["embed.table"] == tsh.PSpec("model", None)
    assert serving["layers.0.attn.wq"] == tsh.PSpec(None, "model")


def test_guard_fallbacks():
    """Indivisible dims fall back to whole: whisper's 51,865 vocabulary
    over 16-way TP, qwen's 2 kv heads over 16 (256 columns still split
    16 ways: the guard checks the dim, not the heads), odd batches, and
    an axis the mesh lacks."""
    _, whisper = _shapes("whisper_medium", "full")
    specs = tsh.param_pspecs(whisper, {"data": 16, "model": 16})
    assert specs["embed.table"] == tsh.PSpec(None, "data")
    _, qwen = _shapes("qwen2_5_3b", "full")
    specs = tsh.serving_param_pspecs(qwen, {"data": 16, "model": 16})
    assert specs["layers.0.attn.wk"] == tsh.PSpec(None, "model")
    assert specs["embed.table"] == tsh.PSpec("model", None)
    for spec, shape, want in (
        (("model", "data"), (51865, 1024), (None, "data")),
        ((("pod", "data"), None), (64, 3), (("pod", "data"), None)),
        ((("pod", "data"), None), (48, 3), (None, None)),
        (("pod", None), (64, 3), ("pod", None)),
        (("expert",), (8,), (None,)),
        ((), (4, 4), (None, None)),
    ):
        mesh = MESHES["2x16x16"]
        ref = jsh.guard_pspec(shape, jax.sharding.PartitionSpec(*spec), _Mesh(*mesh))
        got = tsh.guard_pspec(shape, spec, dict(zip(*mesh)))
        assert tuple(got) == tuple(ref) == want
    assert tsh.guard_pspec((4,), ("pod",), {"data": 2, "model": 2}) == tsh.PSpec(None)
    assert tsh.data_axes({"data": 2, "model": 2}) == ("data",)
    assert tsh.data_axes(_Mesh(*MESHES["2x16x16"])) == ("pod", "data")


@pytest.mark.parametrize("label", ("2x2", "2x4", "2x16x16"))
def test_param_shardings_tile_every_leaf(label):
    """Over every coordinate of the mesh, each leaf's blocks cover it once
    (a split dim in equal parts, row-major over its axes); `shard_leaf`
    cuts exactly the block."""
    names, sizes = MESHES[label]
    _, model = _shapes("llama3_405b", "smoke")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    specs = tsh.serving_param_pspecs(model, dict(zip(names, sizes)))
    cover = {n: np.zeros(s, np.int32) for n, s in shapes.items() if len(s) <= 2}
    for coord in np.ndindex(*sizes):
        where = dict(zip(names, coord))
        sh = tsh.param_shardings(model, dict(zip(names, sizes)), pspecs=specs, coord=where)
        for n in cover:
            cover[n][sh[n].index] += 1
    for n, c in cover.items():
        copies = int(np.prod(sizes)) // int(np.prod([
            int(np.prod([dict(zip(names, sizes))[a] for a in (ax if isinstance(ax, tuple)
                                                           else (ax,))]))
            for ax in specs[n] if ax is not None] or [1]))
        assert (c == copies).all(), n
    t = torch.arange(512 * 128).reshape(512, 128)
    sh = tsh.param_shardings({"embed": {"table": t}}, {"data": 2, "model": 4},
                             pspecs={"embed": {"table": tsh.PSpec("model", None)}},
                             coord={"data": 1, "model": 3})
    block = tsh.shard_leaf(t, sh["embed"]["table"])
    assert torch.equal(block, t[384:512]) and block.data_ptr() != t.data_ptr()


def test_param_shardings_needs_a_coordinate():
    with pytest.raises(ValueError, match="coordinate"):
        tsh.param_shardings({"w": torch.zeros(4, 4)}, {"data": 2, "model": 2})


@pytest.mark.parametrize("axes", (("data", "model"), ("pod", "data", "model"), ("model",)))
def test_logical_axes_resolve_as_reference(axes):
    """`set_sharding_rules` / `logical_to_pspec` / `clear_sharding_rules`
    as the reference's, under the default rules and an override; `shard`
    leaves a local tensor as it is, in `manual_mode` too."""
    logical = [("batch", "seq", None), ("batch", None, "heads", None), ("embed", "vocab"),
               ("expert", None, "ff"), ("batch", "kv_seq", None, None), ("lru",), ()]
    try:
        for rules in (None, {"batch": "data", "seq": "model"}):
            jL.set_sharding_rules(rules, axes)
            tL.set_sharding_rules(rules, axes)
            for la in logical:
                assert tuple(tL.logical_to_pspec(la)) == tuple(jL.logical_to_pspec(la)), la
    finally:
        jL.clear_sharding_rules()
        tL.clear_sharding_rules()
    assert tL._ACTIVE_MESH is None and tL._ACTIVE_MESH_AXES == ()
    x = torch.randn(2, 3, 4)
    tL.set_sharding_rules(None, axes, mesh=object())
    try:
        assert tL.shard(x, "batch", None, "ff") is x
        with tL.manual_mode():
            assert tL._MANUAL_DEPTH[0] == 1 and tL.shard(x, "batch", None, None) is x
        assert tL._MANUAL_DEPTH[0] == 0
    finally:
        tL.clear_sharding_rules()


def test_meshes_need_a_process_group():
    """`launch.mesh` builds meshes only over an initialised world."""
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh_for((2, 2), ("data", "model"), device_type="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        from repro_torch.core import distributed

        distributed.init_mesh((1, 1), device_type="cpu")


def test_shard_model_refuses_what_is_not_ported():
    """A family the port has no model for is refused in either layout,
    before any placement, never placed some other way. Every family of
    the ten configurations is placed in both (serving:
    tests/test_torch_shard_families.py; training: tests/test_torch_fsdp.py
    and tests/test_torch_fsdp_families.py)."""
    import dataclasses

    families = {tbase.get_smoke_config(arch).family for arch in jbase.ARCH_IDS}
    assert families == {"dense", "moe", "vlm", "hybrid", "ssm", "audio"}
    cfg = dataclasses.replace(tbase.get_smoke_config("qwen2_5_3b"), family="diffusion")
    for serving in (True, False):
        with pytest.raises(ValueError, match="unknown family 'diffusion'"):
            tsh.shard_model(cfg, None, serving=serving)


# (arch, config changes, mesh shape, the plan's attention layout): the
# smoke configs on a virtual mesh (rank (0, 0), the meta device)
ATTN_LAYOUTS = (
    ("qwen2_5_3b", {}, (1, 4), "q_heads"),  # 4 q heads split 4 ways, 2 kv heads do not
    ("qwen2_5_3b", {}, (2, 2), "heads"),
    ("qwen2_5_3b", dict(decode_seq_shard=True), (1, 4), "whole"),  # flash-decoding
    ("recurrentgemma_2b", {}, (2, 2), "q_heads"),  # 2 q heads, 1 kv head
    ("recurrentgemma_2b", {}, (1, 4), "q_heads"),  # 2 q heads on 4 ranks: 1, 1, 0, 0
    ("recurrentgemma_2b", dict(num_heads=6), (1, 4), "q_heads"),  # 2, 2, 1, 1
    ("whisper_medium", {}, (1, 4), "heads"),
)


@pytest.mark.parametrize("arch,kw,shape,want", ATTN_LAYOUTS,
                         ids=[f"{a}-{s[0]}x{s[1]}-{w}" + (f"-h{kw['num_heads']}" if kw.get(
                             "num_heads") else "") for a, kw, s, w in ATTN_LAYOUTS])
def test_attn_layout_choice(arch, kw, shape, want):
    """`shard_model`'s attention layout: "q_heads" where the kv heads do
    not divide over "model" (the q heads evenly or not), "whole" under
    ``decode_seq_shard``; under "q_heads" the local spec of rank 0 holds
    its ceil(H / |model|) q heads and the kv head they read."""
    from repro_torch.core.distributed import VirtualMesh
    from repro_torch.models.transformer import heads_spec

    cfg = dataclasses.replace(tbase.get_smoke_config(arch), **kw)
    model = tsh.shard_model(cfg, VirtualMesh(shape, ("data", "model"), (0, 0)))
    assert model.tp.attn == want
    spec = tL.AttnSpec(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    local = heads_spec(spec, model.tp)
    if want == "q_heads":
        assert (local.num_heads, local.num_kv_heads) == (-(-cfg.num_heads // shape[1]), 1)
    elif want == "whole":
        assert local == spec


# (heads, model ranks) for the head rule: the pod's recurrentgemma-2b and
# xlstm-125m, the smoke configs on 4 ranks, 1 x 4's full recurrentgemma-2b,
# the uneven twins' 6 heads, and even splits
RANK_HEADS = ((10, 16), (4, 16), (2, 4), (10, 4), (6, 4), (16, 16), (128, 16), (3, 2), (1, 2))


@pytest.mark.parametrize("heads,m", RANK_HEADS, ids=[f"{h}-on-{m}" for h, m in RANK_HEADS])
def test_rank_heads(heads, m):
    """`transformer.rank_heads`: every head on exactly one rank, each
    rank a contiguous range of floor(H / m) or ceil(H / m) heads, rank 0
    a largest share, and the even column block's heads where m divides
    H."""
    from repro_torch.models.transformer import rank_heads

    spans = [rank_heads(heads, tL.TP(None, r, m)) for r in range(m)]
    assert spans[0][0] == 0 and spans[-1][1] == heads
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))  # contiguous, in rank order
    counts = [hi - lo for lo, hi in spans]
    assert set(counts) <= {heads // m, -(-heads // m)} and counts[0] == max(counts)
    if heads % m == 0:
        assert spans == [(r * heads // m, (r + 1) * heads // m) for r in range(m)]


@pytest.mark.parametrize("arch", ("recurrentgemma_2b", "xlstm_125m"))
def test_pod_ranks_share_no_head(arch):
    """On the pod's (16, 16) mesh (full configs, the meta device), the
    model ranks of a data group attend (recurrentgemma-2b's 10 q heads)
    or recur (xlstm-125m's 4 mLSTM and 4 sLSTM heads) disjoint heads
    that together are every head: each rank's local spec and its cache's
    head and channel counts are its `rank_heads`', which tile the heads;
    ranks past the heads hold none."""
    from repro_torch.core.distributed import VirtualMesh
    from repro_torch.models.transformer import heads_spec, rank_heads

    cfg = tbase.get_config(arch)
    spans, attended, recurred = [], 0, [0, 0]
    for r in range(16):
        model = tsh.shard_model(cfg, VirtualMesh((16, 16), ("data", "model"), (0, r)))
        lo, hi = rank_heads(cfg.num_heads, model.tp.tp)
        spans.append((lo, hi))
        cache = model.init_cache(2, 64)
        if arch == "recurrentgemma_2b":
            assert model.tp.attn == "q_heads"
            spec = tL.AttnSpec(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
            local = heads_spec(spec, model.tp)
            assert local.num_heads == hi - lo
            assert {k.shape[2] for k in cache.attn_k if k.shape[1]} == {int(hi > lo)}
            attended += local.num_heads
        else:
            assert model.tp.layout["mlstm"] == model.tp.layout["slstm"] == "heads"
            mheads = {st.c.shape[1] for st in cache.mlstm if st is not None}
            swidth = {st.h.shape[1] for st in cache.slstm if st is not None}
            assert mheads == {hi - lo} and swidth == {(hi - lo) * cfg.d_model // cfg.num_heads}
            recurred[0] += hi - lo
            recurred[1] += swidth.pop()
    assert [h for lo, hi in spans for h in range(lo, hi)] == list(range(cfg.num_heads))
    if arch == "recurrentgemma_2b":
        assert attended == cfg.num_heads
    else:
        assert recurred == [cfg.num_heads, cfg.d_model]


# (q heads, kv heads, model ranks) -> each rank's kv heads under "q_heads"
Q_HEADS_KV = (
    ((16, 2, 16), [[r // 8] for r in range(16)]),  # qwen2.5-3b: one q head a rank
    ((128, 8, 16), [[r // 2] for r in range(16)]),  # llama3-405b: half a group a rank
    ((32, 8, 4), [[2 * r, 2 * r + 1] for r in range(4)]),  # two whole groups a rank
    ((48, 8, 16), [[r // 2] for r in range(16)]),  # grok-1: 3 of a group's 6
    ((12, 3, 2), [[0, 0, 0, 0, 1, 1], [1, 1, 2, 2, 2, 2]]),  # blocks span groups unequally
)


@pytest.mark.parametrize("heads,want", Q_HEADS_KV, ids=[f"{h}-{k}-{m}" for (h, k, m), _ in
                                                         Q_HEADS_KV])
def test_q_heads_kv(heads, want):
    """The kv heads each rank's q heads read (q head h reads h // (H /
    Hkv)), each once where the rank's q heads read them equally often,
    else one a q head."""
    from repro_torch.models.transformer import q_heads_kv

    h, kv, m = heads
    spec = tL.AttnSpec(h, kv, 8)
    assert [q_heads_kv(spec, tL.TP(None, r, m)) for r in range(m)] == want
