"""Parameter/activation sharding rules (DP + FSDP + TP, optional pod DP),
and the placement that builds a rank-local model from them.

Port of `repro.distributed.sharding`. Policy (MaxText-flavored), as in
the reference:
  * activations: batch over ("pod","data"); model-parallel dims over "model"
  * weights: FSDP-shard the d_model-like dim over "data", TP-shard the
    heads/ff/vocab-like dim over "model" (Megatron layout)
  * MoE experts: expert dim local, (d_model -> "data", d_ff -> "model")
  * norms / biases / small tables: replicated (or TP where they align
    with a TP-sharded matmul output)

Every rule is divisibility-guarded: a dim that does not divide the mesh
axis size (whisper's 51865 vocab over 16-way TP, batch 1 on a 500k
decode) falls back to replicated. Anything the name table does not
match is replicated.

The rules are pure functions of leaf names and shapes and a mesh
*description*: axis names and sizes (`MeshSpec`, from a `DeviceMesh`,
a ``{axis: size}`` dict or any object with ``axis_names`` and a
``shape`` dict), so they run with no process group. A `PSpec` is the
reference's PartitionSpec: one entry a dim, None, an axis name or a
tuple of axis names. A parameter tree is a `torch.nn.Module` (its
``named_parameters()``; the dotted names split into the reference's
path, list indices as ``[i]``; the result a ``{name: PSpec}`` dict) or
a nested dict / list tree whose leaves have a ``shape`` (the result a
tree of the same structure).

PyTorch has no SPMD partitioner here: `param_shardings` gives each
leaf this rank's block (a `Sharding`), and `shard_model` builds a model
of any family that holds only those blocks and issues the collectives
the layout implies (`repro_torch.models.transformer`, `rglru`, `xlstm`,
`whisper`). Serving shards over "model" only (`serving_param_pspecs`).
Training places every family under `param_pspecs` (FSDP over "data" ×
TP over "model", ``shard_model(serving=False)``): each data-split block
is gathered whole over the data group where the model reads it, and its
gradient summed back into the block (`ShardPlan.whole`);
`repro_torch.train.make_train_step` runs the step on the mesh and
`repro_torch.launch.specs.opt_state_pspecs` places the optimizer state.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

__all__ = [
    "MeshSpec",
    "PSpec",
    "ShardPlan",
    "Sharding",
    "batch_pspec",
    "cache_pspecs",
    "data_axes",
    "guard_pspec",
    "mesh_spec",
    "param_pspecs",
    "param_shardings",
    "serving_param_pspecs",
    "shard_leaf",
    "shard_model",
]


class PSpec(tuple):
    """The reference's ``PartitionSpec``: per dim None (whole), a mesh
    axis, or a tuple of axes (row-major over them); a tuple of one axis
    is that axis, as the reference normalizes it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"PSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh's axis names and sizes, no devices or ranks."""

    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def mesh_spec(mesh) -> MeshSpec:
    """The description of ``mesh``: a `MeshSpec`, a `DeviceMesh`, a
    ``{axis: size}`` dict, or an object with ``axis_names`` and a
    ``shape`` mapping (the reference's Mesh or AbstractMesh)."""
    if isinstance(mesh, MeshSpec):
        return mesh
    if isinstance(mesh, Mapping):
        return MeshSpec(tuple(mesh), tuple(int(v) for v in mesh.values()))
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # a DeviceMesh
        return MeshSpec(tuple(names), tuple(int(s) for s in mesh.mesh.shape))
    names = tuple(mesh.axis_names)
    return MeshSpec(names, tuple(int(mesh.shape[a]) for a in names))


def data_axes(mesh) -> tuple:
    names = mesh_spec(mesh).axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def _axis_size(ms: MeshSpec, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= ms.shape[a]
    return size


def guard_pspec(shape, spec, mesh) -> PSpec:
    """Drop spec entries whose dim is not divisible by the mesh axes."""
    ms = mesh_spec(mesh)
    out = []
    for i, axes in enumerate(spec):
        if axes is None:
            out.append(None)
            continue
        present = axes if isinstance(axes, tuple) else (axes,)
        present = tuple(a for a in present if a in ms.axis_names)
        if not present:
            out.append(None)
            continue
        size = _axis_size(ms, present)
        if i < len(shape) and shape[i] % size == 0 and shape[i] > 0:
            out.append(present if len(present) > 1 else present[0])
        else:
            out.append(None)
    out += [None] * (len(shape) - len(out))
    return PSpec(*out[: len(shape)])


# (parent_hint, name) -> logical spec by ndim. None parent = any.
# Conventions: "D"=d_model-like (FSDP/"data"), "T"=TP/"model", "-"=replicated.
_RULES = [
    # embeddings / unembeddings
    ("embed", "table", ("T", "D")),  # (vocab, d): vocab TP, d FSDP
    ("lm_head", "w", ("D", "T")),
    (None, "dec_pos", ("-", "-")),
    # attention
    (None, "wq", ("D", "T")),
    (None, "wk", ("D", "T")),
    (None, "wv", ("D", "T")),
    (None, "wo", ("T", "D")),
    (None, "bq", ("T",)),
    (None, "bk", ("T",)),
    (None, "bv", ("T",)),
    # dense MLPs
    (None, "w_gate", ("D", "T")),
    (None, "w_up", ("D", "T")),
    (None, "w_down", ("T", "D")),
    (None, "b_up", ("T",)),
    (None, "b_down", ("-",)),
    # MoE (3D expert weights) — expert dim local
    ("moe", "w_gate", ("-", "D", "T")),
    ("moe", "w_up", ("-", "D", "T")),
    ("moe", "w_down", ("-", "T", "D")),
    ("moe", "router", ("D", "-")),
    # RG-LRU
    (None, "w_in", ("D", "T")),
    (None, "w_gate_branch", ("D", "T")),
    (None, "conv_w", ("-", "T")),
    (None, "conv_b", ("T",)),
    (None, "w_a", ("D", "T")),
    (None, "w_x", ("D", "T")),
    (None, "b_a", ("T",)),
    (None, "b_x", ("T",)),
    (None, "lam", ("T",)),
    (None, "w_out", ("T", "D")),
    # xLSTM
    (None, "w_if", ("D", "-")),
    (None, "w_gates", ("D", "T")),
    (None, "r_gates", ("-", "T", "-", "-")),
    (None, "b_gates", ("-",)),
    (None, "w_ff_gate", ("D", "T")),
    (None, "w_ff_up", ("D", "T")),
    (None, "w_ff_down", ("T", "D")),
]

_LOGICAL = {"D": "data", "T": "model", "-": None}


def _match(names: list, shape) -> Optional[tuple]:
    leaf = names[-1] if names else ""
    parent = names[-2] if len(names) >= 2 else ""
    best = None
    for hint, name, spec in _RULES:
        if name != leaf:
            continue
        if hint is not None and hint != parent:
            continue
        if len(spec) != len(shape):
            continue
        if hint is not None:
            return spec  # exact parent match wins immediately
        best = best or spec
    return best


def _resolve(spec_letters, mesh) -> PSpec:
    names = mesh_spec(mesh).axis_names
    axes = []
    for s in spec_letters:
        logical = _LOGICAL[s]
        if logical is None:
            axes.append(None)
        elif logical == "data":
            axes.append("data" if "data" in names else None)
        else:
            axes.append("model" if "model" in names else None)
    return PSpec(*axes)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def _shape(leaf) -> tuple:
    if isinstance(leaf, (int, float, bool)):
        return ()
    return tuple(int(s) for s in leaf.shape)


def _names(dotted: str) -> list:
    """A dotted parameter name as the reference's path names."""
    return [f"[{p}]" if p.isdigit() else p for p in dotted.split(".")]


def _map_tree(fn, tree, path=()):
    """``fn(names, leaf)`` over a module's parameters (a ``{name: out}``
    dict) or a nested dict / list / tuple tree (the same structure)."""
    if isinstance(tree, torch.nn.Module):
        return {name: fn(_names(name), p) for name, p in tree.named_parameters()}
    if tree is None:  # an empty subtree, as in the reference's pytrees
        return None
    if isinstance(tree, Mapping):
        return {k: _map_tree(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, torch.Size):
        out = [_map_tree(fn, v, path + (f"[{i}]",)) for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):  # a NamedTuple
            return type(tree)(*out)
        return type(tree)(out)
    return fn(list(path), tree)


def _map_leaves(fn, tree):
    """``fn(leaf)`` over the leaves of a nested tree (as `_map_tree`)."""
    return _map_tree(lambda names, leaf: fn(leaf), tree)


def param_pspecs(params, mesh):
    """PartitionSpecs matching the params tree (see the module docstring)."""
    ms = mesh_spec(mesh)

    def per_leaf(names, leaf):
        shape = _shape(leaf)
        if len(shape) <= 0:
            return PSpec()
        m = _match(names, shape)
        if m is not None:
            return guard_pspec(shape, _resolve(m, ms), ms)
        # scan-stacked layer weights: (num_layers, *param_shape) — match the
        # tail and keep the stack dim unsharded.
        if len(shape) >= 2:
            m = _match(names, shape[1:])
            if m is not None:
                spec = _resolve(m, ms)
                return guard_pspec(shape, PSpec(None, *spec), ms)
        # norms / scalars / unknown: replicate
        return PSpec(*([None] * len(shape)))

    return _map_tree(per_leaf, params)


def serving_param_pspecs(params, mesh):
    """TP-only parameter sharding for serving.

    Training uses FSDP("data") x TP("model"): every matmul all-gathers its
    weight shards, amortized over the step's compute. At decode a step is
    2*N*B FLOPs, so gathering the whole weight matrix per layer per token
    dominates. Serving therefore shards weights over "model" only and
    replicates them over "data": no weight moves per step, and the only
    collectives left are the small activation reductions of TP.
    """
    ms = mesh_spec(mesh)
    base = param_pspecs(params, ms)
    shapes = _map_tree(lambda names, leaf: _shape(leaf), params)

    def strip_data(spec, shape):
        entries = [
            None if ax == "data" or (isinstance(ax, tuple) and "data" in ax) else ax
            for ax in spec
        ]
        return guard_pspec(shape, PSpec(*entries), ms)

    return _zip_map(strip_data, base, shapes)


def _zip_map(fn, a, b):
    """``fn`` over two trees of the same structure whose leaves are a
    `PSpec` and a shape tuple."""
    if isinstance(a, PSpec):
        return fn(a, b)
    if a is None:
        return None
    if isinstance(a, Mapping):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    out = [_zip_map(fn, x, y) for x, y in zip(a, b)]
    return type(a)(*out) if hasattr(a, "_fields") else type(a)(out)


def batch_pspec(mesh, batch_size: int, ndim: int = 2) -> PSpec:
    """Batch sharded over ("pod","data") when divisible, else replicated."""
    ms = mesh_spec(mesh)
    axes = data_axes(ms)
    if not axes or batch_size % _axis_size(ms, axes) != 0:
        # try "data" alone (pod replicated)
        if "data" in ms.axis_names and batch_size % ms.shape["data"] == 0:
            axes = ("data",)
        else:
            axes = ()
    lead = axes if len(axes) > 1 else (axes[0] if axes else None)
    return PSpec(lead, *([None] * (ndim - 1)))


def cache_pspecs(cache, mesh, batch_size: int, *, seq_shard: bool = False):
    """KV caches: batch over data axes; head or sequence dim over model.

    seq_shard=False (baseline): the kv-head dim over "model" where
    divisible; GQA archs with Hkv < |model| cannot shard it.

    seq_shard=True (flash-decoding): the SEQUENCE dim over "model": the
    q.K and p.V contractions partition over the cache length, leaving
    only softmax-stat and output partial all-reduces. Works for every Hkv.
    """
    ms = mesh_spec(mesh)
    lead = batch_pspec(ms, batch_size, 1)[0]

    def per_leaf(leaf):
        shape = _shape(leaf)
        if len(shape) == 0:
            return PSpec()
        if len(shape) == 4:  # (B, S, Hkv, hd)
            if seq_shard:
                spec = PSpec(lead, "model", None, None)
            else:
                spec = PSpec(lead, None, "model", None)
        elif len(shape) >= 2:
            spec = PSpec(lead, *([None] * (len(shape) - 1)))
        else:
            spec = PSpec(None)
        return guard_pspec(shape, spec, ms)

    return _map_leaves(per_leaf, cache)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's spec and this rank's block of it: one slice a dim."""

    spec: PSpec
    index: tuple

    @property
    def split(self) -> tuple:
        """The dims the spec splits."""
        return tuple(i for i, ax in enumerate(self.spec) if ax is not None)


def _coordinate(mesh, coord) -> dict:
    if coord is not None:
        return dict(coord)
    if getattr(mesh, "mesh_dim_names", None) is None:
        raise ValueError("a mesh description needs this rank's coordinate (coord=)")
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _block_index(shape, spec: PSpec, ms: MeshSpec, coord: dict) -> tuple:
    from repro_torch.core.distributed import _split_slice

    index = []
    for n, axes in zip(shape, spec):
        if axes is None:
            index.append(slice(0, n))
            continue
        parts, part = 1, 0
        for ax in (axes if isinstance(axes, tuple) else (axes,)):
            parts, part = parts * ms.shape[ax], part * ms.shape[ax] + coord[ax]
        index.append(_split_slice(n, parts, part))
    return tuple(index)


def param_shardings(params, mesh, *, pspecs=None, coord=None):
    """Each leaf's `Sharding` on this rank: its spec (``pspecs``, by
    default `param_pspecs`) and its block. ``mesh`` is a `DeviceMesh`
    (this rank's coordinate read from it) or a description with
    ``coord`` ``{axis: index}``."""
    ms = mesh_spec(mesh)
    where = _coordinate(mesh, coord)
    specs = param_pspecs(params, ms) if pspecs is None else pspecs
    shapes = _map_tree(lambda names, leaf: _shape(leaf), params)
    return _zip_map(lambda spec, shape: Sharding(spec, _block_index(shape, spec, ms, where)),
                    specs, shapes)


def _trailing(index: tuple, t) -> tuple:
    """``index`` for ``t``: a leaf with fewer dims than its index is one
    layer of a stacked leaf (``scan_layers``), whose block is the
    trailing dims' (the stack dim is never split)."""
    return index[len(index) - t.ndim:]


def shard_leaf(t, sharding: Sharding):
    """This rank's block of the whole leaf ``t`` (or of one layer of a
    stacked leaf), a copy (the whole can be freed at once)."""
    return t[_trailing(sharding.index, t)].clone()


@dataclasses.dataclass
class ShardPlan:
    """How a rank-local model computes (set by `shard_model`).

    ``axes`` is its `MeshAxes` (the model group issues the TP reductions,
    the data groups sum the MoE expert counts and aux terms); ``tp`` the model group,
    rank and size the layers take; ``specs`` every parameter's spec.
    ``attn`` is "heads" (local q/k/v heads and a head-sharded cache:
    Hkv divides by |model| and no flash-decoding), "q_heads" (Hkv does
    not divide, no flash-decoding: the rank's own q heads,
    `transformer.rank_heads`' contiguous range, which need not be even,
    k and v assembled whole after their column products and cut to the
    kv heads those q heads read, which its cache holds), "whole"
    (``decode_seq_shard``, or some attention leaves whole: q, k and v
    assembled whole, every head attended; the cache's sequence split
    over "model" under ``decode_seq_shard``, else whole) or "replicated"
    (no attention leaf split). ``mlp``: the MLPs are
    ff-split. ``vocab`` and ``logits`` are this rank's (lo, hi) rows of
    the embedding table and columns of the logits, None where whole.
    ``layout`` holds the recurrent families' blocks: "lru" ("channels"
    or "replicated") for the RG-LRU; "mlstm" and "slstm" ("heads",
    or "replicated") and "slstm_ffn" ("ff" or "replicated") for
    xLSTM (the models' docstrings say what each computes; "heads" runs
    the rank's `transformer.rank_heads`, an even share or not).

    Under the training layout (``shard_model(serving=False)``, every
    family) ``specs`` are `param_pspecs`' and the layouts above are
    those of its "model" entries (the serving layout's); ``fsdp`` maps
    each leaf split over "data" to (the dim it splits, the dim's whole
    size) and ``data`` is the "data" group, rank and size those leaves
    are gathered over.
    ``shapes`` holds every leaf's whole shape.
    """

    mesh: object
    axes: object
    tp: object
    specs: dict
    attn: str
    mlp: bool
    vocab: Optional[tuple]
    logits: Optional[tuple]
    layout: dict = dataclasses.field(default_factory=dict)
    fsdp: dict = dataclasses.field(default_factory=dict)
    data: object = None
    shapes: dict = dataclasses.field(default_factory=dict)
    # id of each FSDP-split parameter -> (dim, whole size), set by `bind`
    _by_id: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def model_size(self) -> int:
        return self.tp.size if self.tp is not None else 1

    def block(self, name: str) -> tuple:
        """This rank's index (one slice a dim) into leaf ``name``'s whole."""
        coord = dict(zip(self.mesh.mesh_dim_names, self.mesh.get_coordinate()))
        return _block_index(self.shapes[name], self.specs[name], mesh_spec(self.mesh), coord)

    def bind(self, model) -> None:
        """Find ``fsdp``'s leaves among ``model``'s parameters."""
        self._by_id = {id(p): self.fsdp[name] for name, p in model.named_parameters()
                       if name in self.fsdp}

    def whole(self, t: torch.Tensor, stack: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``t`` as the model reads it: a leaf split over "data" gathered
        whole over the data group (one all-reduce of a zero-filled buffer;
        under autograd its backward sums the whole gradient over the
        group and keeps this rank's block, the reduce-scatter that also
        sums the data replicas' gradients), any other tensor as it is.
        ``t`` may be one layer's view of ``stack``, a stacked leaf
        (``scan_layers``): that layer alone is gathered, along the split
        dim less the stack's, as the unrolled model gathers its layer's
        leaf."""
        info = self._by_id.get(id(t if stack is None else stack))
        if info is None:
            return t
        from repro_torch.models.layers import gather_block

        dim, size = info
        return gather_block(t, size, dim if stack is None else dim - 1, self.data)


def _split_range(sharding: Sharding, dim: int) -> Optional[tuple]:
    """This rank's (lo, hi) along ``dim`` where the spec splits it."""
    if dim not in sharding.split:
        return None
    s = sharding.index[dim]
    return (s.start, s.stop)


def _leaves(shardings: dict, part: str, names) -> list:
    """The names of the leaves ``names`` under a ``part`` group."""
    return [n for n in shardings if f".{part}." in f".{n}" and n.split(".")[-1] in names]


def _split_all(shardings: dict, leaves: list, what: str) -> bool:
    """Whether ``leaves`` are split over "model": all or none of them."""
    split = [n for n in leaves if shardings[n].split]
    if split and len(split) != len(leaves):
        bad = sorted(set(leaves) - set(split))[0]
        raise ValueError(f"{bad} is whole while other {what} leaves are split over 'model'")
    return bool(split)


def _attn_layout(shardings: dict, num_kv_heads: int, m: int, *, seq_shard: bool = False,
                 parts=("attn", "self_attn", "cross_attn")) -> str:
    """The plan's ``attn`` (see `ShardPlan`) for the attention leaves'
    blocks on a model axis of ``m``."""
    leaves = [n for part in parts for n in _leaves(shardings, part, ("wq", "wk", "wv", "wo"))]
    split = [n for n in leaves if shardings[n].split]
    if not split:
        return "replicated"
    if seq_shard or len(split) != len(leaves):
        return "whole"
    return "heads" if num_kv_heads % m == 0 else "q_heads"


def _plan(cfg, mesh, axes, shardings: dict) -> ShardPlan:
    from repro_torch.models.layers import TP

    m = axes.model_size
    tp = TP(axes.model_group, axes.model_rank, m) if axes.model_group is not None else None
    specs = {name: s.spec for name, s in shardings.items()}
    attn, mlp, layout = "replicated", False, {}
    if cfg.family in ("dense", "moe", "vlm", "hybrid", "audio"):
        attn = _attn_layout(shardings, cfg.num_kv_heads, m, seq_shard=cfg.decode_seq_shard)
        mlp = _split_all(shardings, _leaves(shardings, "mlp", ("w_gate", "w_up", "w_down")),
                         "MLP")
    if cfg.family in ("dense", "moe", "vlm"):
        for n in _leaves(shardings, "moe", ("w_gate", "w_up", "w_down")):
            if m > 1 and not shardings[n].split:
                raise ValueError(f"{n}: its ff dim does not split over 'model' ({m} ranks)")
    elif m == 1:  # one model rank: a "model" entry splits nothing
        if cfg.family == "hybrid":
            layout["lru"] = "replicated"
        elif cfg.family == "ssm":
            layout.update(mlstm="replicated", slstm="replicated", slstm_ffn="replicated")
    elif cfg.family == "hybrid":
        lru = _leaves(shardings, "rglru", ("w_in", "w_gate_branch", "conv_w", "conv_b", "w_a",
                                           "w_x", "b_a", "b_x", "lam", "w_out"))
        layout["lru"] = "channels" if _split_all(shardings, lru, "RG-LRU") else "replicated"
    elif cfg.family == "ssm":
        mq = _leaves(shardings, "mlstm", ("conv_w", "conv_b", "wq", "wk", "wv", "w_down"))
        layout["mlstm"] = "heads" if _split_all(shardings, mq, "mLSTM") else "replicated"
        # r_gates splits over its heads where they divide, else every rank
        # holds it whole and reads its own heads' slice
        layout["slstm"] = "heads"
        ffn = _leaves(shardings, "slstm", ("w_ff_gate", "w_ff_up", "w_ff_down"))
        layout["slstm_ffn"] = "ff" if _split_all(shardings, ffn, "sLSTM FFN") else "replicated"
    vocab = _split_range(shardings["embed.table"], 0)
    logits = _split_range(shardings["lm_head.w"], 1) if "lm_head.w" in shardings else vocab
    return ShardPlan(mesh=mesh, axes=axes, tp=tp, specs=specs, attn=attn, mlp=mlp,
                     vocab=vocab, logits=logits, layout=layout)


def shard_model(cfg, mesh, *, serving: bool = True, generator=None, params=None):
    """The rank-local model for ``cfg`` on ``mesh`` (a `DeviceMesh`; every
    rank calls it): each rank holds only its blocks of each parameter,
    on the mesh's device, and a `ShardPlan` in ``model.tp``. Serving
    (the default) places any family (`model_zoo.FAMILIES`) under
    `serving_param_pspecs`; ``serving=False`` places it under
    `param_pspecs`, the FSDP × TP training layout (each leaf's
    d_model-like dim split over "data" as well, where it divides), which
    `repro_torch.train.make_train_step` trains. Either way the plan's
    layouts follow the "model" entries of the specs, which the two
    layouts share.

    With ``generator`` (a `torch.Generator` on that device, the same seed
    on every rank), each leaf is drawn whole in the reference's order,
    this rank's block kept and the rest freed at once, so the sharded
    model holds exactly the values `model_zoo.get_model` draws from that
    seed and no rank ever holds the whole model (a ``scan_layers`` stack
    is placed a layer at a time: each layer's leaf keeps the block of the
    stack's trailing dims, the stack dim whole). With ``params``, the
    reference's parameter tree with numpy leaves (as
    `convert.lm_params_from_numpy` takes it), each block is sliced on the
    host. Batches are split over the data axes by the caller
    (`batch_pspec`); each data replica runs its own rows.
    """
    from repro_torch.core.distributed import mesh_axes, mesh_device
    from repro_torch.models import model_zoo

    family = model_zoo.FAMILIES.get(cfg.family)
    if family is None:
        raise ValueError(f"unknown family {cfg.family!r}")
    device = mesh_device(mesh)
    axes = mesh_axes(mesh, data_axes(mesh), "model")
    skeleton = model_zoo.build(cfg, torch.device("meta"))
    # the model-axis blocks, which set the plan's layouts on either path
    layout = param_shardings(skeleton, mesh, pspecs=serving_param_pspecs(skeleton, mesh))
    shardings = layout if serving else param_shardings(skeleton, mesh)
    shapes = {name: tuple(p.shape) for name, p in skeleton.named_parameters()}
    del skeleton
    if params is not None:
        model = load_blocks(family, cfg, device, params, lambda name: shardings[name].index)
    else:
        model = family(cfg, device=device, generator=generator,
                       place=lambda name, t: shard_leaf(t, shardings[name]))
    plan = _plan(cfg, mesh, axes, layout)
    plan.shapes = shapes
    if not serving:
        _fsdp_plan(plan, mesh, shardings)
        plan.bind(model)
    model.tp = plan
    return model


def _fsdp_plan(plan: ShardPlan, mesh, shardings: dict) -> None:
    """The training layout's additions to ``plan`` (see `ShardPlan`)."""
    from repro_torch.models.layers import TP

    ms = mesh_spec(mesh)
    plan.specs = {name: s.spec for name, s in shardings.items()}
    size = ms.shape.get("data", 1)
    if size == 1:
        return
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    plan.data = TP(mesh.get_group("data"), coord["data"], size)
    for name, s in shardings.items():
        dims = [i for i, ax in enumerate(s.spec) if ax == "data"]
        if dims:
            plan.fsdp[name] = (dims[0], plan.shapes[name][dims[0]])


def load_blocks(family, cfg, device, params, block):
    """``family``'s model for ``cfg`` on ``device`` holding this rank's
    blocks of ``params`` (the reference's tree with numpy leaves, as
    `convert.lm_params_from_numpy` takes it), sliced on the host:
    ``block(name)`` is the index (one slice a dim) of the rank's block of
    that leaf, or None for a leaf the rank does not hold (an empty
    tensor). Every leaf must match a parameter by name, and each block
    its shape and dtype."""
    from repro_torch.convert import _flatten, _tensor

    leaves = _flatten(params)

    def place(name, t):
        index = block(name)
        return t.new_empty(0) if index is None else t.new_empty(t[_trailing(index, t)].shape)

    model = family(cfg, device=torch.device("meta"), place=place)
    names = {name for name, _ in model.named_parameters()}
    if set(leaves) != names:
        raise ValueError(
            f"parameter trees differ: missing {sorted(names - set(leaves))}, "
            f"unexpected {sorted(set(leaves) - names)}")
    model = model.to_empty(device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            index = block(name)
            if index is None:
                continue
            whole = np.asarray(leaves[name])
            got = _tensor(whole[index])
            if got.shape != p.shape or got.dtype != p.dtype:
                raise ValueError(f"{name}: got {tuple(whole.shape)} {got.dtype}, the model "
                                 f"holds a block {tuple(p.shape)} {p.dtype}")
            p.copy_(got)
    return model
