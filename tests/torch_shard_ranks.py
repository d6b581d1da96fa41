"""The port's side of the sharded-LM twins, in gloo ranks
(`distributed.run_ranks`): a spawned rank imports this module, which
loads neither JAX nor the reference, so the ranks start fast. Not a
test file; tests/test_torch_tp.py and tests/test_torch_moe_local.py
hold what these return against the reference."""

import dataclasses

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import distributed

B, CTX, PREFILL, STEPS = 4, 32, 16, 4
# the reference test's widened llama3-405b smoke (tests/test_serving_sharded.py)
WIDEN = dict(d_model=128, num_heads=8, num_kv_heads=2, d_ff=256)

# (case, mesh shape, dtype, decode_seq_shard)
DECODE_CASES = (
    ("heads_bf16", (2, 2), "bfloat16", False),
    ("heads_f32", (2, 2), "float32", False),
    ("seq_bf16", (1, 4), "bfloat16", True),
    ("seq_f32", (1, 4), "float32", True),
)


def llama_cfg(dtype: str, **kw):
    return dataclasses.replace(get_smoke_config("llama3_405b"), dtype=dtype, **WIDEN, **kw)


def tp_rank(rank, world, trees, toks, prompts, qwen_toks, qwen_serve):
    from repro_torch.distributed import batch_pspec, shard_model
    from repro_torch.models import layers as L
    from repro_torch.serve import Request, ServeEngine

    out = {}
    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = distributed.init_mesh(shape, device_type="cpu")
        return meshes[shape]

    def place(mesh):
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        assert batch_pspec(mesh, B)[0] == "data"
        return coord["data"], mesh.mesh.shape[0]

    for case, shape, dtype, seq in DECODE_CASES:
        mesh = mesh_of(shape)
        cfg = llama_cfg(dtype, decode_seq_shard=seq)
        model = shard_model(cfg, mesh, params=trees[dtype])
        d, nd = place(mesh)
        rows = slice(d * B // nd, (d + 1) * B // nd)
        t = torch.from_numpy(toks[rows])
        logits, cache = model.prefill(t[:, :PREFILL], CTX)
        steps = [logits[:, -1]]
        for i in range(PREFILL, PREFILL + STEPS):
            step, cache = model.decode_step(cache, t[:, i])
            steps.append(step)
        out[case] = dict(attn=model.tp.attn, cols=model.tp.logits, rows=(rows.start, rows.stop),
                         seq=cache.seq, cache_shape=tuple(cache.k[0].shape),
                         logits=[s.float().numpy() for s in steps],
                         pick=model.greedy_pick(steps[-1]),
                         params=sum(p.numel() for p in model.parameters()))

    # ServeEngine on 2 x 2 in f32: each data replica serves its half
    mesh = mesh_of((2, 2))
    cfg = llama_cfg("float32")
    model = shard_model(cfg, mesh, params=trees["float32"])
    d, nd = place(mesh)
    engine = ServeEngine(model, slots=2, max_len=16)
    half = len(prompts) // nd
    for i in range(d * half, (d + 1) * half):
        engine.submit(Request(rid=i, prompt=prompts[i], max_new_tokens=4))
    done = engine.run()
    out["engine"] = dict(outputs={r.rid: r.output for r in done}, metrics=engine.metrics)

    # the dense qwen smoke under bf16 TP reductions
    cfg = dataclasses.replace(get_smoke_config("qwen2_5_3b"), dtype="bfloat16")
    model = shard_model(cfg, mesh, params=trees["qwen"])
    rows = slice(d * 2 // nd, (d + 1) * 2 // nd)
    try:
        L.set_tp_reduce_dtype(torch.bfloat16)
        logits, _ = model.forward(torch.from_numpy(qwen_toks[rows]))
    finally:
        L.set_tp_reduce_dtype(None)
    out["tp_reduce_bf16"] = dict(attn=model.tp.attn, cols=model.tp.logits,
                                 rows=(rows.start, rows.stop), logits=logits.float().numpy())

    # the qwen smoke in float32 on 1 x 4: its 4 q heads split 4 ways and
    # its 2 kv heads do not ("q_heads"), every row on every rank
    cfg = dataclasses.replace(get_smoke_config("qwen2_5_3b"), dtype="float32")
    model = shard_model(cfg, mesh_of((1, 4)), params=trees["qwen_f32"])
    t = torch.from_numpy(qwen_serve)
    logits, cache = model.prefill(t[:, :PREFILL], CTX)
    steps = [logits[:, -1]]
    for i in range(PREFILL, PREFILL + STEPS):
        step, cache = model.decode_step(cache, t[:, i])
        steps.append(step)
    out["q_heads"] = dict(attn=model.tp.attn, cols=model.tp.logits, seq=cache.seq,
                          cache_shape=tuple(cache.k[0].shape),
                          logits=[s.numpy() for s in steps])
    return out


def moe_rank(rank, world, tree, toks, x, layer, tree32, prompts):
    """The mixtral smoke on a 2 x 2 mesh: `forward` with ``moe_impl="local"``
    on this data shard's rows (dropless), and `moe_ffn_local` alone on the
    layer's experts (this rank's ff block) and the shard's activations at
    a capacity that drops, with f32 and with bf16 TP reductions. Then
    ``moe_impl="gather"`` in float32 at capacity factor `GATHER_CF`, where
    pairs drop (``tree32``, the reference's float32 weights): `forward` on
    the shard's rows (the global batch's slotting), and `ServeEngine`
    serving the data replica's half of ``prompts`` (`GATHER_NEW` tokens
    each: a prefill and the rest decode ticks, at the dropless capacity)."""
    from repro_torch.convert import _tensor
    from repro_torch.distributed import shard_model
    from repro_torch.distributed.sharding import param_shardings, serving_param_pspecs
    from repro_torch.models import layers as L
    from repro_torch.models.moe import moe_ffn_local

    mesh = distributed.init_mesh((2, 2), device_type="cpu")
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    d = coord["data"]
    cfg = dataclasses.replace(get_smoke_config("mixtral_8x7b"), moe_impl="local")
    model = shard_model(cfg, mesh, params=tree)
    rows = slice(d * toks.shape[0] // 2, (d + 1) * toks.shape[0] // 2)
    logits, aux = model.forward(torch.from_numpy(toks[rows]))
    out = dict(rows=(rows.start, rows.stop), cols=model.tp.logits, logits=logits.float().numpy(),
               aux={k: float(v) for k, v in aux.items()}, attn=model.tp.attn,
               w_gate=tuple(model.layers[0].moe["w_gate"].shape))
    moe = {k: _tensor(v) for k, v in tree["layers"][layer]["moe"].items()}
    specs = serving_param_pspecs({"moe": moe}, mesh)
    blocks = param_shardings({"moe": moe}, mesh, pspecs=specs)["moe"]
    local = {k: moe[k][blocks[k].index].clone() for k in moe}
    xs = torch.from_numpy(x[rows]).to(torch.bfloat16)
    for name, reduce in (("drop_f32", None), ("drop_bf16", torch.bfloat16)):
        try:
            L.set_tp_reduce_dtype(reduce)
            y, aux = moe_ffn_local(local, xs, num_experts=cfg.num_experts,
                                   top_k=cfg.experts_per_token, capacity_factor=1.0, mesh=mesh)
        finally:
            L.set_tp_reduce_dtype(None)
        out[name] = dict(y=y.float().numpy(), aux={k: float(v) for k, v in aux.items()})
    gcfg = dataclasses.replace(get_smoke_config("mixtral_8x7b"), moe_impl="gather",
                               expert_capacity_factor=GATHER_CF, dtype="float32")
    model = shard_model(gcfg, mesh, params=tree32)
    with torch.no_grad():
        logits, aux = model.forward(torch.from_numpy(toks[rows]))
    out["gather"] = dict(logits=logits.numpy(), aux={k: float(v) for k, v in aux.items()})
    from repro_torch.serve import Request, ServeEngine

    engine = ServeEngine(model, slots=2, max_len=16)
    half = len(prompts) // 2
    for i in range(d * half, (d + 1) * half):
        engine.submit(Request(rid=i, prompt=prompts[i], max_new_tokens=GATHER_NEW))
    done = engine.run()
    out["gather_engine"] = dict(outputs={r.rid: r.output for r in done}, metrics=engine.metrics)
    out["buffers"] = _moe_buffers(mesh, gcfg, tree32["layers"][layer]["moe"], x[rows])
    return out


# the MoE serving twin's "gather" case (tests/test_torch_moe_local.py)
GATHER_CF, GATHER_NEW = 0.5, 5


def _moe_buffers(mesh, cfg, moe, x) -> dict:
    """`moe_ffn_mesh` with the global slotting on one layer's experts
    (this rank's ff block, float32) and the data shard's activations
    ``x``, at `GATHER_CF` (pairs drop) and at the dropless capacity, its
    expert products once on the rank's pairs sorted by expert ("pairs")
    and once in the batched (E, min(C, T)) buffer ("batched"), by
    `moe.BATCHED_EXTRA_ROWS` set each way: the output, the aux terms, the
    FLOPs the forward counted (`FlopCounterMode`) and the gradients of
    ``sum(y * y) + load_balance_loss`` on the activations and on every
    leaf the rank holds."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core.distributed import mesh_axes
    from repro_torch.distributed.sharding import data_axes, param_shardings, serving_param_pspecs
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M

    whole = {k: torch.from_numpy(v) for k, v in moe.items()}
    blocks = param_shardings({"moe": whole}, mesh,
                             pspecs=serving_param_pspecs({"moe": whole}, mesh))["moe"]
    axes = mesh_axes(mesh, data_axes(mesh), "model")
    tp = L.TP(axes.model_group, axes.model_rank, axes.model_size)
    out, keep = {}, M.BATCHED_EXTRA_ROWS
    for cf in (GATHER_CF, float(cfg.num_experts)):
        for buffer, extra in (("pairs", float("-inf")), ("batched", float("inf"))):
            params = {k: whole[k][blocks[k].index].clone().requires_grad_() for k in whole}
            xs = torch.from_numpy(x).requires_grad_()
            M.BATCHED_EXTRA_ROWS = extra
            try:
                with FlopCounterMode(display=False) as counted:
                    y, aux = M.moe_ffn_mesh(params, xs, num_experts=cfg.num_experts,
                                            top_k=cfg.experts_per_token, capacity_factor=cf,
                                            axes=axes, tp=tp)
            finally:
                M.BATCHED_EXTRA_ROWS = keep
            (torch.sum(y * y) + aux["load_balance_loss"]).backward()
            out[(cf, buffer)] = dict(
                y=y.detach().numpy(), aux={k: float(v) for k, v in aux.items()},
                flops=counted.get_total_flops(), ff=params["w_gate"].shape[-1],
                grads={"x": xs.grad.numpy(), **{k: p.grad.numpy() for k, p in params.items()}})
    return out


def pipeline_rank(rank, world, stages, x, toks, tree, cot):
    """GPipe over "pod" (4 stages): the reference test's tanh stack, each
    stage holding its block of the stacked params; then a float32 qwen
    smoke of 4 layers as 4 stages (`stage_model`). Then the gradients of
    one loss, ``sum(y * cot[k])`` on the pipeline's output, on every
    leaf a stage holds and on the input: the tanh stack's, and the qwen
    smoke's on the reference's weights ``tree`` (each stage's layer and
    the embedding table)."""
    from repro_torch.distributed.pipeline import (
        make_pipeline_forward, stack_stage_params, stage_model, transformer_stage_fn,
    )
    from repro_torch.models.transformer import embed_tokens

    from repro_torch.launch import mesh as launch_mesh

    mesh = launch_mesh.make_mesh_for((4, 1, 1), ("pod", "data", "model"), device_type="cpu")
    refused = []
    for multi_pod in (False, True):
        try:
            launch_mesh.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        except RuntimeError as e:
            refused.append(str(e))
    stacked = stack_stage_params([{k: torch.from_numpy(v) for k, v in s.items()} for s in stages])
    pod = distributed.DimSplit(("pod",))
    local = {k: distributed.place_leaf(v, pod, mesh) for k, v in stacked.items()}

    def layer_fn(lp, h):
        return torch.tanh(h @ lp["w"] + lp["b"])

    fwd = make_pipeline_forward(transformer_stage_fn(layer_fn, 2), mesh, n_stages=4,
                                n_microbatches=4)
    out = dict(tanh=fwd(local, torch.from_numpy(x)).numpy(), stage_rows=tuple(local["w"].shape),
               refused=refused)

    cfg = dataclasses.replace(get_smoke_config("qwen2_5_3b"), dtype="float32", num_layers=4)
    model, layers = stage_model(cfg, mesh, n_stages=4, generator=torch.Generator().manual_seed(0))
    t = torch.from_numpy(toks)
    positions = torch.arange(t.shape[1], dtype=torch.int32).expand(t.shape[0] // 4, t.shape[1])

    def block(lp, h):
        return model._block(lp, h, positions, cfg.expert_capacity_factor)[0]

    fwd = make_pipeline_forward(transformer_stage_fn(block, 1), mesh, n_stages=4,
                                n_microbatches=4)
    with torch.no_grad():
        out["hidden"] = fwd([layers], embed_tokens(model, t)).numpy()
    out["held"] = sum(p.numel() for p in model.parameters())

    # the backward: the tanh stack's leaves and input
    local = {k: v.clone().requires_grad_() for k, v in local.items()}
    xt = torch.from_numpy(x).requires_grad_()
    fwd = make_pipeline_forward(transformer_stage_fn(layer_fn, 2), mesh, n_stages=4,
                                n_microbatches=4)
    (fwd(local, xt) * torch.from_numpy(cot["tanh"])).sum().backward()
    out["grad_tanh"] = dict(w=local["w"].grad[0].numpy(), b=local["b"].grad[0].numpy(),
                            x=xt.grad.numpy())
    # the qwen smoke's stages on the reference's weights: a stage's layer, the table
    model, layers = stage_model(cfg, mesh, n_stages=4, params=tree)
    for p in [model.embed["table"], *layers[0].parameters()]:
        p.requires_grad_()

    def block_any(lp, h):
        pos = torch.arange(h.shape[1], dtype=torch.int32).expand(h.shape[0], h.shape[1])
        return model._block(lp, h, pos, cfg.expert_capacity_factor)[0]

    fwd = make_pipeline_forward(transformer_stage_fn(block_any, 1), mesh, n_stages=4,
                                n_microbatches=4)
    (fwd([layers], embed_tokens(model, t)) * torch.from_numpy(cot["qwen"])).sum().backward()
    stage = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))["pod"]
    out["grad_qwen"] = {f"layers.{stage}.{n}": p.grad.numpy()
                        for n, p in layers[0].named_parameters()}
    out["grad_qwen"]["embed.table"] = model.embed["table"].grad.numpy()
    return out


def pipeline_data_rank(rank, world, stages, x, cot, toks, tree, cot_qwen):
    """The tanh stack's backward on a (4, 2, 1) mesh, as the reference's
    test shards it: each data replica runs its half of ``x`` (4 rows, 4
    microbatches of 1) through the 4 stages, takes ``sum(y * cot)`` on
    its rows, and its stage's gradients come out summed over "data".
    Then the float32 qwen smoke's stages tensor-parallel on a (4, 1, 2)
    mesh (`stage_model` on the reference's weights ``tree``: each rank
    holds its model block of its stage's layer and of the table), the
    backward of ``sum(y * cot_qwen)``: each block's gradient and its
    index into the whole leaf."""
    from repro_torch.distributed.pipeline import (
        make_pipeline_forward, stack_stage_params, stage_model, transformer_stage_fn,
    )
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models.transformer import embed_tokens

    mesh = launch_mesh.make_mesh_for((4, 2, 1), ("pod", "data", "model"), device_type="cpu")
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    stacked = stack_stage_params([{k: torch.from_numpy(v) for k, v in s.items()} for s in stages])
    pod = distributed.DimSplit(("pod",))
    local = {k: distributed.place_leaf(v, pod, mesh).clone().requires_grad_()
             for k, v in stacked.items()}
    rows = slice(4 * coord["data"], 4 * coord["data"] + 4)
    xt = torch.from_numpy(x[rows]).requires_grad_()

    def layer_fn(lp, h):
        return torch.tanh(h @ lp["w"] + lp["b"])

    fwd = make_pipeline_forward(transformer_stage_fn(layer_fn, 2), mesh, n_stages=4,
                                n_microbatches=4)
    (fwd(local, xt) * torch.from_numpy(cot[rows])).sum().backward()
    out = dict(coord=coord, w=local["w"].grad[0].numpy(), b=local["b"].grad[0].numpy(),
               x=xt.grad.numpy(), rows=(rows.start, rows.stop))

    tp_mesh = launch_mesh.make_mesh_for((4, 1, 2), ("pod", "data", "model"), device_type="cpu")
    cfg = dataclasses.replace(get_smoke_config("qwen2_5_3b"), dtype="float32", num_layers=4)
    tp_coord = dict(zip(tp_mesh.mesh_dim_names, tp_mesh.get_coordinate()))
    model, layers = stage_model(cfg, tp_mesh, n_stages=4, params=tree)
    held = {f"layers.{tp_coord['pod']}.{n}": p for n, p in layers[0].named_parameters()}
    held["embed.table"] = model.embed["table"]
    for p in held.values():
        p.requires_grad_()

    def block_any(lp, h):
        pos = torch.arange(h.shape[1], dtype=torch.int32).expand(h.shape[0], h.shape[1])
        return model._block(lp, h, pos, cfg.expert_capacity_factor)[0]

    fwd = make_pipeline_forward(transformer_stage_fn(block_any, 1), tp_mesh, n_stages=4,
                                n_microbatches=4)
    t = torch.from_numpy(toks)
    (fwd([layers], embed_tokens(model, t)) * torch.from_numpy(cot_qwen)).sum().backward()
    out["tp"] = dict(coord=tp_coord, attn=model.tp.attn,
                     grads={n: (p.grad.numpy(), [(sl.start, sl.stop) for sl in model.tp.block(n)])
                            for n, p in held.items()})
    return out


# the FSDP × TP training twins (tests/test_torch_fsdp.py): (arch, dtype[,
# variant]), each config's own optimizer (qwen2.5-3b AdamW, llama3-405b
# Adafactor); the "scan" variant stacks the layers (``scan_layers``)
FSDP_CASES = (("qwen2_5_3b", "float32"), ("qwen2_5_3b", "bfloat16"),
              ("llama3_405b", "float32"), ("llama3_405b", "bfloat16"),
              ("qwen2_5_3b", "float32", "scan"))
FSDP_LR = 1e-3
FSDP_REMATS = ("full", "dots")  # the first case's gradients again under each
# the first case again on a 1 x 4 mesh, in the (2, 2) spawn: qwen2.5-3b's 4
# q heads split 4 ways and its 2 kv heads do not ("q_heads")
FSDP_Q_HEADS = ((2, 2), (1, 4))
FSDP_VARIANTS = {"scan": dict(scan_layers=True)}


def fsdp_cfg(arch: str, dtype: str, variant=None):
    return dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                               **FSDP_VARIANTS.get(variant, {}))


def fsdp_rank(rank, world, shape, trees, toks):
    """Every `FSDP_CASES` case placed by `shard_model(serving=False)` on a
    ``shape`` ("data", "model") mesh from the reference's weights
    ``trees[case]``, on this data replica's rows of ``toks``:
    `_train_case`'s results a case, then the first case's gradients under
    each of `FSDP_REMATS`; in the spawn of `FSDP_Q_HEADS`' first shape,
    the first case on its second shape too (every row on every rank)."""
    from repro_torch.distributed import shard_model
    from repro_torch.optimizer import get_optimizer
    from repro_torch.optimizer.base import tree_leaves
    from repro_torch.train import TrainState
    from repro_torch.train.step import make_grad_fn

    torch.set_num_threads(1)  # 4 ranks share the host; smoke-sized products
    mesh = distributed.init_mesh(shape, device_type="cpu")
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    nd = shape[0]
    rows = slice(coord["data"] * toks.shape[0] // nd, (coord["data"] + 1) * toks.shape[0] // nd)
    batch = {"tokens": torch.from_numpy(toks[rows])}
    out = dict(coord=coord, rows=(rows.start, rows.stop))
    for case in FSDP_CASES:
        model = shard_model(fsdp_cfg(*case), mesh, serving=False, params=trees[case])
        out[case] = _train_case(model, batch)
    # activation checkpointing re-runs each block's gathers and sums in the
    # backward: the same gradients as without it
    case = FSDP_CASES[0]
    for remat in FSDP_REMATS:
        cfg = dataclasses.replace(fsdp_cfg(*case), remat=remat)
        model = shard_model(cfg, mesh, serving=False, params=trees[case])
        state = TrainState.create(model, get_optimizer(cfg.optimizer, FSDP_LR))
        grads = make_grad_fn(model)(state, batch)[3]
        by_id = {id(p): n for n, p in model.named_parameters()}
        out[("remat", remat)] = {by_id[id(p)]: g.float().numpy().copy()
                                 for p, g in zip(tree_leaves(state.params), tree_leaves(grads))}
    if shape == FSDP_Q_HEADS[0]:
        mesh = distributed.init_mesh(FSDP_Q_HEADS[1], device_type="cpu")
        model = shard_model(fsdp_cfg(*case), mesh, serving=False, params=trees[case])
        out[FSDP_Q_HEADS[1]] = _train_case(model, {"tokens": torch.from_numpy(toks)})
    return out


def _train_case(model, batch) -> dict:
    """A rank-local model's gradient (`make_grad_fn`) on ``batch``, then
    one `make_train_step` step: the metrics, each leaf's gradient block
    and post-step block with its index into the whole leaf, the optimizer
    state's leaf shapes by path, and the plan."""
    from repro_torch.optimizer import get_optimizer
    from repro_torch.optimizer.base import tree_leaves
    from repro_torch.train import TrainState, make_train_step
    from repro_torch.train.step import make_grad_fn

    opt = get_optimizer(model.cfg.optimizer, FSDP_LR)
    state = TrainState.create(model, opt)
    loss, ce, _, grads = make_grad_fn(model)(state, batch)
    by_id = {id(p): n for n, p in model.named_parameters()}
    grad_blocks = {by_id[id(p)]: g.detach().float().numpy().copy()
                   for p, g in zip(tree_leaves(state.params), tree_leaves(grads))}
    c0 = dict(distributed.COLLECTIVES)
    state, metrics = make_train_step(model, opt)(state, batch)
    collectives = {k: distributed.COLLECTIVES[k] - c0[k] for k in ("calls", "bytes")}
    params = dict(model.named_parameters())
    plan = model.tp
    return dict(
        loss=float(loss), ce=float(ce),
        metrics={k: float(v) for k, v in metrics.items()},
        index={n: [(sl.start, sl.stop) for sl in plan.block(n)] for n in params},
        grads=grad_blocks,
        params={n: p.detach().float().numpy() for n, p in params.items()},
        opt_shapes=_leaf_shapes(state.opt_state), collectives=collectives,
        fsdp=dict(plan.fsdp), attn=plan.attn, mlp=plan.mlp, layout=dict(plan.layout),
        logits=plan.logits, held=sum(p.numel() for p in model.parameters()))


def _leaf_shapes(tree, path=()) -> dict:
    """{dotted path: shape} of a nested dict / list tree of tensors."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _leaf_shapes(tree[key], path + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _leaf_shapes(sub, path + (str(i),)).items()}
    return {".".join(path): tuple(tree.shape)}


# the recurrent and audio families' twins (tests/test_torch_shard_families.py)
FAMILIES = ("recurrentgemma_2b", "xlstm_125m", "whisper_medium")
FAM_MESHES = ((2, 2), (1, 4))
FAM_B, FAM_FWD, FAM_PREFILL, FAM_STEPS, FAM_MAX_LEN = 4, 24, 8, 4, 16
# whisper-medium's 51,865-token vocabulary does not divide over "model"; the
# twin's smoke vocabulary is cut to a size that does not divide either
FAM_KW = {"whisper_medium": dict(vocab_size=521)}
# heads that split unevenly with every rank holding one (1 x 4 only): 6 q
# heads of recurrentgemma-2b's smoke config (2, 2, 1, 1), and 6 xLSTM heads
# at a width whose leaves all split 4 ways (d_inner 192: mLSTM heads of 32,
# sLSTM heads of 16); the smoke configs' own 2 heads give 1, 1, 0, 0
FAM_UNEVEN = {"recurrentgemma_2b_h6": ("recurrentgemma_2b", dict(num_heads=6)),
              "xlstm_125m_h6": ("xlstm_125m", dict(num_heads=6, d_model=96))}
FAM_LEAVES = {  # leaves whose blocks the twins check, by family
    "xlstm_125m": ("layers.0.mlstm.w_up", "layers.0.mlstm.wq", "layers.2.slstm.w_gates",
                   "layers.2.slstm.r_gates", "layers.2.slstm.w_ff_up"),
    "recurrentgemma_2b": ("layers.0.rglru.w_a", "layers.0.rglru.w_out", "layers.2.attn.wk"),
    "whisper_medium": ("embed.table", "dec_layers.0.cross_attn.wq", "dec_layers.0.mlp.b_up"),
}


def fam_arch(name: str) -> str:
    """The configuration a `FAMILIES` or `FAM_UNEVEN` name is a smoke config of."""
    return FAM_UNEVEN[name][0] if name in FAM_UNEVEN else name


def fam_kw(name: str) -> dict:
    """The fields ``name`` changes in its smoke config."""
    return FAM_UNEVEN[name][1] if name in FAM_UNEVEN else FAM_KW.get(name, {})


def family_cfg(arch: str, dtype: str):
    return dataclasses.replace(get_smoke_config(fam_arch(arch)), dtype=dtype, **fam_kw(arch))


def _family_case(model, toks, frames):
    """forward, prefill and FAM_STEPS decode steps on this data shard's
    rows; the logits as this rank's columns."""
    extra = {} if frames is None else {"encoder_frames": frames}
    with torch.no_grad():
        fwd, _ = model.forward(toks, **extra)
        logits, cache = model.prefill(toks[:, :FAM_PREFILL], FAM_MAX_LEN, **extra)
        steps = [logits[:, -1]]
        for i in range(FAM_PREFILL, FAM_PREFILL + FAM_STEPS):
            step, cache = model.decode_step(cache, toks[:, i])
            steps.append(step)
    return dict(forward=fwd.float().numpy(), prefill=logits.float().numpy(),
                steps=[s.float().numpy() for s in steps],
                picks=[model.greedy_pick(s) for s in steps])


def family_rank(rank, world, trees, toks, frames, prompts):
    """Every family of `FAMILIES` sharded from the reference's weights on
    each mesh of `FAM_MESHES`, in float32 and bfloat16: `_family_case` on
    this rank's data shard, the plan's layout, the blocks of
    `FAM_LEAVES`; then `ServeEngine` on the 2 x 2 mesh in float32, each
    data replica serving its half of the prompts (whisper's with their
    encoder frames)."""
    from repro_torch.distributed import shard_model
    from repro_torch.serve import Request, ServeEngine

    torch.set_num_threads(1)  # 4 ranks share the host; smoke-sized products
    out = {}
    for shape in FAM_MESHES:
        mesh = distributed.init_mesh(shape, device_type="cpu")
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        d, nd = coord["data"], shape[0]
        rows = slice(d * FAM_B // nd, (d + 1) * FAM_B // nd)
        for arch in FAMILIES + (tuple(FAM_UNEVEN) if shape == (1, 4) else ()):
            for dtype in ("float32", "bfloat16"):
                cfg = family_cfg(arch, dtype)
                model = shard_model(cfg, mesh, params=trees[arch][dtype])
                f = frames.get(arch)
                f = None if f is None else torch.from_numpy(f[rows]).to(model.dtype)
                res = _family_case(model, torch.from_numpy(toks[arch][rows]), f)
                params = dict(model.named_parameters())
                res.update(rows=(rows.start, rows.stop), cols=model.tp.logits, coord=coord,
                           attn=model.tp.attn, mlp=model.tp.mlp, layout=model.tp.layout,
                           vocab=model.tp.vocab,
                           blocks={n: params[n].detach().float().numpy()
                                   for n in FAM_LEAVES[fam_arch(arch)]},
                           held=sum(p.numel() for p in model.parameters()))
                out[(arch, shape, dtype)] = res
        if shape == (1, 4):  # a norm over a channel-split activation, both kinds
            from repro_torch.models import layers as L

            tp = L.TP(mesh.get_group("model"), coord["model"], 4)
            g = torch.Generator().manual_seed(4)
            x = torch.randn((2, 3, 64), generator=g) * 3 + 1
            params = {"scale": torch.randn(64, generator=g), "bias": torch.randn(64, generator=g)}
            block = slice(16 * coord["model"], 16 * (coord["model"] + 1))
            out["norm_split"] = {
                kind: float((L.norm_split(params, x[..., block], 1e-5, tp, kind=kind)
                             - whole(params, x, 1e-5)[..., block]).abs().max())
                for kind, whole in (("rms", L.rms_norm), ("layer", L.layer_norm))}
        if shape == (2, 2):
            for arch in FAMILIES:
                model = shard_model(family_cfg(arch, "float32"), mesh,
                                    params=trees[arch]["float32"])
                engine = ServeEngine(model, slots=2, max_len=FAM_MAX_LEN)
                half = len(prompts[arch]) // nd
                for i in range(d * half, (d + 1) * half):
                    f = frames.get(arch)
                    engine.submit(Request(rid=i, prompt=prompts[arch][i], max_new_tokens=4,
                                          extras=None if f is None
                                          else {"encoder_frames": f[i % FAM_B]}))
                done = engine.run()
                out[(arch, "engine")] = dict(outputs={r.rid: r.output for r in done},
                                             metrics=engine.metrics)
    return out


# the FSDP × TP training twins of every other family
# (tests/test_torch_fsdp_families.py): (arch, dtype, moe_impl[, variant]),
# each config's full config's optimizer (grok-1 and internvl2 Adafactor,
# the rest AdamW; the smoke configs all take AdamW); the MoE configs at
# capacity factor 0.5, where pairs drop (their smoke configs' 4.0 is
# dropless), and whisper's vocabulary cut to 521, which does not divide
# over "model" (as whisper-medium's 51,865 does not). The "ff" variant of
# xlstm-125m widens its sLSTM feed-forward to 96 columns, which split over
# "model" (the config's factor 1.3333 gives 85 here and 1023 at full
# width, which do not), so its "ff" layout is trained as well; the "scan"
# variant of mixtral-8x7b stacks its layers (``scan_layers``: (L, E, D, F)
# expert leaves)
FAMILY_TRAIN_CASES = (
    ("mixtral_8x7b", "float32", "gather"), ("mixtral_8x7b", "float32", "local"),
    ("mixtral_8x7b", "bfloat16", "gather"), ("grok_1_314b", "float32", "gather"),
    ("internvl2_76b", "float32", None), ("recurrentgemma_2b", "float32", None),
    ("recurrentgemma_2b", "bfloat16", None), ("xlstm_125m", "float32", None),
    ("xlstm_125m", "float32", None, "ff"), ("whisper_medium", "float32", None),
    ("mixtral_8x7b", "float32", "gather", "scan"),
)
FAMILY_TRAIN_CF = 0.5
FAMILY_TRAIN_KW = {"whisper_medium": dict(vocab_size=521),
                   "grok_1_314b": dict(optimizer="adafactor"),
                   "internvl2_76b": dict(optimizer="adafactor")}
FAMILY_TRAIN_VARIANTS = {"ff": dict(proj_factor_slstm=1.5), "scan": dict(scan_layers=True),
                         "seq_shard": dict(decode_seq_shard=True),
                         **{f"uneven_{arch}": kw for arch, kw in FAM_UNEVEN.values()}}
# heads split unevenly with every rank holding one, trained on 1 x 4 only
# (`FAM_UNEVEN`'s configs)
FAMILY_TRAIN_UNEVEN = tuple((arch, "float32", None, f"uneven_{arch}")
                            for arch, _ in FAM_UNEVEN.values())
# the "whole" attention layout trained, on 1 x 4 only: the dense qwen smoke
# under ``decode_seq_shard`` (its 2 kv heads do not divide over 4 ranks, so
# it would take "q_heads" without it)
FAMILY_TRAIN_WHOLE = (("qwen2_5_3b", "float32", None, "seq_shard"),)


def family_train_kw(arch: str, variant=None) -> dict:
    """The fields a case changes in ``arch``'s smoke config."""
    return {**FAMILY_TRAIN_KW.get(arch, {}), **FAMILY_TRAIN_VARIANTS.get(variant, {})}


def family_train_cfg(arch: str, dtype: str, moe_impl=None, variant=None):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                              **family_train_kw(arch, variant))
    if moe_impl is not None:
        cfg = dataclasses.replace(cfg, moe_impl=moe_impl, expert_capacity_factor=FAMILY_TRAIN_CF)
    return cfg


def family_train_rank(rank, world, shape, cases, trees, toks, extras):
    """Each of ``cases`` (`FAMILY_TRAIN_CASES`) placed by
    `shard_model(serving=False)` on a ``shape`` ("data", "model") mesh
    from the reference's weights ``trees[case]``, on this data replica's
    rows of ``toks`` and of the case's stub inputs ``extras[arch]``
    (vision embeddings, encoder frames): the gradient (`make_grad_fn`),
    then one `make_train_step` step. Returns `_train_case`'s results a
    case."""
    from repro_torch.distributed import shard_model

    torch.set_num_threads(1)  # 4 ranks share the host; smoke-sized products
    mesh = distributed.init_mesh(shape, device_type="cpu")
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    nd = shape[0]
    rows = slice(coord["data"] * toks.shape[0] // nd, (coord["data"] + 1) * toks.shape[0] // nd)
    out = dict(coord=coord, rows=(rows.start, rows.stop))
    for case in cases:
        model = shard_model(family_train_cfg(*case), mesh, serving=False, params=trees[case])
        batch = {"tokens": torch.from_numpy(toks[rows])}
        batch.update({k: torch.from_numpy(v[rows]).to(model.dtype)
                      for k, v in extras.get(case[0], {}).items()})
        out[case] = _train_case(model, batch)
    return out


# the dry run's recorder against real ranks (tests/test_torch_dryrun.py):
# (case, arch, fields of its smoke config) trained one step on 4 x 16 tokens,
# and one decode tick of the first after a prefill of DRY_PREFILL tokens
DRY_CASES = (("qwen_scan", "qwen2_5_3b", dict(scan_layers=True)),
             ("mixtral_scan", "mixtral_8x7b", dict(scan_layers=True, expert_capacity_factor=0.5)))
DRY_PREFILL, DRY_MAX_LEN = 8, 16


def dry_cfg(arch: str, **kw):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)


def dryrun_rank(rank, world, toks):
    """Each of `DRY_CASES` placed by `shard_model(serving=False)` (seed 0)
    on a 2 x 2 mesh: one `make_train_step` step on this data replica's
    rows of ``toks`` under `FlopCounterMode`, its all-reduce calls and
    bytes (`COLLECTIVES`) and FLOPs; then the first case's unrolled model
    prefilled with DRY_PREFILL tokens and the calls and bytes of one
    decode tick."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed import shard_model
    from repro_torch.optimizer import get_optimizer
    from repro_torch.train import TrainState, make_train_step

    torch.set_num_threads(1)  # 4 ranks share the host; smoke-sized products
    mesh = distributed.init_mesh((2, 2), device_type="cpu")
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    rows = slice(coord["data"] * toks.shape[0] // 2, (coord["data"] + 1) * toks.shape[0] // 2)
    batch = {"tokens": torch.from_numpy(toks[rows])}
    out = dict(coord=coord)

    def delta(c0):
        return {k: distributed.COLLECTIVES[k] - c0[k] for k in ("calls", "bytes")}

    for case, arch, kw in DRY_CASES:
        cfg = dry_cfg(arch, **kw)
        model = shard_model(cfg, mesh, serving=False, generator=torch.Generator().manual_seed(0))
        opt = get_optimizer(cfg.optimizer, FSDP_LR)
        state = TrainState.create(model, opt)
        c0 = dict(distributed.COLLECTIVES)
        with FlopCounterMode(display=False) as flops:
            make_train_step(model, opt)(state, batch)
        out[case] = dict(collectives=delta(c0), flops=flops.get_total_flops())
    cfg = dry_cfg(DRY_CASES[0][1])
    model = shard_model(cfg, mesh, serving=False, generator=torch.Generator().manual_seed(0))
    _, cache = model.prefill(batch["tokens"][:, :DRY_PREFILL], DRY_MAX_LEN)
    c0 = dict(distributed.COLLECTIVES)
    model.decode_step(cache, batch["tokens"][:, DRY_PREFILL])
    out["decode"] = dict(collectives=delta(c0))
    return out
