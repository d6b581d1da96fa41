"""The port's optimizers against the JAX reference (`repro.optimizer`).

The first classes port tests/test_optimizers.py to `repro_torch.optimizer`.
The twins feed both packages the same numpy-seeded parameter trees
(matrices, vectors and a 3-D leaf, nested in dicts and a list, as an LM's
tree is) and the same grads, step by step, the reference's ``update``
jitted as its train step runs it:

* AdamW, f32 and bf16, over 1, 2 and 10 steps: bitwise. XLA contracts
  ``a * b + c`` into one fused multiply-add and rewrites ``(a / b) / c``
  as ``a / (b * c)``; the port writes both the same way, so every update,
  moment and parameter has the reference's bits. (The bias corrections'
  ``b1 ** step`` agree at these steps; XLA's vectorised ``pow`` differs
  from PyTorch's by an ulp at some others, so bitwise is a property of
  the steps held here, not of every step.)
* Adafactor, f32 and bf16, over 1, 2 and 10 steps: within stated ulps.
  Its means, ``rms_u`` and ``scale`` reduce in another order than XLA's
  CPU reductions, and XLA's ``rsqrt`` is up to 2 ulps from PyTorch's, so
  bits cannot match (bars at each test).
* The in-place form (`Optimizer.update_`) against the functional form on
  the same inputs: bitwise, both optimizers, both dtypes.
* Clipping above and below the threshold, int8 compression with error
  feedback and the bf16 cast.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optimizer import adafactor as jadafactor
from repro.optimizer import adamw as jadamw
from repro.optimizer.base import clip_by_global_norm as jclip
from repro.optimizer.compress import compress_gradients as jcompress
from repro_torch.optimizer import adafactor, adamw, get_optimizer
from repro_torch.optimizer.base import (
    clip_by_global_norm, clip_by_global_norm_, global_norm, tree_leaves, tree_map,
)
from repro_torch.optimizer.compress import (
    compress_gradients,
    dequantize_int8,
    init_error_feedback,
    quantize_int8,
)

SHAPES = {"w": (16, 24), "b": (24,), "t": (3, 8, 5)}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np_tree(rng, scale=1.0):
    """An LM-like tree: top-level leaves and a list of two layers."""
    leaf = lambda s: (rng.normal(size=s) * scale).astype(np.float32)  # noqa: E731
    return {"embed": {"table": leaf((12, 8))}, "b": leaf(SHAPES["b"]),
            "layers": [{k: leaf(s) for k, s in SHAPES.items()} for _ in range(2)]}


def _to_torch(tree, dtype):
    return tree_map(lambda a: torch.from_numpy(a).to(dtype), tree)


def _to_jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), tree)


def _bits(t) -> np.ndarray:
    """A leaf's bits as int64: f32 as int32 words, bf16 as int16."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().astype(np.int64)
        return t.numpy().view(np.int32).astype(np.int64)
    a = np.asarray(t)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16).astype(np.int64)
    return a.view(np.int32).astype(np.int64)


def _ulps(got, want) -> int:
    return max(int(np.abs(_bits(g) - _bits(w)).max())
               for g, w in zip(tree_leaves(got), jax.tree.leaves(want)))


def _run_both(jopt, topt, dtype: str, steps: int, seed: int):
    """Both packages' params, state and last updates after ``steps`` steps
    of the same grads; the reference's update jitted."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    p0 = _np_tree(rng)
    grads = [_np_tree(rng, 0.1) for _ in range(steps)]
    jp, tp = _to_jax(p0, jdt), _to_torch(p0, tdt)
    js, ts = jopt.init(jp), topt.init(tp)
    jupdate = jax.jit(jopt.update)
    for i in range(steps):
        ju, js = jupdate(_to_jax(grads[i], jdt), js, jp, jnp.asarray(i, jnp.int32))
        jp = jax.tree.map(lambda a, u: a + u.astype(a.dtype), jp, ju)
        tu, ts = topt.update(_to_torch(grads[i], tdt), ts, tp, torch.tensor(i))
        tp = tree_map(lambda a, u: a + u.to(a.dtype), tp, tu)
    return (tp, ts, tu), (jp, js, ju)


# ---------------------------------------------------------------------------
# tests/test_optimizers.py, on the port
# ---------------------------------------------------------------------------


class TestAdamW:
    def test_first_step_matches_reference(self):
        opt = adamw(1e-2, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)
        p = {"w": torch.tensor([[1.0, 2.0]])}
        g = {"w": torch.tensor([[0.1, -0.2]])}
        st = opt.init(p)
        up, st = opt.update(g, st, p, torch.tensor(0))
        # after bias correction the first update is -lr * sign-ish g / (|g| + eps)
        expect = -1e-2 * np.asarray([[0.1, -0.2]]) / (np.abs([[0.1, -0.2]]) + 1e-8)
        np.testing.assert_allclose(up["w"].numpy(), expect, rtol=1e-4)

    def test_weight_decay_applies_to_matrices_only(self):
        opt = adamw(1e-2, weight_decay=0.5)
        p = {"w": torch.ones((2, 2)), "b": torch.ones((2,))}
        g = {"w": torch.zeros((2, 2)), "b": torch.zeros((2,))}
        up, _ = opt.update(g, opt.init(p), p, torch.tensor(0))
        assert float(up["w"].abs().sum()) > 0  # decay pulls weights
        assert float(up["b"].abs().sum()) == 0  # biases not decayed

    def test_converges_quadratic(self):
        opt = adamw(0.1, weight_decay=0.0)
        p = {"w": torch.tensor([5.0, -3.0])}
        st = opt.init(p)
        for i in range(200):
            g = {"w": 2 * p["w"]}  # grad of ||w||^2
            up, st = opt.update(g, st, p, torch.tensor(i))
            p = {"w": p["w"] + up["w"]}
        assert float(p["w"].abs().max()) < 1e-2


class TestAdafactor:
    def test_factored_state_memory(self):
        opt = adafactor(1e-2)
        p = {"w": torch.zeros((128, 256)), "b": torch.zeros((256,))}
        st = opt.init(p)
        assert st["w"]["row"].shape == (128,)
        assert st["w"]["col"].shape == (256,)
        assert st["b"]["nu"].shape == (256,)
        assert sum(x.numel() for x in tree_leaves(st)) < 128 * 256

    def test_converges_quadratic(self):
        opt = adafactor(0.3)
        p = {"w": torch.full((4, 4), 5.0)}
        st = opt.init(p)
        for i in range(300):
            up, st = opt.update({"w": 2 * p["w"]}, st, p, torch.tensor(i))
            p = {"w": p["w"] + up["w"]}
        assert float(p["w"].abs().max()) < 0.3


class TestClipping:
    def test_clip_by_global_norm(self):
        clipped, norm = clip_by_global_norm({"a": torch.tensor([3.0, 4.0])}, 1.0)  # norm 5
        assert float(norm) == pytest.approx(5.0)
        assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)

    def test_no_clip_below_threshold(self):
        clipped, _ = clip_by_global_norm({"a": torch.tensor([0.3, 0.4])}, 1.0)
        np.testing.assert_allclose(clipped["a"].numpy(), [0.3, 0.4], rtol=1e-6)


class TestCompression:
    def test_int8_roundtrip_error_bounded(self, rng):
        x = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))
        q, scale = quantize_int8(x)
        assert q.dtype == torch.int8
        assert float((dequantize_int8(q, scale) - x).abs().max()) <= float(scale) / 2 + 1e-6

    def test_error_feedback_preserves_sum(self, rng):
        """With EF, accumulated quantized gradients track the true sum."""
        g_true = [rng.normal(size=(32,)).astype(np.float32) * 0.1 for _ in range(50)]
        ef = init_error_feedback({"w": torch.zeros((32,))})
        acc = np.zeros(32, np.float32)
        for g in g_true:
            cg, ef = compress_gradients({"w": torch.from_numpy(g)}, scheme="int8",
                                        error_feedback=ef)
            acc += cg["w"].numpy()
        np.testing.assert_allclose(acc, np.sum(g_true, axis=0), atol=0.02)

    def test_bf16_halves_bytes(self):
        cg, _ = compress_gradients({"w": torch.zeros((16, 16))}, scheme="bf16")
        assert cg["w"].dtype == torch.bfloat16


def test_get_optimizer():
    p = {"w": torch.zeros((4, 6))}
    assert set(get_optimizer("adamw", 1e-3).init(p)) == {"mu", "nu"}
    assert set(get_optimizer("adafactor", 1e-3).init(p)["w"]) == {"row", "col"}
    with pytest.raises(ValueError, match="unknown optimizer"):
        get_optimizer("sgd", 1e-3)


# ---------------------------------------------------------------------------
# twins: the same trees and grads through both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("steps", [1, 2, 10])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_adamw_twin_bitwise(dtype, steps):
    """Updates, both moments and the parameters after ``steps`` steps:
    bitwise the jitted reference's (see the module docstring)."""
    (tp, ts, tu), (jp, js, ju) = _run_both(jadamw(1e-2), adamw(1e-2), dtype, steps, seed=steps)
    assert _ulps(tu, ju) == 0
    assert _ulps(ts["mu"], js["mu"]) == 0 and _ulps(ts["nu"], js["nu"]) == 0
    assert _ulps(tp, jp) == 0


@pytest.mark.parametrize("steps", [1, 2, 10])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_adafactor_twin_within_ulps(dtype, steps):
    """Adafactor (weight decay on, so its fused decay term runs too).

    Bars. The factored statistics are means (another summation order than
    XLA's): the row and column moments within 8 ulps. The update is
    ``-lr * scale * g * rsqrt(v) / max(1, rms_u)``: rsqrt up to 2 ulps
    apart, ``scale`` and ``rms_u`` means over the whole leaf, so each
    update within 1e-6 of its leaf's largest update (measured: 2.1e-7).
    Parameters accumulate the updates: within 1e-6 of the largest |p| in
    f32; in bf16, within one bf16 ulp of the largest |p| (an update that
    lands a hair either side of a rounding boundary)."""
    kw = dict(weight_decay=0.01)
    (tp, ts, tu), (jp, js, ju) = _run_both(jadafactor(1e-2, **kw), adafactor(1e-2, **kw),
                                           dtype, steps, seed=100 + steps)
    for g, w in zip(tree_leaves(tu), jax.tree.leaves(ju)):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max() + (
            0 if dtype == "float32" else 2.0 ** -8 * np.abs(w).max()), (dtype, steps)
    assert _ulps(ts, js) <= 8
    p_max = max(float(np.abs(np.asarray(w, np.float32)).max()) for w in jax.tree.leaves(jp))
    bar = 1e-6 * p_max if dtype == "float32" else 2.0 ** -7 * p_max
    for g, w in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert np.abs(g.float().numpy() - np.asarray(w, np.float32)).max() <= bar


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_in_place_update_equals_functional(name, dtype):
    """`update_` writes what `update` returns (params += updates, state
    replaced), bit for bit, over three steps."""
    tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(7)
    opt = get_optimizer(name, 1e-2)
    p_fun = _to_torch(_np_tree(rng), tdt)
    p_in = tree_map(torch.clone, p_fun)
    s_fun, s_in = opt.init(p_fun), opt.init(p_in)
    for i in range(3):
        g = _to_torch(_np_tree(rng, 0.1), tdt)
        up, s_fun = opt.update(g, s_fun, p_fun, torch.tensor(i))
        p_fun = tree_map(lambda a, u: a + u.to(a.dtype), p_fun, up)
        opt.update_(g, s_in, p_in, torch.tensor(i))
    for a, b in zip(tree_leaves((p_fun, s_fun)), tree_leaves((p_in, s_in))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_twin(max_norm):
    """Above and below the threshold. The norm sums squares in another
    order than XLA: within 1e-6 relative; the clipped grads are the same
    product of the same scale, so within the same bar."""
    rng = np.random.default_rng(3)
    g = _np_tree(rng)
    tc, tn = clip_by_global_norm(_to_torch(g, torch.float32), max_norm)
    jc, jn = jclip(_to_jax(g, jnp.float32), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    inplace = _to_torch(g, torch.float32)
    assert float(clip_by_global_norm_(inplace, max_norm)) == float(tn)
    for a, b in zip(tree_leaves(inplace), tree_leaves(tc)):
        assert torch.equal(a, b)
    if max_norm > float(tn):
        for a, b in zip(tree_leaves(tc), tree_leaves(_to_torch(g, torch.float32))):
            assert torch.equal(a, b)


@pytest.mark.parametrize("scheme", ["int8", "bf16", "none"])
def test_compression_twin_bitwise(scheme):
    """Five steps of compression with error feedback, the reference run
    op by op as its tests run it: compressed grads and residuals
    bitwise (int8 rounds half to even in both; the scale is the same max
    divided by the same 127)."""
    rng = np.random.default_rng(11)
    t_ef = j_ef = None
    for _ in range(5):
        g = _np_tree(rng, 0.1)
        g["layers"][0]["b"][:4] = [0.5, -0.5, 1.5, 2.5]  # ties for the rounding
        tg, t_ef = compress_gradients(_to_torch(g, torch.float32), scheme=scheme,
                                      error_feedback=t_ef)
        jg, j_ef = jcompress(_to_jax(g, jnp.float32), scheme=scheme, error_feedback=j_ef)
        assert _ulps(tg, jg) == 0
        if scheme == "int8":
            assert _ulps(t_ef, j_ef) == 0
    with pytest.raises(ValueError, match="unknown scheme"):
        compress_gradients({"w": torch.zeros(2)}, scheme="fp4")


def test_quantize_rounds_half_to_even():
    q, scale = quantize_int8(torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5]))
    assert float(scale) == 1.0
    assert q.tolist() == [127, 0, 2, 2, 0, -2]
