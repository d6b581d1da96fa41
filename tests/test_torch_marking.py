"""The port's one-launch window marking against the reference's marking.

`ops.mark_blocks(indices, valid, read_mask, bitmap, active_words)` gives
a round's final marks, ``valid & ~read_mask[indices] & AnyActive(row_i)``,
where row_i is ``bitmap[indices[i]]`` (the whole table, ``by_id``) or
``bitmap[i]`` (a gathered window); with no bitmap it is the scan
policy's ``valid & ~read_mask[indices]``. On the CPU it runs its plain
version, which these tests hold bitwise against the reference's
expression (`repro/core/multiquery.py`, ``fused_round``):

    marks = mark_window(wd.bitmap, state.union_words, policy=policy)
    marks = marks & wd.valid & ~cursor.read_mask[wd.indices]

computed in JAX through the reference's plain AnyActive and through the
Pallas kernel in interpret mode. Inputs are made with numpy from a seed.
The kernel itself runs only on a GPU (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import multiquery as jmq
from repro.data.layout import block_layout
from repro.data.synth import SynthSpec, make_dataset
from repro.kernels import ref as jref
from repro.kernels.anyactive import anyactive_pallas
from repro_torch import convert
from repro_torch.core import multiquery as tmq
from repro_torch.core.policies import mark_window
from repro_torch.io import InMemorySource
from repro_torch.kernels import anyactive as tanyactive
from repro_torch.kernels import ops

WORDS = [1, 3, 236, 237]
ROWS = [1, 64, 512]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _window(rng, rows, words, *, mask="random"):
    """A bitmap table, the window's ids into it, its validity, a read
    mask and an active mask (uint32 numpy). About 10 % of the rows are
    padding (valid False, id 0), a quarter of the table is already read,
    half the table's rows miss the random mask, and row 0 of the window
    holds only candidate 32 * (words - 1) + 31, the int32 sign bit."""
    num_blocks = max(2 * rows, 8)
    table = rng.integers(0, 2**32, size=(num_blocks, words), dtype=np.uint32)
    active = {
        "random": rng.integers(0, 2**32, size=(words,), dtype=np.uint32),
        "empty": np.zeros((words,), np.uint32),
        "full": np.full((words,), 0xFFFFFFFF, np.uint32),
    }[mask]
    table[rng.random(num_blocks) < 0.5] &= ~active
    ids = rng.permutation(num_blocks)[:rows].astype(np.int64)
    valid = rng.random(rows) >= 0.1
    ids[~valid] = 0
    read_mask = rng.random(num_blocks) < 0.25
    valid[0] = True
    read_mask[ids[0]] = False
    table[ids[0]] = 0
    table[ids[0], words - 1] = np.uint32(1 << 31)
    if mask == "random":
        active[words - 1] |= np.uint32(1 << 31)
    return table, ids, valid, read_mask, active


def _reference(table, ids, valid, read_mask, active, *, pallas=False):
    """The reference's marking on its gathered window."""
    rows = jnp.asarray(table)[jnp.asarray(ids)]
    if pallas:
        marks = anyactive_pallas(rows, jnp.asarray(active), interpret=True)
    else:
        marks = jref.anyactive_ref(rows, jnp.asarray(active))
    marks = marks & jnp.asarray(valid) & ~jnp.asarray(read_mask)[jnp.asarray(ids)]
    return np.asarray(marks)


def _i32(a):
    return _t(a.view(np.int32))


def _port(table, ids, valid, read_mask, active, *, form):
    if form == "table":
        bitmap, by_id = _i32(table), True
    else:
        bitmap, by_id = _i32(table[ids]), False
    return ops.mark_blocks(
        _t(ids), _t(valid), _t(read_mask), bitmap, _i32(active), by_id=by_id
    ).numpy()


class TestMarkBlocks:
    @pytest.mark.parametrize("rows", ROWS)
    @pytest.mark.parametrize("words", WORDS)
    @pytest.mark.parametrize("form", ["table", "window"])
    def test_matches_reference(self, form, words, rows):
        args = _window(np.random.default_rng(words * 1000 + rows), rows, words)
        got = _port(*args, form=form)
        want = _reference(*args)
        np.testing.assert_array_equal(got, want)
        assert got[0]  # the bit-31 row

    @pytest.mark.parametrize("rows", ROWS)
    @pytest.mark.parametrize("words", WORDS)
    def test_matches_pallas_interpret(self, words, rows):
        args = _window(np.random.default_rng(words * 7 + rows), rows, words)
        want = _reference(*args, pallas=True)
        for form in ("table", "window"):
            np.testing.assert_array_equal(_port(*args, form=form), want, err_msg=form)

    @pytest.mark.parametrize("mask", ["empty", "full"])
    def test_empty_and_full_masks(self, mask):
        table, ids, valid, read_mask, active = _window(
            np.random.default_rng(5), 512, 236, mask=mask
        )
        got = _port(table, ids, valid, read_mask, active, form="table")
        np.testing.assert_array_equal(got, _reference(table, ids, valid, read_mask, active))
        if mask == "empty":
            assert not got.any()
        else:  # every valid unread row that holds a candidate
            want = valid & ~read_mask[ids] & table[ids].any(axis=1)
            np.testing.assert_array_equal(got, want)

    def test_padding_and_read_rows_are_never_marked(self):
        table, ids, valid, read_mask, active = _window(
            np.random.default_rng(6), 512, 236, mask="full"
        )
        got = _port(table, ids, valid, read_mask, active, form="table")
        assert (~valid).any() and read_mask[ids].any()
        assert not got[~valid].any() and not got[read_mask[ids]].any()

    @pytest.mark.parametrize("rows", ROWS)
    def test_scan_form(self, rows):
        """No bitmap and no active words: the reference's exact-completion
        marks, ``wd.valid & ~cursor.read_mask[wd.indices]``."""
        _, ids, valid, read_mask, _ = _window(np.random.default_rng(rows), rows, 3)
        got = ops.mark_blocks(_t(ids), _t(valid), _t(read_mask)).numpy()
        want = np.asarray(
            jnp.asarray(valid) & ~jnp.asarray(read_mask)[jnp.asarray(ids)]
        )
        np.testing.assert_array_equal(got, want)

    def test_bitmap_needs_active_words(self):
        _, ids, valid, read_mask, _ = _window(np.random.default_rng(8), 4, 1)
        with pytest.raises(ValueError, match="both bitmap and active_words"):
            table = torch.zeros((8, 1), dtype=torch.int32)
            ops.mark_blocks(_t(ids), _t(valid), _t(read_mask), table)

    def test_cpu_tensors_launch_nothing(self):
        launches = ops.KERNELS["anyactive"].launches
        _port(*_window(np.random.default_rng(9), 64, 3), form="table")
        assert ops.KERNELS["anyactive"].launches == launches

    def test_kernel_wrapper_refuses_cpu_tensors(self):
        """The kernel wrapper never runs the plain version in its place."""
        _, ids, valid, read_mask, _ = _window(np.random.default_rng(10), 4, 1)
        with pytest.raises(ValueError, match="CUDA tensor"):
            tanyactive.mark_blocks(_t(ids), _t(valid), _t(read_mask))


# ---------------------------------------------------------------------------
# the two forms of WindowData, and the rounds built on the marking
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_dataset():
    spec = SynthSpec(v_z=300, v_x=6, num_tuples=100_000, k=4, n_close=4,
                     close_distance=0.02, far_distance=0.3, zipf_a=1.0, seed=5)
    ds = make_dataset(spec)
    blocked = block_layout(ds.z, ds.x, v_z=300, v_x=6, block_size=64, seed=5)
    ported = convert.dataset_from_numpy(
        blocked.z_blocks, blocked.x_blocks, blocked.bitmap, spec.v_z, spec.v_x
    )
    return ds, blocked, ported


def _leaves(named_tuple) -> dict:
    return {k: np.asarray(v) for k, v in jax.device_get(named_tuple)._asdict().items()}


def _assert_leaf(name, got: torch.Tensor, want: np.ndarray):
    g = got.cpu().numpy()
    if want.dtype == np.uint32:
        g = g.view(np.uint32)
    assert g.shape == want.shape, name
    if want.dtype == np.float32 and name not in ("counts", "n"):
        np.testing.assert_allclose(g, want, rtol=1e-5, atol=2e-5, err_msg=name)
    else:
        np.testing.assert_array_equal(g, want.astype(g.dtype), err_msg=name)


@pytest.fixture(scope="module")
def mid_run(small_dataset):
    """The reference scheduler after two windows of 32; a window of 64
    ids (the first 32 read already) padded to 80; and the scheduler's
    state with its union of active words set to the rarest candidates
    of the window, so that about half of its unread blocks hold one."""
    ds, blocked, _ = small_dataset
    jspec = jmq.MultiQuerySpec(v_z=300, v_x=6, max_queries=2, k_cap=4)
    sched = jmq.SharedCountsScheduler(blocked, jspec, window=32, seed=0, start_block=0)
    sched.admit(ds.target, k=4, eps=0.1, delta=0.05)
    sched.run_window(sched.order[:32])
    sched.run_window(sched.order[32:64])
    assert sched.blocks_read == 64
    win = sched.order[32:96]
    present = ((blocked.bitmap[win[32:], :, None] >> np.arange(32, dtype=np.uint32)) & 1)
    present = present.reshape(32, -1)[:, :300].astype(bool)  # (blocks, candidate)
    union = np.zeros(blocked.bitmap.shape[1], np.uint32)
    covered = np.zeros(32, bool)
    for c in np.argsort(present.sum(axis=0), kind="stable"):
        if present[:, c].any() and covered.sum() < 16:
            union[c // 32] |= np.uint32(1 << (c % 32))
            covered |= present[:, c]
    state = sched.state._replace(union_words=jnp.asarray(union))
    return jspec, sched, win, state


def _sources(ported):
    return {
        "table": InMemorySource(ported, device="cpu"),
        "window": InMemorySource(ported, device_resident=False, device="cpu"),
    }


def test_window_forms_give_equal_marks(small_dataset, mid_run):
    """The device-resident source hands over the table and the ids, the
    host-resident one gathered rows; both mark alike, as the reference."""
    _, _, ported = small_dataset
    _, sched, win, jstate = mid_run
    cursor = convert.cursor_from_numpy(_leaves(sched.cursor), device="cpu")
    union = _t(np.array(jstate.union_words).view(np.int32))
    wd_ref = sched.source.fetch(win, pad_to=80)
    want = np.asarray(
        jref.anyactive_ref(wd_ref.bitmap, jstate.union_words)
        & wd_ref.valid & ~sched.cursor.read_mask[wd_ref.indices]
    )
    wds = {form: src.fetch(win, pad_to=80) for form, src in _sources(ported).items()}
    assert wds["table"].bitmap_by_id and not wds["window"].bitmap_by_id
    assert wds["table"].bitmap.shape[0] == ported.num_blocks
    np.testing.assert_array_equal(
        wds["table"].bitmap_rows().numpy(), wds["window"].bitmap_rows().numpy()
    )
    for form, wd in wds.items():
        got = mark_window(wd, union, cursor.read_mask, policy="anyactive").numpy()
        np.testing.assert_array_equal(got, want, err_msg=form)
        scan = mark_window(wd, union, cursor.read_mask, policy="scan").numpy()
        np.testing.assert_array_equal(scan, (wd.valid & ~cursor.read_mask[wd.indices]).numpy())
    assert want[32:64].any() and not want[32:64].all() and not want[:32].any()


@pytest.mark.parametrize("form", ["table", "window"])
def test_ingest_round_matches_reference(small_dataset, mid_run, form):
    """`ingest_round` on a converted reference state, leaf by leaf."""
    _, _, ported = small_dataset
    jspec, sched, win, jstate = mid_run
    ref_state, ref_cursor = jmq.ingest_round(
        jstate, sched.cursor, sched.source.fetch(win, pad_to=80), spec=jspec,
        plans=sched.plans,
    )
    state = convert.multi_state_from_numpy(_leaves(jstate), device="cpu")
    cursor = convert.cursor_from_numpy(_leaves(sched.cursor), device="cpu")
    tspec = tmq.MultiQuerySpec(v_z=300, v_x=6, max_queries=2, k_cap=4)
    wd = _sources(ported)[form].fetch(win, pad_to=80)
    new_state, new_cursor = tmq.ingest_round(state, cursor, wd, spec=tspec)
    for name, want in _leaves(ref_state).items():
        if name in tmq.MultiQueryState._fields:
            _assert_leaf(name, getattr(new_state, name), want)
    for name, want in _leaves(ref_cursor).items():
        _assert_leaf(name, getattr(new_cursor, name), want)
    assert int(new_cursor.blocks_read) == 96  # every unread block of the window


@pytest.mark.parametrize("form", ["table", "window"])
def test_fused_round_matches_reference(small_dataset, mid_run, form):
    """`fused_round` on a converted reference state, leaf by leaf, from
    either form of the window."""
    _, _, ported = small_dataset
    jspec, sched, win, jstate = mid_run
    ref_state, ref_cursor = jmq.fused_round(
        jstate, sched.cursor, sched.source.fetch(win, pad_to=80), spec=jspec,
        policy="anyactive", plans=sched.plans,
    )
    state = convert.multi_state_from_numpy(_leaves(jstate), device="cpu")
    cursor = convert.cursor_from_numpy(_leaves(sched.cursor), device="cpu")
    tspec = tmq.MultiQuerySpec(v_z=300, v_x=6, max_queries=2, k_cap=4)
    wd = _sources(ported)[form].fetch(win, pad_to=80)
    new_state, new_cursor = tmq.fused_round(state, cursor, wd, spec=tspec, policy="anyactive")
    for name, want in _leaves(ref_state).items():
        if name in tmq.MultiQueryState._fields:
            _assert_leaf(name, getattr(new_state, name), want)
    for name, want in _leaves(ref_cursor).items():
        _assert_leaf(name, getattr(new_cursor, name), want)
    assert 64 < int(new_cursor.blocks_read) < 96  # some unread blocks were skipped
