"""``cfg.remat`` in the recurrent and audio families (RG-LRU hybrid,
xLSTM, whisper): each block of `forward` is checkpointed as the
transformer's is (`base.Model.remat`).

The reference checkpoints only the transformer's blocks and ignores
``cfg.remat`` in these three families (ROADMAP Queue C, C7), although
their full configs set ``remat="full"``: at full width whisper-medium's
encoder over 8 x 1,500 frames then keeps every block's attention
probabilities for the backward pass, which does not fit one 80 GB card.
Recomputation reruns the same operations on the same inputs, so the loss
and every gradient are the same bit for bit under "none", "full" and
"dots"; what changes is what autograd keeps, which these tests count.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models.model_zoo import get_model
from repro_torch.train.step import make_loss_fn

ARCHS = ("recurrentgemma_2b", "xlstm_125m", "whisper_medium")


def _batch(cfg, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24))
                                        .astype(np.int32))}
    if cfg.frontend == "audio_stub":
        batch["encoder_frames"] = torch.from_numpy(
            (rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)
        ).to(getattr(torch, cfg.dtype))
    return batch


def _grads_and_saved(arch: str, dtype: str, remat: str) -> tuple:
    """The loss, every parameter's gradient, and the bytes autograd saved
    for the backward pass, for one step of the smoke config."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype, remat=remat)
    model = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    for p in model.parameters():
        p.requires_grad_(True)
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = make_loss_fn(model)(_batch(cfg))[0]
    loss.backward()
    grads = [p.grad.clone() for p in model.parameters()]
    return loss.detach(), grads, sum(saved)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_grads_bitwise(arch, dtype):
    loss, grads, saved_none = _grads_and_saved(arch, dtype, "none")
    for remat in ("full", "dots"):
        got_loss, got, saved = _grads_and_saved(arch, dtype, remat)
        assert torch.equal(got_loss, loss), remat
        assert all(torch.equal(a, b) for a, b in zip(got, grads)), remat
        # a checkpointed forward keeps each block's inputs, not its inner
        # activations (the attention probabilities, the gates, the scan)
        assert saved < saved_none, (remat, saved, saved_none)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_rejects_unknown(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", remat="some")
    model = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="unknown remat"):
        model(_batch(cfg)["tokens"], **{k: v for k, v in _batch(cfg).items() if k != "tokens"})
