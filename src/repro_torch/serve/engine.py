"""Batched serving engine: continuous prefill + decode over a request queue.

Port of `repro.serve.engine`. A deliberately compact production shape:
fixed decode batch of `slots`, each slot holding one active request.
Incoming prompts are prefilled (left-padded with token 0 to the longest
in the batch, the pad neither masked nor skipped by the positions, as
in the reference) and decoded together; every decode tick advances all
live slots by one token; finished slots (EOS or max_tokens) are
released, and the next batch is taken from the queue.

The model owns its weights, so the engine takes no ``params``. Decoding
is always greedy: it takes the first index of the largest logit, as
``argmax`` does in both frameworks (`Model.greedy_pick`, which a
rank-local model reduces over its vocab shards, so the engine serves a
tensor-parallel model unchanged). ``greedy`` and ``seed`` are accepted
and ignored, as in the reference, which samples nowhere.

A request may carry its modality-frontend stub inputs in ``extras``
(whisper's ``encoder_frames``, one (S_enc, D) array a request; the
reference's engine passes none, so there the frames are zeros): the
engine stacks a batch's in slot order, casts them to the model's dtype
on its device and passes them to `prefill`. Every request of a batch
carries the same keys.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models.model_zoo import Model

__all__ = ["Request", "ServeEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 32
    eos_id: int = -1  # -1 = never
    extras: Optional[dict] = None  # per-request stub inputs, e.g. {"encoder_frames": (S_enc, D)}
    # filled by the engine:
    output: Optional[list] = None
    done: bool = False


class ServeEngine:
    def __init__(
        self,
        model: Model,
        *,
        slots: int = 8,
        max_len: int = 512,
        greedy: bool = True,
        seed: int = 0,
    ):
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.greedy = greedy  # accepted and ignored (see the module docstring)
        self.queue: List[Request] = []
        self.active: List[Optional[Request]] = [None] * slots
        self.metrics = {"prefills": 0, "decode_ticks": 0, "tokens_out": 0}

    def submit(self, req: Request):
        req.output = []
        self.queue.append(req)

    # -- single-sequence serving path (one cache per slot batch) ----------
    def run(self, budget_ticks: int = 10_000) -> List[Request]:
        """Drain the queue: batch prompts of equal length, prefill, decode."""
        device = self.model.device
        done: List[Request] = []
        while self.queue and budget_ticks > 0:
            batch = self.queue[: self.slots]
            self.queue = self.queue[self.slots :]
            # bucket-pad prompts to the longest in batch
            plen = max(len(r.prompt) for r in batch)
            toks = np.zeros((len(batch), plen), np.int32)
            for i, r in enumerate(batch):
                toks[i, plen - len(r.prompt) :] = r.prompt  # left-pad
            logits, cache = self.model.prefill(torch.from_numpy(toks).to(device), self.max_len,
                                               **self._extras(batch))
            self.metrics["prefills"] += 1
            last = self.model.greedy_pick(logits[:, -1])
            live = np.ones(len(batch), bool)
            # the prefill's last logits produce the FIRST new token
            for i, r in enumerate(batch):
                r.output.append(int(last[i]))
                self.metrics["tokens_out"] += 1
                if len(r.output) >= r.max_new_tokens or last[i] == r.eos_id:
                    live[i] = False
                    r.done = True
            steps = max(r.max_new_tokens for r in batch) - 1
            for _ in range(steps):
                if budget_ticks <= 0 or not live.any():
                    break
                logits_t, cache = self.model.decode_step(cache, torch.from_numpy(last).to(device))
                self.metrics["decode_ticks"] += 1
                budget_ticks -= 1
                nxt = self.model.greedy_pick(logits_t)
                for i, r in enumerate(batch):
                    if not live[i]:
                        continue
                    r.output.append(int(nxt[i]))
                    self.metrics["tokens_out"] += 1
                    if len(r.output) >= r.max_new_tokens or nxt[i] == r.eos_id:
                        live[i] = False
                        r.done = True
                last = nxt
            for r in batch:
                r.done = True
                done.append(r)
        return done

    def _extras(self, batch: List[Request]) -> dict:
        """The batch's stub inputs, stacked in slot order (see the module
        docstring)."""
        keys = {frozenset(r.extras or ()) for r in batch}
        if len(keys) != 1:
            raise ValueError("the requests of a batch carry different extras")
        out = {}
        for key in sorted(keys.pop()):
            rows = [torch.as_tensor(r.extras[key]) for r in batch]
            out[key] = torch.stack(rows).to(device=self.model.device, dtype=self.model.dtype)
        return out
