"""Batched LM serving on the PyTorch / CUDA port: prefill + decode over a
request queue.

The port's twin of examples/serve_batch.py, with its inputs and its
lines. Serves a reduced qwen2.5-family model (the smoke config) with the
`ServeEngine`, its weights drawn from a `torch.Generator` seeded 0 on
the device. Runs on the GPU unless ``--device cpu`` is given:

  PYTHONPATH=src python examples/torch_serve_batch.py [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.models.model_zoo import get_model
from repro_torch.serve import Request, ServeEngine

ARCH = "qwen2_5_3b"


def run(cfg=None, device=None, *, n_requests: int = 24, max_new_tokens: int = 16,
        slots: int = 8, max_len: int = 128) -> dict:
    """The example on ``device`` (the GPU unless "cpu") for the model
    config ``cfg`` (qwen2.5-3b's smoke config when None): the served
    requests in completion order, the engine's metrics, its wall, the
    engine (its model, slots and max_len) and the lines it prints
    (``lines``)."""
    device = resolve_device(device)
    cfg = get_smoke_config(ARCH) if cfg is None else cfg
    model = get_model(cfg, device=device,
                      generator=torch.Generator(device=device).manual_seed(0))

    eng = ServeEngine(model, slots=slots, max_len=max_len)
    rng = np.random.default_rng(0)
    for i in range(n_requests):
        eng.submit(
            Request(
                rid=i,
                prompt=rng.integers(0, cfg.vocab_size,
                                    size=int(rng.integers(4, 32))).astype(np.int32),
                max_new_tokens=max_new_tokens,
            )
        )
    t0 = time.time()
    done = eng.run()
    dt = time.time() - t0
    m = eng.metrics
    lines = [f"served {len(done)} requests in {dt:.2f}s",
             f"prefills={m['prefills']} decode_ticks={m['decode_ticks']} "
             f"tokens_out={m['tokens_out']} ({m['tokens_out'] / dt:.1f} tok/s)"]
    for r in done[:3]:
        lines.append(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.output}")
    return dict(done=done, metrics=dict(m), wall_s=dt, engine=eng, lines=lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    print("\n".join(run(None, args.device)["lines"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
