"""End-to-end training on the PyTorch / CUDA port: a ~100M-param LM
trained with FastMatch distribution-matched data selection in the input
pipeline.

The port's twin of examples/train_lm_fastmatch.py, with its flags and
its lines. Uses the xlstm-125m architecture at full width (12 layers,
d_model 768) with a reduced vocabulary; the data pipeline first runs the
paper's engine to pick the corpus domains whose token distribution
matches a reference mix (kernels A, B and C on the GPU), then streams
batches only from those domains into `repro_torch.launch.train.
train_loop`, whose weights are drawn from a `torch.Generator` seeded 0
on the device. Runs on the GPU unless ``--device cpu`` is given:

  PYTHONPATH=src python examples/torch_train_lm_fastmatch.py --steps 200 [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.data.corpus import CorpusSpec, make_corpus
from repro_torch.launch.train import train_loop


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """The example's inputs: its flags."""

    steps: int = 200
    batch: int = 8
    seq: int = 256
    vocab: int = 2048
    ckpt_dir: str = "/tmp/repro_ckpt"


def run(spec: TrainSpec = TrainSpec(), device=None) -> dict:
    """The example on ``device`` (the GPU unless "cpu"): `train_loop`'s
    output and the lines it prints (``lines``, the loop's log among
    them)."""
    device = resolve_device(device)
    lines = []
    # xlstm-125m at full depth/width; vocab reduced for the demo
    cfg = dataclasses.replace(get_config("xlstm_125m"), vocab_size=spec.vocab)
    lines.append(f"arch=xlstm_125m layers={cfg.num_layers} d_model={cfg.d_model} "
                 f"~{cfg.param_count / 1e6:.0f}M params (vocab reduced to {spec.vocab})")

    corpus = make_corpus(
        CorpusSpec(
            num_domains=64, num_buckets=128, vocab_size=spec.vocab,
            num_blocks=2048, block_tokens=2048, n_reference=8,
            reference_alpha=0.15, seed=0,
        )
    )
    out = train_loop(
        cfg=cfg,
        steps=spec.steps,
        batch_size=spec.batch,
        seq_len=spec.seq,
        lr=3e-4,
        ckpt_dir=spec.ckpt_dir,
        ckpt_every=100,
        corpus=corpus,
        select_k=8,
        log_fn=lines.append,
        device=device,
    )
    lines.append(f"\nfinal loss {out['final_loss']:.4f} after {spec.steps} steps")
    lines.append(f"checkpoints in {spec.ckpt_dir} (auto-resume on rerun)")
    return dict(out, lines=lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--ckpt-dir", type=str, default="/tmp/repro_ckpt")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    spec = TrainSpec(steps=args.steps, batch=args.batch, seq=args.seq, vocab=args.vocab,
                     ckpt_dir=args.ckpt_dir)
    print("\n".join(run(spec, args.device)["lines"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
