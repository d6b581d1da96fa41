"""End-to-end training launcher.

Port of `repro.launch.train`. Wires together: FastMatch distribution-
matched data selection (the paper's technique, phase 1; kernels A, B and
C on the card) -> TokenStream -> model -> optimizer -> the train loop
with checkpoint / auto-resume, NaN-step skipping and preemption handling
(SIGTERM saves and exits). Runs on the card unless ``device="cpu"``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --smoke \\
      --steps 200 --batch 8 --seq 256 [--device cpu]

The model's weights are drawn from a `torch.Generator` on the device
seeded with ``seed``. `train_loop` returns the reference's dict and the
model whose parameters the state holds (``"model"``).
"""

from __future__ import annotations

import argparse
import signal
import sys
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager, config_hash
from repro_torch.configs.base import ALIASES, get_config, get_smoke_config
from repro_torch.data.corpus import CorpusSpec, make_corpus
from repro_torch.data.pipeline import TokenStream, select_domains
from repro_torch.models.model_zoo import get_model
from repro_torch.optimizer import get_optimizer
from repro_torch.train import TrainState, make_train_step

__all__ = ["train_loop", "main"]


def train_loop(
    *,
    cfg,
    steps: int,
    batch_size: int,
    seq_len: int,
    lr: float = 3e-4,
    ckpt_dir: str = None,
    ckpt_every: int = 100,
    log_every: int = 10,
    corpus=None,
    select_k: int = 8,
    seed: int = 0,
    extra_batch_fn=None,
    log_fn=print,
    device=None,
) -> dict:
    device = resolve_device(device)
    model = get_model(cfg, device=device,
                      generator=torch.Generator(device=device).manual_seed(seed))
    optimizer = get_optimizer(cfg.optimizer, lr)

    # ---- phase 1: FastMatch distribution-matched data selection ----
    if corpus is None:
        corpus = make_corpus(
            CorpusSpec(vocab_size=cfg.vocab_size, num_blocks=512, block_tokens=2048, seed=seed)
        )
    report = select_domains(corpus, k=select_k, seed=seed, device=device)
    log_fn(
        f"[fastmatch] selected domains {sorted(report.selected_domains.tolist())} "
        f"scanning {report.blocks_scanned_frac:.1%} of blocks "
        f"(delta_upper={report.result.delta_upper:.2e}, exact={report.result.exact})"
    )
    stream = TokenStream(
        corpus, report.selected_domains, batch_size=batch_size, seq_len=seq_len, seed=seed
    )

    # ---- state init or resume ----
    state = TrainState.create(model, optimizer)
    manager = None
    if ckpt_dir:
        manager = CheckpointManager(ckpt_dir, config_hash=config_hash(cfg))
        latest = manager.latest_step()
        if latest is not None:
            state = state.load_(manager.restore(state.skeleton(), latest))
            log_fn(f"[resume] restored step {latest} from {ckpt_dir}")

    train_step = make_train_step(model, optimizer)

    # ---- preemption handling ----
    preempted = {"flag": False}

    def _on_term(signum, frame):
        preempted["flag"] = True

    old = signal.signal(signal.SIGTERM, _on_term)

    # ---- loop ----
    history = []
    t0 = time.time()
    start_step = int(state.step)
    # resume-exact data order: fast-forward the stream past consumed batches
    for _ in range(start_step):
        next(stream)
    try:
        for it in range(start_step, steps):
            batch = {k: torch.from_numpy(v).to(device) for k, v in next(stream).items()}
            if extra_batch_fn:
                batch.update(extra_batch_fn(batch))
            state, metrics = train_step(state, batch)
            if (it + 1) % log_every == 0 or it == steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = it + 1
                m["tok_per_s"] = (it + 1 - start_step) * batch_size * seq_len / (time.time() - t0)
                history.append(m)
                log_fn(
                    f"[train] step {it+1}/{steps} loss={m['loss']:.4f} ce={m['ce']:.4f} "
                    f"gnorm={m['grad_norm']:.2f} ok={m['step_ok']:.0f} "
                    f"tok/s={m['tok_per_s']:.0f}"
                )
            if manager and ((it + 1) % ckpt_every == 0 or preempted["flag"]):
                manager.save(state.to_disk(), it + 1)
            if preempted["flag"]:
                log_fn(f"[preempt] SIGTERM received; saved at step {it+1}; exiting")
                break
    finally:
        signal.signal(signal.SIGTERM, old)

    return {
        "state": state,
        "history": history,
        "selection": report,
        "final_loss": history[-1]["loss"] if history else None,
        "model": model,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, required=True)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    arch = ALIASES.get(args.arch, args.arch)
    cfg = get_smoke_config(arch) if args.smoke else get_config(arch)
    out = train_loop(
        cfg=cfg,
        steps=args.steps,
        batch_size=args.batch,
        seq_len=args.seq,
        lr=args.lr,
        ckpt_dir=args.ckpt_dir,
        seed=args.seed,
        device=args.device,
    )
    print(f"final loss: {out['final_loss']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
