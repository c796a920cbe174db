"""Training driver — end to end on one device (port of
``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch tinyllama-1.1b --steps 200 --batch 8 --seq 256

The reduced config by default (``--full`` runs the published widths and
depth); ``--device`` defaults to ``cuda`` (``--device cpu`` runs the plain
PyTorch path).  The complete stack: synthetic data drawn on the device →
remat'd train step → AdamW → checkpoint/restart → straggler watchdog.  A
second run with the same ``--ckpt-dir`` resumes from the newest checkpoint
and prints ``restored checkpoint at step N``.  On the card the steps
replay a CUDA graph from the second on; the last line, ``graphs: …``,
gives its graphs, replays, capture seconds and pool bytes (all 0 on the
CPU, where the step runs inline).
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.checkpoint.checkpointer import checkpoint_bytes, latest_step
from repro_torch.configs import registry
from repro_torch.data.pipeline import SyntheticCorpus, TrainStream
from repro_torch.device import resolve_device
from repro_torch.models.model_builder import build_model
from repro_torch.optim import AdamW
from repro_torch.optim.schedules import cosine_warmup
from repro_torch.train import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=list(registry.ARCHS))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--remat", default="block", choices=["block", "none"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = registry.get_config(args.arch, reduced=args.reduced)
    model = build_model(cfg, device=device)
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size)
    stream = TrainStream(corpus, global_batch=args.batch, seq_len=args.seq,
                         device=device)
    optimizer = AdamW(weight_decay=0.1, clip_norm=1.0)
    schedule = cosine_warmup(args.lr, args.steps // 10, args.steps)

    trainer = Trainer(
        model, optimizer, schedule, stream,
        TrainerConfig(
            total_steps=args.steps, ckpt_dir=args.ckpt_dir,
            save_every=args.save_every, log_every=10, remat=args.remat,
        ),
    )
    trainer.run(torch.Generator(device=device).manual_seed(0), log=print)
    losses = [h["loss"] for h in trainer.history]
    if losses:
        print(f"done: first loss {losses[0]:.4f} → last {losses[-1]:.4f} "
              f"({len(losses)} steps this run, "
              f"{trainer.watchdog.flagged} straggler flags)")
    ck = trainer.ckpt
    last = latest_step(args.ckpt_dir)
    if last is not None and (ck.save_seconds or ck.restore_seconds):
        print(f"checkpoint: step {last}, "
              f"{checkpoint_bytes(args.ckpt_dir, last)} bytes, last save "
              f"{ck.save_seconds:.2f} s, restore {ck.restore_seconds:.2f} s")
    g = trainer.graph_stats()
    print(f"graphs: {g['graphs']} graphs, {g['replays']} replays, capture "
          f"{g['capture_s']:.2f} s, pool {g['pool_bytes']} bytes")
    return trainer


if __name__ == "__main__":
    main()
