"""Training driver: ``python -m repro_torch.launch.train --arch llama3.2-1b``
(the port of ``repro/launch/train.py``).

End-to-end: config -> seeded init -> data pipeline -> train_step loop with
checkpoint/restart, on one device: the card unless ``--device cpu``.  The
reference's mesh and shardings have no counterpart on one card; its jitted
step with donated buffers is an eager step that updates the params and
moments in place.  The tiny config is the default, ``--full`` the published
one.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import get_config, tiny_config
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.engine.engine import resolve_device
from repro_torch.models.model import build_model
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import (
    TrainConfig, init_train_state, make_train_step,
)


def train(
    arch: str,
    *,
    steps: int = 50,
    global_batch: int = 8,
    seq_len: int = 128,
    lr: float = 3e-4,
    tiny: bool = True,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 20,
    resume: bool = False,
    log_every: int = 10,
    n_microbatches: int = 1,
    seed: int = 0,
    device="cuda",
):
    """Train ``arch`` for ``steps`` steps: (params, losses of the steps this
    call ran).  With ``ckpt_dir`` a checkpoint is saved every
    ``ckpt_every`` steps and at the end; ``resume`` starts from its latest.
    The schedule warms up over ``max(1, steps // 20)`` steps and decays to
    ``steps``, as the reference's."""
    dev = resolve_device(device)
    cfg = tiny_config(arch) if tiny else get_config(arch)
    model = build_model(cfg)

    tcfg = TrainConfig(
        optimizer=AdamWConfig(lr=lr, weight_decay=0.1, grad_clip_norm=1.0,
                              warmup_steps=max(1, steps // 20),
                              total_steps=steps),
        n_microbatches=n_microbatches,
    )
    data = SyntheticLM(DataConfig(cfg.vocab_size, global_batch, seq_len,
                                  seed=seed))

    gen = torch.Generator(device=dev).manual_seed(seed)
    params, opt_state = init_train_state(model, gen, tcfg, dev)
    step_fn = make_train_step(model, tcfg)

    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if ckpt and resume and ckpt.latest_step() is not None:
        start, (params, opt_state) = ckpt.restore((params, opt_state))
        print(f"resumed from step {start}")

    losses = []
    t0 = time.time()
    try:
        for step in range(start, steps):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in data.batch_at(step).items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            losses.append(float(metrics["loss"]))
            if step % log_every == 0 or step == steps - 1:
                dt = time.time() - t0
                tok_s = global_batch * seq_len * (step - start + 1) / max(dt, 1e-9)
                print(
                    f"step {step:5d} loss {losses[-1]:.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} tok/s {tok_s:,.0f}"
                )
            if ckpt and (step + 1) % ckpt_every == 0:
                ckpt.save(step + 1, (params, opt_state))
        if ckpt:
            ckpt.save(steps, (params, opt_state), blocking=True)
            ckpt.wait()
    finally:
        if ckpt:
            ckpt.close()
    return params, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full", action="store_true", help="full (non-tiny) config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain path)")
    args = ap.parse_args(argv)
    _, losses = train(
        args.arch, steps=args.steps, global_batch=args.global_batch,
        seq_len=args.seq_len, lr=args.lr, tiny=not args.full,
        ckpt_dir=args.ckpt_dir, resume=args.resume,
        n_microbatches=args.microbatches, device=args.device,
    )
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
