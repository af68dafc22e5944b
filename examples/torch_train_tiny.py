"""Train a tiny model end-to-end with the PyTorch port's training stack:

  PYTHONPATH=src python examples/torch_train_tiny.py                # one GPU
  PYTHONPATH=src python examples/torch_train_tiny.py --device cpu   # no GPU

seeded init -> synthetic data pipeline -> train_step (remat, grad-accum over
2 microbatches) -> async checkpointing -> kill/resume demonstration: a
second run resumes from the first run's last checkpoint and trains 20 steps
more.  Exits non-zero unless every loss is finite and the resumed run
starts where the first one stopped.
"""
import argparse
import math
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.launch.train import train  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b",
                    help="any assigned arch id (tiny variant is used)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain path)")
    args = ap.parse_args(argv)
    kw = dict(global_batch=8, seq_len=64, ckpt_every=20, log_every=10,
              n_microbatches=2, device=args.device)

    with tempfile.TemporaryDirectory() as d:
        print(f"== training tiny {args.arch} for {args.steps} steps "
              f"(ckpt every 20 into {d}) ==")
        _, losses = train(args.arch, steps=args.steps, ckpt_dir=d, **kw)
        print(f"\nloss: {losses[0]:.3f} -> {losses[-1]:.3f}")

        print("\n== simulated failure: resuming from the last checkpoint ==")
        _, tail = train(args.arch, steps=args.steps + 20, ckpt_dir=d,
                        resume=True, **kw)
        print(f"\nresumed loss: {tail[0]:.3f} -> {tail[-1]:.3f}")
    ok = (all(math.isfinite(x) for x in losses + tail)
          and len(tail) == 20)
    print("ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
