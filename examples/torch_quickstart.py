"""Quickstart on the PyTorch port: the paper's full stack in ~80 lines.

  PYTHONPATH=src python examples/torch_quickstart.py                # one GPU
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu   # no GPU

1. Build a llama-family model and the port's real chunked-prefill engine
   (``TorchEngine``, seeded random weights).
2. Serve a mixed workload under FCFS, then under Aging (§3.1).
3. Compare TTFT/E2E -- Aging reorders prefills, execution is identical.

On the card the model is llama3.2-1b at its published width (16 layers,
d_model 2048, head_dim 64; about 2.5 GB of bf16 weights): the port's
attention kernels take head_dim 64 or 128 only, and the tiny config's is
16.  With ``--device cpu`` it is the tiny config, on the plain PyTorch path.
Exits non-zero unless every request of both runs finishes.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config, tiny_config  # noqa: E402
from repro_torch.core.scheduler import (  # noqa: E402
    ChunkedPrefillScheduler, SchedulerConfig,
)
from repro_torch.engine.engine import EngineConfig, TorchEngine, serve  # noqa: E402
from repro_torch.engine.workload import (  # noqa: E402
    WorkloadSpec, attach_prompt_tokens, sharegpt_like,
)

ARCH = "llama3.2-1b"
N_REQUESTS = 16


def run(engine, cfg, policy: str):
    # a short/long mixed workload (ShareGPT-like skew), real token ids
    requests = sharegpt_like(WorkloadSpec(
        n_requests=N_REQUESTS, inter_arrival_s=0.02, max_context=256,
        max_new_tokens=24, seed=0,
    ))
    attach_prompt_tokens(requests, cfg.vocab_size)

    scheduler = ChunkedPrefillScheduler(SchedulerConfig(
        policy=policy,          # "fcfs" | "sjf" | "aging"
        alpha=1.0, beta=-0.1,   # aging: P_i = alpha*(wait) + beta*(remaining)
        token_budget=64,        # B_max per scheduling round
        max_seqs=8,
    ))
    result = serve(requests, scheduler, engine)
    row = result.report.row()
    print(f"{policy:6s}: finished {result.report.n_finished}/{N_REQUESTS} "
          f"in {result.wall_s:.2f}s | mean TTFT {row['mean_ttft'] * 1e3:7.1f} ms "
          f"| mean E2E {row['mean_e2e'] * 1e3:7.1f} ms")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the published width) or cpu (the tiny config)")
    args = ap.parse_args(argv)
    on_card = args.device != "cpu"
    if not on_card:
        # the tiny model's ops are too small to share out: more intra-op
        # threads only contend with the serve loop's own
        torch.set_num_threads(1)
    cfg = get_config(ARCH) if on_card else tiny_config(ARCH)
    engine = TorchEngine(cfg, EngineConfig(n_slots=8, max_context=512),
                         device=args.device)
    engine.warmup()
    print(f"serving {N_REQUESTS} mixed requests on {cfg.name} "
          f"({'card' if on_card else 'CPU'}) with the port's engine\n")
    fcfs = run(engine, cfg, "fcfs")
    aging = run(engine, cfg, "aging")
    f, a = fcfs.report.row(), aging.report.row()
    d = 100 * (a["mean_ttft"] - f["mean_ttft"]) / f["mean_ttft"]
    print(f"\nAging vs FCFS mean TTFT: {d:+.1f}% "
          "(negative = fairness-aware ordering helped)")
    done = all(r.report.n_finished == r.report.n_total == N_REQUESTS
               for r in (fcfs, aging))
    return 0 if done else 1


if __name__ == "__main__":
    sys.exit(main())
