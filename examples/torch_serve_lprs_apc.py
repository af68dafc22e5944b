"""End-to-end serving driver on the PyTorch port (the paper's full system,
§3.2-3.3):

  PYTHONPATH=src python examples/torch_serve_lprs_apc.py                # GPU
  PYTHONPATH=src python examples/torch_serve_lprs_apc.py --device cpu

1. PROFILE: run the static token-budget scheduler on the port's real engine
   (``TorchEngine``, seeded random weights) and record (16-dim features,
   wall-clock ms) per round -- §3.2.1's offline pipeline on this machine's
   own latencies.
2. TRAIN the MLP latency predictor (asymmetric Huber), on the CPU: the
   pipelined loop calls ``predict()`` while the previous round runs on the
   card, and a forward pass on the card's stream would wait for that round.
3. SERVE with LPRS (target-latency chunk search, Algorithm 1) + APC
   (activity cap / min progress, Eqs. 12-14) and compare against the
   static-budget baseline on the same workload.

On the card the model is qwen1.5-0.5b at its published width (24 layers,
d_model 1024, head_dim 64): the port's attention kernels take head_dim 64
or 128 only, and the tiny config's is 16.  With ``--device cpu`` it is the
tiny config, on the plain PyTorch path.  Exits non-zero unless every
request of every run finishes.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config, tiny_config  # noqa: E402
from repro_torch.core.apc import APCConfig  # noqa: E402
from repro_torch.core.lprs import LPRSConfig  # noqa: E402
from repro_torch.core.predictor import (  # noqa: E402
    LatencyPredictor, PredictorConfig, bucket_and_downsample,
)
from repro_torch.core.scheduler import (  # noqa: E402
    ChunkedPrefillScheduler, SchedulerConfig,
)
from repro_torch.engine.engine import EngineConfig, TorchEngine, serve  # noqa: E402
from repro_torch.engine.workload import (  # noqa: E402
    WorkloadSpec, attach_prompt_tokens, sharegpt_like,
)

MODEL = "qwen1.5-0.5b"


def make_workload(n, seed, vocab_size):
    reqs = sharegpt_like(WorkloadSpec(
        n_requests=n, inter_arrival_s=0.01, max_context=256,
        max_new_tokens=16, seed=seed,
    ))
    attach_prompt_tokens(reqs, vocab_size, seed=seed)
    return reqs


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
    cfg = get_config(MODEL) if on_card else tiny_config(MODEL)
    engine = TorchEngine(cfg, EngineConfig(n_slots=8, max_context=512),
                         device=args.device)
    engine.warmup()     # every bucket once, so profiling is steady-state
    done = True

    # -- 1. profile under the static budget --------------------------------
    print("1) profiling real round latencies under the static budget ...")
    sched = ChunkedPrefillScheduler(SchedulerConfig(
        policy="fcfs", token_budget=96, max_seqs=8,
    ))
    feats, lats = [], []
    for seed in range(3):
        prof = serve(make_workload(32, 100 + seed, cfg.vocab_size), sched,
                     engine, collect_samples=True)
        done &= prof.report.n_finished == prof.report.n_total
        feats.append(prof.samples[0])
        lats.append(prof.samples[1])
    feats, lats = np.concatenate(feats), np.concatenate(lats)
    # clean: drop wall-clock outliers (GC pauses etc.), per §3.2.1 step 3
    ok = lats < 5 * np.median(lats)
    feats, lats = feats[ok], lats[ok]
    print(f"   {len(lats)} rounds, latency p50={np.median(lats):.1f} ms "
          f"p90={np.percentile(lats, 90):.1f} ms")

    # -- 2. train the predictor --------------------------------------------
    print("2) training the latency predictor (asymmetric Huber) ...")
    keep, w = bucket_and_downsample(feats[:, 12])
    predictor = LatencyPredictor(PredictorConfig(epochs=200, dropout=0.0),
                                 device="cpu")
    predictor.fit(feats[keep], lats[keep], sample_weights=w)
    print(f"   eval: {predictor.evaluate(feats, lats)}")

    # -- 3. serve: static budget vs LPRS+APC --------------------------------
    target = float(np.percentile(lats, 60))
    print(f"3) serving with LPRS (T*={target:.1f} ms) + APC vs static budget")
    results = {}
    for label, lprs, apc in (
        ("static", None, None),
        ("lprs+apc", LPRSConfig(target_latency_ms=target, search_delta=16),
         APCConfig(c_max=2, l_min=16)),
    ):
        sched = ChunkedPrefillScheduler(
            SchedulerConfig(policy="aging", alpha=1.0, beta=-0.1,
                            token_budget=96, max_seqs=8, lprs=lprs, apc=apc),
            predictor=predictor if lprs else None,
        )
        res = serve(make_workload(16, 1, cfg.vocab_size), sched, engine,
                    collect_samples=True)
        done &= res.report.n_finished == res.report.n_total
        row = res.report.row()
        _, round_lats = res.samples
        over = float(np.mean(round_lats > target))
        results[label] = (row, over)
        print(f"   {label:9s} finished {res.report.n_finished}/16 | "
              f"P99 e2e {row['p99_e2e'] * 1e3:7.1f} ms | round>T* {over:.0%}"
              + (f" | apc blocks {sched.stats.apc.blocked_by_min_chunk + sched.stats.apc.blocked_by_cap}"
                 if apc else ""))

    s_over = results["static"][1]
    l_over = results["lprs+apc"][1]
    print(f"\nrounds exceeding the {target:.0f} ms target: "
          f"static {s_over:.0%} -> LPRS {l_over:.0%} "
          "(LPRS trades fill for latency controllability)")
    return 0 if done else 1


if __name__ == "__main__":
    sys.exit(main())
