"""Multi-tenant serving on the PyTorch port's engine:

  PYTHONPATH=src python examples/torch_serve_multitenant.py                # GPU
  PYTHONPATH=src python examples/torch_serve_multitenant.py --device cpu

One heavy tenant (long prompts, high rate) and two light tenants share a
Qwen engine (``TorchEngine``, seeded random weights).  The run is executed
twice over the same trace -- once with the paper's Aging scheduler alone,
once with the tenancy subsystem on top (weighted VTC + token-bucket
admission) -- and the per-tenant TTFT and Jain's fairness index are
compared.

On the card the model is qwen1.5-0.5b at its published width (24 layers,
d_model 1024, head_dim 64): the port's attention kernels take head_dim 64
or 128 only, and the tiny config's is 16.  With ``--device cpu`` it is the
tiny config, on the plain PyTorch path.  Exits non-zero unless every
request of both runs finishes.
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
from repro_torch.engine.metrics import summarize_by_tenant  # noqa: E402
from repro_torch.engine.workload import (  # noqa: E402
    TenantTraffic, attach_prompt_tokens, multi_tenant,
)
from repro_torch.tenancy import FairnessConfig, TenantSpec  # noqa: E402

MODEL = "qwen1.5-0.5b"

TENANTS = (
    TenantSpec("bulk", weight=1.0, rate_tokens_per_s=400.0, burst_tokens=800.0),
    TenantSpec("chat-a", weight=2.0),
    TenantSpec("chat-b", weight=2.0),
)


def make_workload(seed: int, vocab_size: int):
    reqs = multi_tenant(
        [
            TenantTraffic("bulk", "heavy", rps=40.0, prompt_mean=128.0,
                          max_new_tokens=8),
            TenantTraffic("chat-a", "light", rps=4.0, prompt_mean=24.0,
                          max_new_tokens=8),
            TenantTraffic("chat-b", "light", rps=4.0, prompt_mean=24.0,
                          max_new_tokens=8),
        ],
        duration_s=2.0, max_context=192, seed=seed,
    )
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
    # enough slots that the scheduler, not FCFS slot admission, decides order
    engine = TorchEngine(cfg, EngineConfig(n_slots=32, max_context=256),
                         device=args.device)
    engine.warmup()

    results, done = {}, True
    for label, fairness in (
        ("aging", None),
        ("aging+tenancy", FairnessConfig(tenants=TENANTS)),
    ):
        sched = ChunkedPrefillScheduler(SchedulerConfig(
            policy="aging", alpha=1.0, beta=-0.01,
            token_budget=96, max_seqs=32, fairness=fairness,
        ))
        res = serve(make_workload(0, cfg.vocab_size), sched, engine)
        done &= res.report.n_finished == res.report.n_total
        rep = summarize_by_tenant(
            res.requests, weights={t.name: t.weight for t in TENANTS},
        )
        results[label] = rep
        print(f"\n== {label}: {res.report.n_finished}/{res.report.n_total} "
              f"finished in {res.wall_s:.1f}s, {res.rounds} rounds")
        for t, r in rep.per_tenant.items():
            print(f"   {t:8s} n={r.n_total:3d} mean TTFT {r.ttft['mean'] * 1e3:7.1f} ms"
                  f" | p95 {r.ttft['p95'] * 1e3:7.1f} ms"
                  f" | service {rep.service_tokens[t]:7.0f} tok")
        print(f"   Jain (weight-normalized service): {rep.jain:.3f}")
        if fairness is not None:
            snap = sched.fairness.vtc.snapshot()
            print("   VTC: " + ", ".join(
                f"{t}: virtual={s['virtual']:.0f}" for t, s in sorted(snap.items())
            ))
            if sched.fairness.admission is not None:
                st = sched.fairness.admission.stats
                print(f"   admission: {st.assessed} assessed, "
                      f"{st.penalties} penalties, {st.rejected} rejected")

    base, fair = results["aging"], results["aging+tenancy"]
    chat_base = max(base.per_tenant[t].ttft["p95"] for t in ("chat-a", "chat-b"))
    chat_fair = max(fair.per_tenant[t].ttft["p95"] for t in ("chat-a", "chat-b"))
    print(f"\nworst chat-tenant P95 TTFT: {chat_base * 1e3:.0f} ms (aging) -> "
          f"{chat_fair * 1e3:.0f} ms (aging+tenancy) | "
          f"Jain {base.jain:.3f} -> {fair.jain:.3f}")
    return 0 if done else 1


if __name__ == "__main__":
    sys.exit(main())
