"""Serving entry point of the port: ``python -m repro_torch.launch.serve
--full --kv-layout fused --policy aging --lprs --apc``.

``repro/launch/serve.py`` on PyTorch, the paper's full stack: one replica,
the chunked-prefill engine with paged KV (``--kv-layout split`` or
``fused``) or the dense per-slot A/B layout (``--dense-kv``), the pipelined
loop, recompute or swap preemption (``--preemption-mode``), greedy sampling
and the real scheduler (Aging/FCFS/SJF, LPRS latency-targeted chunking with
its predictor trained on this engine's own profiled round latencies, APC,
optional SLO tier and fault tolerance: ``--failover``, the NaN guard
``--nan-guard`` and seeded chaos plans ``--chaos-seed``); or, with
``--disagg``, a fleet of prefill and decode replicas with cross-replica KV
handoff.  The model is full width on one NVIDIA GPU (``--full``) or tiny;
weights are the port's seeded random init.  ``--device cpu`` runs the plain
PyTorch path.  ``--spans PATH`` records the serve loop's spans
(``repro_torch.tracing``), writes them as a Chrome trace and prints a
summary of them; with ``--profile`` they are put on the profiler's clock and
into its trace as well.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import get_config, tiny_config
from repro_torch.core.apc import APCConfig
from repro_torch.core.lprs import LPRSConfig
from repro_torch.core.predictor import (
    LatencyPredictor, PredictorConfig, bucket_and_downsample,
)
from repro_torch.core.scheduler import ChunkedPrefillScheduler, SchedulerConfig
from repro_torch.core.slo import SLOConfig
from repro_torch import tracing
from repro_torch.tenancy.tenants import FairnessConfig, TenantSpec
from repro_torch.engine.engine import EngineConfig, TorchEngine, serve
from repro_torch.engine.kv_cache import pool_for_model
from repro_torch.engine.workload import (
    WorkloadSpec,
    attach_prompt_tokens,
    sharegpt_like,
)


def profile_engine(model_cfg, engine: TorchEngine, *, kv_pool=None,
                   n_requests: int = 48, budget: int = 128, seed: int = 0):
    """The paper's offline profiling run (§3.2.1) on REAL latencies: serve a
    ShareGPT-like workload under the static token-budget FCFS scheduler and
    return ``(features (n, 16), wall ms (n,))``, one row per round.  With
    ``kv_pool`` (the pool the engine is bound to) the run books its blocks
    there and then resets the pool, so that the serve that follows starts
    from an empty prefix cache and reports only its own counters."""
    reqs = sharegpt_like(WorkloadSpec(
        n_requests=n_requests, inter_arrival_s=0.005, max_context=256,
        max_new_tokens=32, seed=seed,
    ))
    attach_prompt_tokens(reqs, model_cfg.vocab_size, seed=seed)
    sched = ChunkedPrefillScheduler(
        SchedulerConfig(policy="fcfs", token_budget=budget,
                        max_seqs=engine.cfg.n_slots)
    )
    res = serve(reqs, sched, engine, kv_pool=kv_pool, collect_samples=True)
    if kv_pool is not None:
        kv_pool.reset()
    return res.samples


def train_predictor(feats, lats, *, epochs: int = 120) -> LatencyPredictor:
    """Bucket + downsample on scheduled_tokens (column 12) and fit the MLP;
    with ``profile_engine`` this is ``repro``'s
    ``profile_and_train_predictor``, in two halves that can be timed apart.

    The predictor runs on the CPU, beside the rest of the scheduler: the
    pipelined loop calls ``predict()`` while it schedules round N+1 and round
    N is still running on the card, and a forward pass on the card's stream
    would queue behind round N -- its read-back would hold the host until
    round N ends and undo the overlap."""
    keep, wts = bucket_and_downsample(feats[:, 12])
    pred = LatencyPredictor(PredictorConfig(epochs=epochs), device="cpu")
    pred.fit(feats[keep], lats[keep], sample_weights=wts)
    return pred


def robustness_from_args(args):
    """--failover / --chaos-seed -> a RobustnessConfig (or None: every serve
    path stays bit-identical to the fault-oblivious code)."""
    if not (args.failover or args.chaos_seed is not None):
        return None
    from repro_torch.robustness import FaultInjector, FaultPlan, RobustnessConfig

    injector = None
    if args.chaos_seed is not None:
        plan = FaultPlan.fuzz(args.chaos_seed, n_faults=args.chaos_faults)
        injector = FaultInjector(plan)
    return RobustnessConfig(
        max_retries=args.max_retries,
        handoff_ttl_s=args.handoff_ttl if args.handoff_ttl > 0 else None,
        injector=injector,
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    ap.add_argument("--policy", default="aging", choices=["fcfs", "sjf", "aging"])
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--beta", type=float, default=-0.01)
    ap.add_argument("--token-budget", type=int, default=128)
    ap.add_argument("--n-requests", type=int, default=32)
    ap.add_argument("--interval", type=float, default=0.02)
    ap.add_argument("--lprs", action="store_true",
                    help="latency-targeted chunking: profile this engine, "
                         "train the latency predictor, serve with LPRS")
    ap.add_argument("--target-ms", type=float, default=0.0,
                    help="LPRS target round latency in ms (0 = 30.0)")
    ap.add_argument("--apc", action="store_true")
    ap.add_argument("--dense-kv", action="store_true",
                    help="dense per-slot KV cache instead of the paged pool "
                         "(the A/B layout; greedy outputs are identical)")
    ap.add_argument("--sync-engine", action="store_true",
                    help="synchronous round loop instead of the overlapped "
                         "schedule/execute pipeline (A/B baseline; outputs "
                         "are identical under greedy sampling)")
    ap.add_argument("--kv-layout", default="split", choices=["split", "fused"],
                    help="paged KV pool layout: 'split' keeps separate K and "
                         "V pools; 'fused' interleaves K/V on the head axis "
                         "so each key's K and V are one contiguous run "
                         "(greedy outputs are identical)")
    ap.add_argument("--preemption-mode", default="recompute",
                    choices=["recompute", "swap"],
                    help="KV-pressure eviction strategy: 'recompute' discards "
                         "the victim's KV and re-prefills it; 'swap' stages "
                         "it host-side and restores it on re-schedule "
                         "(chosen per victim by the transfer-vs-FLOPs cost "
                         "model; greedy outputs are identical either way)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="enable the hash-based KV prefix cache (block-aligned "
                         "prompt reuse; hits skip the matched prefill compute)")
    ap.add_argument("--kv-blocks", type=int, default=2048,
                    help="KV pool size in blocks")
    ap.add_argument("--disagg", action="store_true",
                    help="disaggregated serving: separate prefill and decode "
                         "replica pools with cross-replica KV handoff "
                         "(greedy outputs are identical to single-engine)")
    ap.add_argument("--n-prefill", type=int, default=1,
                    help="prefill-pool replicas (with --disagg)")
    ap.add_argument("--n-decode", type=int, default=1,
                    help="decode-pool replicas (with --disagg)")
    ap.add_argument("--min-handoff-tokens", type=int, default=0,
                    help="prompts with fewer resident KV tokens than this "
                         "never migrate (with --disagg)")
    ap.add_argument("--handoff-cost", action="store_true",
                    help="price each handoff against colocated contention "
                         "instead of always migrating (with --disagg)")
    ap.add_argument("--ttft-slo", type=float, default=0.0,
                    help="time-to-first-token SLO in seconds (0 = off); "
                         "either SLO enables the SLO tier")
    ap.add_argument("--e2e-slo", type=float, default=0.0,
                    help="end-to-end completion SLO in seconds (0 = off)")
    ap.add_argument("--failover", action="store_true",
                    help="fault-tolerant serving: crash unwinds and replica "
                         "health tracking")
    ap.add_argument("--max-retries", type=int, default=3)
    ap.add_argument("--handoff-ttl", type=float, default=0.0,
                    help="reap staged handoff records older than this many "
                         "seconds (0 = no TTL; with --failover)")
    ap.add_argument("--nan-guard", action="store_true",
                    help="per-round finite-logits check: requests whose "
                         "logits go NaN/Inf are quarantined (terminal shed "
                         "reason 'numerics') instead of poisoning the batch")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="fuzz a deterministic fault plan from this seed and "
                         "inject it (implies --failover)")
    ap.add_argument("--chaos-faults", type=int, default=3)
    ap.add_argument("--full", action="store_true",
                    help="the architecture at its published width")
    ap.add_argument("--json", default=None)
    ap.add_argument("--profile", default=None, metavar="TRACE_JSON",
                    help="trace the serve run with torch.profiler: print the "
                         "ops by device time and the device-busy share, and "
                         "write a Chrome trace to this path")
    ap.add_argument("--spans", default=None, metavar="SPANS_JSON",
                    help="record the serve loop's spans, write them as a "
                         "Chrome trace to this path and print their summary "
                         "(with --profile: on the profiler's clock, and "
                         "added to its trace); not with --disagg")
    return ap


def _kv_name(args) -> str:
    return "dense" if args.dense_kv else f"paged/{args.kv_layout}"


def _model_cfg(args):
    return get_config(args.arch) if args.full else tiny_config(args.arch)


def _engine_cfg(args) -> EngineConfig:
    return EngineConfig(n_slots=16, max_context=512,
                        paged_kv=not args.dense_kv,
                        pipelined=not args.sync_engine,
                        kv_layout=args.kv_layout,
                        preemption_mode=args.preemption_mode,
                        nan_guard=args.nan_guard)


def workload(args, model_cfg):
    reqs = sharegpt_like(WorkloadSpec(
        n_requests=args.n_requests, inter_arrival_s=args.interval,
        max_context=256, max_new_tokens=48, seed=1,
    ))
    attach_prompt_tokens(reqs, model_cfg.vocab_size, seed=1)
    return reqs


def build_scheduler(args, predictor=None) -> ChunkedPrefillScheduler:
    """The colocated scheduler the arguments ask for; ``--lprs`` needs the
    trained ``predictor``."""
    lprs_cfg = None
    if args.lprs:
        target = args.target_ms
        if target <= 0:
            target = 30.0
        lprs_cfg = LPRSConfig(target_latency_ms=target, search_delta=32)

    fairness_cfg = None
    slo_cfg = None
    if args.ttft_slo > 0 or args.e2e_slo > 0:
        # SLO tier: the workload's single "default" tenant carries the
        # deadlines; fairness is required (the tracker lives on its registry)
        fairness_cfg = FairnessConfig(tenants=(TenantSpec(
            "default",
            ttft_slo_s=args.ttft_slo if args.ttft_slo > 0 else None,
            e2e_slo_s=args.e2e_slo if args.e2e_slo > 0 else None,
        ),))
        slo_cfg = SLOConfig()

    return ChunkedPrefillScheduler(
        SchedulerConfig(
            policy=args.policy, alpha=args.alpha, beta=args.beta,
            token_budget=args.token_budget, max_seqs=16,
            lprs=lprs_cfg,
            apc=APCConfig(c_max=4, l_min=16) if args.apc else None,
            fairness=fairness_cfg,
            slo=slo_cfg,
        ),
        predictor=predictor if args.lprs else None,
    )


def build(args, *, host_kv_dtype: str = "auto"):
    """(engine, scheduler, kv_pool, requests) for the parsed arguments: the
    engine is bound to the pool and warmed up, every kernel built; with
    ``--lprs`` the engine is profiled on that pool and the scheduler holds
    the predictor trained on it.  ``host_kv_dtype="int8"`` stages swapped
    pages as INT8 (an API option, as in the JAX package: the CLI has no flag
    for it)."""
    model_cfg = _model_cfg(args)
    engine = TorchEngine(model_cfg, _engine_cfg(args), device=args.device)
    kv_pool = pool_for_model(model_cfg, n_blocks=args.kv_blocks,
                             enable_prefix_cache=args.prefix_cache,
                             host_kv_dtype=host_kv_dtype)
    # bind first: warm-up runs against the physical pool serving will use
    engine.bind_kv_pool(kv_pool)
    engine.warmup()
    predictor = None
    if args.lprs:
        feats, lats = profile_engine(model_cfg, engine, kv_pool=kv_pool)
        predictor = train_predictor(feats, lats)
        print(f"predictor trained on {len(lats)} real samples: "
              f"{predictor.evaluate(feats, lats)}")
    sched = build_scheduler(args, predictor)
    return engine, sched, kv_pool, workload(args, model_cfg)


def build_fleet(args):
    """(router, requests) for ``--disagg``: a prefill pool and a decode pool
    of replicas on ``args.device``, sharing one weight set, each warmed up
    with its swap kernels (every handoff rides them), as ``build`` warms
    the colocated engine."""
    from repro_torch.disagg import DisaggConfig, HandoffCostConfig, build_disagg

    model_cfg = _model_cfg(args)
    router = build_disagg(
        model_cfg,
        cfg=DisaggConfig(
            n_prefill=args.n_prefill,
            n_decode=args.n_decode,
            min_handoff_tokens=args.min_handoff_tokens,
            cost=HandoffCostConfig() if args.handoff_cost else None,
            robustness=robustness_from_args(args),
        ),
        engine_cfg=_engine_cfg(args),
        sched_cfg=SchedulerConfig(
            policy=args.policy, alpha=args.alpha, beta=args.beta,
            token_budget=args.token_budget, max_seqs=16,
            apc=APCConfig(c_max=4, l_min=16) if args.apc else None,
        ),
        n_blocks=args.kv_blocks,
        prefix_cache=args.prefix_cache,
        warmup=True,
        device=args.device,
    )
    return router, workload(args, model_cfg)


def _print_report(row) -> None:
    for k, v in row.items():
        print(f"  {k:16s} {v*1e3 if 'e2e' in k or 'ttft' in k or 'prefill' in k or 'tpot' in k else v:10.2f}"
              + (" ms" if any(t in k for t in ("e2e", "ttft", "prefill", "tpot")) else ""))


def run_disagg(args):
    """--disagg: serve the workload through the prefill pool + decode pool
    fleet and its cross-replica KV handoff path."""
    from repro_torch.disagg import serve_disagg

    router, reqs = build_fleet(args)

    def run():
        return serve_disagg(reqs, router)

    res = profiled(run, args.profile) if args.profile else run()
    router.check_invariants()

    if res.robustness is not None:
        rb = res.robustness
        print(f"  fault tolerance: died={rb.replicas_died} "
              f"failovers={rb.failovers} resumable={rb.recovered_resumable} "
              f"reprefill={rb.requeued_reprefill} "
              f"shed={rb.shed_replica_failure} "
              f"quarantined={rb.quarantined} faults_fired={rb.faults_fired}")
        for ev in rb.events:
            print(f"    {ev}")

    row = res.report.row()
    print(f"\n=== {args.arch}{'' if args.full else '-tiny'} | DISAGG "
          f"{args.n_prefill}P+{args.n_decode}D policy={args.policy} "
          f"kv={_kv_name(args)} loop={'sync' if args.sync_engine else 'pipelined'} "
          f"cost={'model' if args.handoff_cost else 'always'} ===")
    print(f"finished {res.report.n_finished}/{res.report.n_total} "
          f"in {res.wall_s:.2f}s  ({res.rounds} rounds over "
          f"{len(router.replicas)} replicas)")
    print(f"  handoffs={res.handoffs} colocated={res.colocated} "
          f"dropped={res.dropped_handoffs} "
          f"moved={res.bytes_moved / 2**20:.1f} MiB")
    decode_prefill_tokens = sum(
        rs.sched.stats.scheduled_prefill_tokens for rs in router.decode)
    print(f"  decode-pool prefill tokens scheduled: {decode_prefill_tokens} "
          f"(handoffs resume decode-only)")
    _print_report(row)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({
                "report": row, "rounds": res.rounds, "wall_s": res.wall_s,
                "handoffs": res.handoffs, "colocated": res.colocated,
                "dropped_handoffs": res.dropped_handoffs,
                "bytes_moved": res.bytes_moved,
                "decode_prefill_tokens": decode_prefill_tokens,
            }, f)
    return res


# Chrome-trace categories of work on the device itself
DEVICE_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy_ms(trace_events) -> float:
    """Milliseconds in which the device ran at least one kernel, copy or
    memset: the union of those events' intervals in a Chrome trace."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in trace_events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_EVENT_CATS)
    busy_us, end = 0.0, float("-inf")
    for t0, t1 in spans:
        if t1 > end:
            busy_us += t1 - max(t0, end)
            end = t1
    return busy_us / 1e3


def swap_device_ms(trace_events) -> dict:
    """Device time of the swap path in a Chrome trace: ``{kind: (ms, events,
    bytes)}`` for the swap kernels (``swap::``) and for the host<->device
    copies by direction, those of at least 256 KiB (staged swap and
    handoff payloads: one page of every layer is 768 KiB at full width) apart
    from the small ones (sampled ids, block tables, page ids)."""
    out = {}
    for e in trace_events:
        if e.get("ph") != "X":
            continue
        name = e.get("name", "")
        if e.get("cat") == "kernel" and "swap::" in name:
            kind = "swap kernels"
        elif e.get("cat") == "gpu_memcpy" and ("DtoH" in name or "HtoD" in name):
            n_bytes = e.get("args", {}).get("bytes", 0)
            kind = (f"memcpy {'DtoH' if 'DtoH' in name else 'HtoD'} "
                    f"{'>=' if n_bytes >= 1 << 18 else '<'} 256 KiB")
        else:
            continue
        ms, n, b = out.get(kind, (0.0, 0, 0))
        out[kind] = (ms + e["dur"] / 1e3, n + 1,
                     b + e.get("args", {}).get("bytes", 0))
    return out


def profiled(run, trace_path: str):
    """``run()`` under torch.profiler (CPU and, on a card, CUDA activity):
    prints the top ops by self device time, the device-busy share of the
    serve wall time, the swap path's device time, and writes a Chrome
    trace.  Tracing slows the host
    side; read host times from an untraced run."""
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=acts) as prof:
        res = run()
        if on_card:
            torch.cuda.synchronize()
    prof.export_chrome_trace(trace_path)
    avg = prof.key_averages()
    key = ("self_device_time_total" if hasattr(avg[0], "self_device_time_total")
           else "self_cuda_time_total")
    print(avg.table(sort_by=key, row_limit=25))
    # from the trace's device events: summing the non-CPU rows of
    # key_averages() instead came to about twice the kernels' own time
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    busy_ms = device_busy_ms(events)
    n_kernels = sum(e.get("ph") == "X" and e.get("cat") == "kernel"
                    for e in events)
    print(f"device busy {busy_ms:.1f} ms of {res.wall_s * 1e3:.1f} ms serve "
          f"wall ({busy_ms / (res.wall_s * 1e3):.1%}), {n_kernels} kernels; "
          f"trace: {trace_path}")
    for kind, (ms, n, n_bytes) in sorted(swap_device_ms(events).items()):
        print(f"  {kind}: {ms:.3f} ms device time ({ms / busy_ms:.2%} of "
              f"busy) over {n} events, {n_bytes} B")
    return res


def write_spans(tracer: tracing.Tracer, path: str, profile_path=None) -> None:
    """The spans as a Chrome trace at ``path``; with the profiler's trace at
    ``profile_path``, on its clock (through the tracer's anchors) and added
    to it too.  Prints the summary."""
    spans = tracer.spans()
    to_us = None
    if profile_path:
        with open(profile_path) as f:
            trace = json.load(f)
        to_us = tracing.clock(tracer.anchors,
                              tracing.chrome_anchors(trace["traceEvents"]))
        trace["traceEvents"] += tracing.chrome_events(spans, to_us)
        with open(profile_path, "w") as f:
            json.dump(trace, f)
    tracing.write_chrome(path, spans, to_us)
    print(f"spans: {len(spans)} written to {path}")
    for line in tracing.summary(spans):
        print(f"  {line}")


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.disagg:
        if args.spans:
            ap.error("--spans traces the colocated serve loop, not --disagg")
        return run_disagg(args)
    engine, sched, kv_pool, reqs = build(args)
    tracer = tracing.Tracer() if args.spans else None
    anchored = tracer is not None and args.profile

    def run():
        if anchored:
            tracer.anchor()
        res = serve(reqs, sched, engine, kv_pool=kv_pool,
                    collect_samples=False,
                    robustness=robustness_from_args(args), tracer=tracer)
        if anchored:
            tracer.anchor()
        return res

    res = profiled(run, args.profile) if args.profile else run()

    row = res.report.row()
    dev = engine.device
    print(f"\n=== {args.arch}{'' if args.full else '-tiny'} on "
          f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}"
          f" | policy={args.policy} lprs={args.lprs} apc={args.apc} "
          f"kv={_kv_name(args)} "
          f"loop={'sync' if args.sync_engine else 'pipelined'} "
          f"prefix_cache={args.prefix_cache} "
          f"preempt={args.preemption_mode} ===")
    print(f"finished {res.report.n_finished}/{res.report.n_total} "
          f"in {res.wall_s:.2f}s  ({res.rounds} rounds)")
    if res.robustness is not None:
        rb = res.robustness
        print(f"  fault tolerance: crash_unwinds={rb.crash_unwinds} "
              f"quarantined={rb.quarantined} faults_fired={rb.faults_fired}")
    _print_report(row)
    mem = res.memory
    if mem is not None:
        print(f"  kv: hit_rate={mem.cache_hit_rate:.2%} "
              f"hit_tokens={mem.cache_hit_tokens} evictions={mem.evictions} "
              f"preemptions={mem.preemptions} cached_blocks={mem.cached_blocks}")
        if mem.swap_preemptions:
            print(f"  swap: {mem.swap_preemptions} victims staged "
                  f"({mem.swapped_out_tokens} tokens out, "
                  f"{mem.swapped_in_tokens} restored over "
                  f"{mem.swap_restores} swap-ins)")
    if res.slo is not None:
        for t, rep in res.slo.per_tenant.items():
            print(f"  slo[{t}]: attained={rep.attained} "
                  f"violated={rep.violated} shed={rep.shed} "
                  f"attainment={rep.attainment:.2%} "
                  f"p50_ttft_slack={rep.ttft_slack_s['p50'] * 1e3:.1f} ms")
    if tracer is not None:
        write_spans(tracer, args.spans, args.profile)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"report": row, "rounds": res.rounds, "wall_s": res.wall_s,
                       "memory": mem.row() if mem is not None else None,
                       "slo": res.slo.row() if res.slo is not None else None}, f)
    return res


if __name__ == "__main__":
    main()
