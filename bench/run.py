"""The benchmark of ``repro_torch``: one run of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  The cell's configuration, traffic mix, rate and per-layer metrics are
found by name (``bench/cell.py``).  Set-up makes the weights on the card
from the seed, builds the program's serving stack as ``python -m
repro_torch.launch.serve --full --policy aging --lprs --apc`` builds it
(the engine bound to its KV pool and warmed up, one CUDA graph per chunk
bucket; the LPRS predictor trained on the engine's own profiled rounds),
then serves the traffic open-loop: a lead-in, then the measured window.
After the window the plain reference checks what was served.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit); the last lines of standard error repeat the checks.

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` traces
the first ``TRACE_S`` seconds of the window with ``torch.profiler`` and
reports the per-layer metrics.  Diagnostics that print no result:
``--sweep r1,r2,..`` serves the cell's traffic at each rate in turn after
one set-up (the rate sweep); ``--readings s1,s2,..`` serves a window on
each seed in turn, new weights drawn in place, and prints the checks
(``--control`` adds the float8 control's reading).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse      # noqa: E402
import gc            # noqa: E402
import json          # noqa: E402
import math          # noqa: E402
import os            # noqa: E402
import subprocess    # noqa: E402
import sys           # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# run as a script: the package is imported as ``bench`` from the root, so
# its directory does not stand on the path by itself
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "bench"]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# Triton's cache, should anything compile through it, at a fixed path in
# the checkout (the kernels' own build directory is there already)
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "bench" / ".cache" / "triton"))

import numpy as np   # noqa: E402
import torch         # noqa: E402

from bench import cell as cells, compare, endtoend, loop, trace_read, traffic_gen, weights  # noqa: E402
from bench.flops import model as flops_model, peaks  # noqa: E402

TRACE_S = 4.0                     # seconds of the window the profiler traces
SETTLE_S = 1.0                    # from the profiler's start to its segment
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age_s() -> float:
    """Seconds since this process started, from /proc (0 if unreadable;
    10 ms steps)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Stack:
    """The program's serving stack for one cell, built at set-up."""

    def __init__(self, cell: cells.Cell, seed: int, device: str, log=print):
        from repro_torch.engine.engine import EngineConfig, TorchEngine
        from repro_torch.engine.kv_cache import pool_for_model
        from repro_torch.launch.serve import profile_engine, train_predictor

        self.cell, self.device = cell, torch.device(device)
        cfg, sv, tr = cell.config, cell.config["serving"], cell.traffic
        self.model = cells.model_module(cfg, cell.root)
        self.mcfg = self.model.program_config(cfg)
        marks = [("start", time.perf_counter())]
        if self.device.type == "cuda":
            from repro_torch.kernels import native
            native.build_all()
        marks.append(("kernels built or loaded", time.perf_counter()))
        self.draws = self.model.draws(cfg, self.mcfg)
        self.stacks = weights.make_stacks(self.draws, seed, self.device)
        self.sync()
        marks.append(("weights drawn", time.perf_counter()))
        self.ecfg = EngineConfig(
            n_slots=sv["n_slots"], max_context=tr["max_context"],
            chunk_buckets=tuple(sv["chunk_buckets"]), paged_kv=True,
            kv_layout=sv["kv_layout"], pipelined=True,
            preemption_mode=sv["preemption_mode"])
        self.engine = TorchEngine(self.mcfg, self.ecfg,
                                  params=self.model.as_params(self.mcfg, self.stacks),
                                  device=self.device)
        bs = 16
        self.pool = pool_for_model(
            self.mcfg, block_size=bs,
            n_blocks=sv["n_slots"] * (math.ceil(tr["max_context"] / bs) + 1),
            enable_prefix_cache=sv["prefix_cache"])
        self.engine.bind_kv_pool(self.pool)
        self.engine.warmup()
        marks.append(("engine built, graphs captured", time.perf_counter()))
        feats, lats = profile_engine(self.mcfg, self.engine, kv_pool=self.pool)
        marks.append(("LPRS profile served", time.perf_counter()))
        self.predictor = train_predictor(feats, lats)
        self.target_ms = float(np.percentile(lats, sv["lprs_target_percentile"]))
        marks.append(("predictor trained", time.perf_counter()))
        log("set-up: " + ", ".join(f"{name} {b - a:.2f} s" for (_, a), (name, b)
                                   in zip(marks, marks[1:]))
            + f"; LPRS target {self.target_ms:.3f} ms over {len(lats)} rounds",
            file=sys.stderr)

    def scheduler(self):
        from repro_torch.core.apc import APCConfig
        from repro_torch.core.lprs import LPRSConfig
        from repro_torch.core.scheduler import ChunkedPrefillScheduler, SchedulerConfig

        sv = self.cell.config["serving"]
        return ChunkedPrefillScheduler(
            SchedulerConfig(
                policy=sv["policy"], alpha=sv["aging_alpha"],
                beta=sv["aging_beta"], token_budget=sv["token_budget"],
                max_seqs=sv["n_slots"],
                lprs=LPRSConfig(target_latency_ms=self.target_ms,
                                search_delta=sv["lprs_search_delta"]),
                apc=APCConfig(c_max=sv["apc_c_max"], l_min=sv["apc_l_min"])),
            predictor=self.predictor)

    def server(self, sched):
        from repro_torch.engine.engine import ReplicaServer
        return ReplicaServer(sched, self.engine, kv_pool=self.pool)

    def requests(self, rate: float, seconds: float, seed: int,
                 schedule_seed=None):
        from repro_torch.core.request import Request

        items = traffic_gen.generate(self.cell.traffic, rate, seconds, seed,
                                     self.mcfg.vocab_size, schedule_seed)
        reqs = [Request(prompt_len=len(it.prompt),
                        max_new_tokens=it.max_new_tokens,
                        arrival_time=it.due_s, prompt_tokens=list(it.prompt))
                for it in items]
        prompts = {r.req_id: list(it.prompt) for r, it in zip(reqs, items)}
        return reqs, prompts

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _served(reqs):
    return [endtoend.Served(due=r.arrival_time, max_new_tokens=r.max_new_tokens,
                            stamps=list(r.token_times)) for r in reqs]


def _card(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", tamper=None, log=print,
             schedule_seed=None, dump=None) -> dict:
    """One run: set-up, lead-in, window, checks.  Returns the result's
    fields.  ``tamper(stack)``, for the fault tests, plants a fault in the
    program after set-up; ``schedule_seed`` serves a held-out schedule."""
    stack = Stack(cell, seed, device, log)
    if tamper is not None:
        tamper(stack)
    sched = stack.scheduler()
    server = stack.server(sched)
    rate = float(cell.params["rate_per_s"])
    reqs, prompts = stack.requests(rate, seconds, seed, schedule_seed)
    lead = float(cell.traffic["lead_in_s"])
    t0, t1 = lead, lead + seconds
    state: dict = {}
    prof = traced = off = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if stack.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        # CUPTI starts up here, in set-up, not inside the window
        with profile(activities=acts):
            torch.ones(1, device=stack.device).add_(1)
            stack.sync()
        prof = profile(activities=acts)
        window_span = record_function("bench.window")
        events = [] if stack.device.type == "cuda" else None
        off = loop.Probe(events=events)
        traced = loop.Probe(events=None if events is None else [])

        def open_segment(name, probe):
            stack.sync()
            state[name] = {"c0": loop.counters(sched, stack.engine),
                           "lo": time.perf_counter() - t_serve}
            probe.attach(sched, stack.engine)

        def close_segment(name, probe):
            stack.sync()
            probe.detach()
            state[name].update(c1=loop.counters(sched, stack.engine),
                               hi=time.perf_counter() - t_serve)

        def start_trace():
            open_segment("traced", traced)
            traced.annotate = True
            window_span.__enter__()

        def stop_trace():
            close_segment("traced", traced)
            window_span.__exit__(None, None, None)
            traced.annotate = False
            prof.stop()

        # Two segments of the window: ``off`` with the profiler off, which
        # the host-side metrics read (the profiler's own host cost would be
        # in them), then the traced one, a second after the profiler
        # starts, which the device's times come from.  The graphs' CUDA
        # events in both show what the profiler costs the device.
        seg = min(TRACE_S, max(0.0, seconds - SETTLE_S) / 2.5)
        lo = t0 + seg + SETTLE_S
        marks = [(t0, lambda: open_segment("off", off)),
                 (t0 + seg, lambda: (close_segment("off", off), prof.start())),
                 (lo, start_trace), (lo + seg, stop_trace)]
    else:
        marks = []
    t_serve = time.perf_counter()
    # process start to the window's start (the lead-in included)
    setup_s = process_age_s() + t0
    submitted = loop.serve_window(server, reqs, t_serve, t1, marks, traced)
    device_info = _card(stack.device)

    window = [r for r in reqs if t0 <= r.arrival_time < t1]
    attempted = len(window)
    failed = sum(1 for r in window if r.shed_reason is not None)
    result: dict = {"attempted": attempted, "failed": failed}
    if not trace:
        e2e = endtoend.compute(_served(reqs), t0, t1)
        e2e["setup_s"] = setup_s
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        result["metrics"] = {k: {"value": e2e[k], "unit": units[k]}
                             for k in units}
        log(f"samples: {endtoend.sample_counts(_served(reqs), t0, t1)}",
            file=sys.stderr)
        itl = endtoend.itl_samples(_served(reqs), t0, t1)
        log("itl ms: " + " ".join(
            f"p{q} {endtoend.percentile(itl, q) * 1e3:.4f}"
            for q in (50, 75, 90, 93, 95, 97, 99)), file=sys.stderr)
        if dump:
            with open(dump, "w") as f:
                json.dump({"t0": t0, "t1": t1,
                           "reqs": [[r.arrival_time, r.max_new_tokens,
                                     list(r.token_times)] for r in reqs]}, f)
    else:
        tr = trace_read.from_profiler(prof)
        busy = trace_read.busy_s(tr)

        def segment(name, probe):
            c0, c1, lo, hi = (state[name][k] for k in ("c0", "c1", "lo", "hi"))
            return SimpleNamespace(
                window_s=hi - lo, rounds=probe.rounds, sched_s=probe.sched_s,
                scheduled_tokens=c1["scheduled_tokens"] - c0["scheduled_tokens"],
                bucket_rounds={C: n - c0["bucket_rounds"].get(C, 0)
                               for C, n in c1["bucket_rounds"].items()},
                bubble_ms=list(stack.engine.bubble_ms[c0["bubbles"]:c1["bubbles"]]),
                gen_lag_s=[submitted[r.req_id] - r.arrival_time for r in reqs
                           if lo <= r.arrival_time < hi and r.req_id in submitted],
                busy_s=(None if probe.events is None
                        else probe.events_busy_s()))
        # what a per-layer metric's reader may read (bench/metrics/): the
        # traced segment's trace and rounds, and each segment's records
        ctx = SimpleNamespace(
            config=cell.config, n_slots=stack.ecfg.n_slots, trace=tr,
            window_s=tr.window_s, busy_s=busy, rounds=traced.rounds,
            off=segment("off", off), traced=segment("traced", traced),
            flops=flops_model.Yardstick(cell.root), peaks=peaks,
            trace_read=trace_read,
            log=lambda *a: log(*a, file=sys.stderr))
        metrics = {}
        for m in cell.per_layer:
            v = cells.metric_reader(m["name"], cell.root).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
        device_info.update(busy_s=busy, window_s=tr.window_s)
        for name, sec in trace_read.top_ops(tr, 40):
            log(f"device op {sec:.6f} s  {name}", file=sys.stderr)
        result["breakdown"] = {"device_ops": trace_read.top_ops(tr),
                               "idle_gaps": trace_read.idle_gaps(tr)}
        log(profiler_cost(ctx), file=sys.stderr)
    result["device"] = device_info

    # the program's state goes before the reference runs; the weights are
    # the benchmark's
    done = compare.from_requests(reqs, prompts, server.outputs)
    del server, sched, traced, off, prof, state
    stack.engine = stack.pool = stack.predictor = None
    gc.collect()
    if stack.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = cells.reference_module(cell.config, cell.root)
    checks = compare.checks(ref, cell.config, stack.stacks, done, seed)
    result["correct"] = compare.passed(checks)
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package loaded: {found}")
    return result


def profiler_cost(ctx) -> str:
    """What the profiler costs the loop: the two segments side by side."""
    def idle(seg):
        return ("n/a" if seg.busy_s is None
                else f"{100 * (1 - seg.busy_s / seg.window_s):.2f}%")

    def per_round(xs):
        return f"{1e3 * sum(xs) / len(xs):.3f}" if xs else "n/a"
    off, on = ctx.off, ctx.traced
    return (f"profiler cost: device idle {100 * (1 - ctx.busy_s / ctx.window_s):.2f}% "
            f"by the trace, {idle(on)} by the graphs' CUDA events in the same "
            f"segment, {idle(off)} with the profiler off; rounds "
            f"{len(on.rounds)} in {on.window_s:.3f} s traced, {len(off.rounds)} "
            f"in {off.window_s:.3f} s off; schedule() {per_round(on.sched_s)} / "
            f"{per_round(off.sched_s)} ms")


def result_line(result: dict) -> str:
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if "breakdown" in result:
        keys.append("breakdown")
    keys.append("checks")
    return json.dumps({k: result[k] for k in keys})


def sweep(cell: cells.Cell, seed: int, seconds: float, rates, device="cuda"):
    """The rate sweep: one set-up, then the cell's traffic at each rate in
    turn, each run drained before the next.  Prints a JSON line per rate:
    the end-to-end metrics and the requests outstanding (submitted, not
    finished) at each second of the window."""
    stack = Stack(cell, seed, device)
    lead = float(cell.traffic["lead_in_s"])
    for rate in rates:
        sched = stack.scheduler()
        server = stack.server(sched)
        reqs, _ = stack.requests(rate, seconds, seed)
        t0, t1 = lead, lead + seconds
        backlog = []

        def sample(reqs=reqs, server=server, backlog=backlog):
            backlog.append(sum(1 for r in reqs
                               if r.arrival_time <= time.perf_counter() - server.t_start
                               and r.state.value != "finished"))

        marks = [(t0 + k, sample) for k in range(int(seconds) + 1)]
        t_serve = time.perf_counter()
        loop.serve_window(server, reqs, t_serve, t1, marks)
        e2e = endtoend.compute(_served(reqs), t0, t1)
        print(json.dumps({"rate_per_s": rate, **e2e, "backlog": backlog,
                          "samples": endtoend.sample_counts(_served(reqs), t0, t1)}),
              flush=True)
        loop.drain_all(server)
        del server, sched
        gc.collect()


def readings(cell: cells.Cell, seeds, seconds: float, control: bool,
             device="cuda"):
    """Sound runs on many seeds in one process: each seed draws new weights
    into the same tensors and serves its own traffic at the cell's rate;
    prints the checks (and the float8 control's reading) per seed."""
    stack = Stack(cell, seeds[0], device)
    ref = cells.reference_module(cell.config, cell.root)
    lead = float(cell.traffic["lead_in_s"])
    rate = float(cell.params["rate_per_s"])
    for seed in seeds:
        weights.make_stacks(stack.draws, seed, stack.device, out=stack.stacks)
        sched = stack.scheduler()
        server = stack.server(sched)
        reqs, prompts = stack.requests(rate, seconds, seed)
        loop.serve_window(server, reqs, time.perf_counter(), lead + seconds)
        done = compare.from_requests(reqs, prompts, server.outputs)
        e2e = endtoend.compute(_served(reqs), lead, lead + seconds)
        loop.drain_all(server)
        del server, sched
        gc.collect()
        ch = compare.checks(ref, cell.config, stack.stacks, done, seed, control)
        print(json.dumps({"seed": seed, "correct": compare.passed(ch),
                          "checks": ch, **e2e}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--sweep", default=None,
                    help="comma-separated rates (req/s): the rate sweep")
    ap.add_argument("--readings", default=None,
                    help="comma-separated seeds: checks on each, one set-up")
    ap.add_argument("--control", action="store_true",
                    help="with --readings: the float8 control's reading too")
    ap.add_argument("--schedule-seed", type=int, default=None,
                    help="a held-out schedule: due times and sizes drawn from "
                         "this seed, not the traffic file's base_seed")
    ap.add_argument("--dump", default=None,
                    help="with --trace 0: write each request's due time, "
                         "length and token stamps to this JSON file")
    args = ap.parse_args(argv)

    cell = cells.find_cell(args.workload)
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{n_cards} found", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    print(f"card: {_power_limit()}", file=sys.stderr)
    if args.sweep:
        sweep(cell, args.seed, args.seconds,
              [float(r) for r in args.sweep.split(",")])
        return 0
    if args.readings:
        readings(cell, [int(s) for s in args.readings.split(",")],
                 args.seconds, args.control)
        return 0
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      schedule_seed=args.schedule_seed, dump=args.dump)
    print(result_line(result), flush=True)
    for line in compare.describe(result["checks"]):
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
