"""The port's spans (``repro_torch.tracing``) through ``serve()`` on the CPU
at the tiny size: a tracer that is off records nothing and changes no
output; spans nest as the loop nests; the rounds' attributes add up to the
engine's and the scheduler's own counters; each request's queue wait opens
at its submit and ends before its first token; anchors put program spans on
``torch.profiler``'s clock; ``launch.serve --spans`` writes a Chrome trace;
the keys each kind of layer reads (known lengths) and the choices of
experts not held here (a known routing) reach the spans and the summary.
"""
import json
import time

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import tiny_config
from repro_torch.core.apc import APCConfig
from repro_torch.core.lprs import LPRSConfig
from repro_torch.core.predictor import AnalyticPredictor
from repro_torch.core.scheduler import ChunkedPrefillScheduler, SchedulerConfig
from repro_torch.engine.engine import EngineConfig, ReplicaServer, TorchEngine, serve
from repro_torch.engine.workload import WorkloadSpec, attach_prompt_tokens, sharegpt_like
from repro_torch.launch import serve as serve_cli

WORKLOAD = dict(n_requests=8, inter_arrival_s=0.005, max_context=120,
                max_new_tokens=6, seed=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engine():
    cfg = tiny_config("qwen1.5-0.5b").with_(param_dtype="float32")
    return TorchEngine(cfg, EngineConfig(n_slots=4, max_context=256,
                                         chunk_buckets=(1, 16, 32, 64)),
                       device="cpu")


def _scheduler():
    """Aging with LPRS (an analytic predictor, T* 3 ms: chunks of about 25
    tokens) and APC, whose gate shrinks some of LPRS's chunks."""
    return ChunkedPrefillScheduler(
        SchedulerConfig(policy="aging", token_budget=48, max_seqs=4,
                        lprs=LPRSConfig(target_latency_ms=3.0, search_delta=8),
                        apc=APCConfig(c_max=2, l_min=16)),
        predictor=AnalyticPredictor())


def _serve(engine, tracer=None):
    reqs = sharegpt_like(WorkloadSpec(**WORKLOAD))
    attach_prompt_tokens(reqs, engine.model_cfg.vocab_size)
    sched = _scheduler()
    res = serve(reqs, sched, engine, tracer=tracer)
    assert res.report.n_finished == len(reqs)
    return res, reqs, sched


@pytest.fixture(scope="module")
def traced(engine):
    """One traced serve: (spans, requests, scheduler, bucket rounds, the
    batches schedule() returned)."""
    engine.bucket_rounds.clear()
    tracer = tracing.Tracer()
    batches = []
    orig = ChunkedPrefillScheduler.schedule

    def schedule(self, now):
        batches.append(orig(self, now))
        return batches[-1]

    ChunkedPrefillScheduler.schedule = schedule
    try:
        _res, reqs, sched = _serve(engine, tracer)
    finally:
        ChunkedPrefillScheduler.schedule = orig
    return tracer.spans(), reqs, sched, dict(engine.bucket_rounds), batches


def test_off_records_nothing_and_outputs_match_on(engine):
    off = tracing.Tracer(on=False)
    res_off, reqs_off, _ = _serve(engine, off)
    _, _, sched = _serve(engine)
    assert sched.tracer is tracing.OFF and engine.tracer is tracing.OFF
    tracer = tracing.Tracer()
    res_on, reqs_on, _ = _serve(engine, tracer)
    assert off.spans() == [] and tracing.OFF.spans() == []
    assert tracer.spans()
    assert ([res_off.outputs[r.req_id] for r in reqs_off]
            == [res_on.outputs[r.req_id] for r in reqs_on])


def _inside(s, parent):
    return parent.t0 <= s.t0 and s.t1 <= parent.t1


def test_spans_nest(traced):
    spans = traced[0]
    assert all(s.t1 >= s.t0 > 0 for s in spans), "a span left open"
    names = {s.name for s in spans}
    assert {"serve.step", "sched.schedule", "sched.lprs", "sched.on_batch_done",
            "engine.dispatch", "engine.stage", "engine.upload", "engine.replay",
            "engine.drain", "engine.drain.wait", "serve.deliver",
            "req.queue"} <= names
    want = {"sched.lprs": "sched.schedule", "sched.schedule": "serve.step",
            "engine.drain.wait": "engine.drain", "engine.stage": "engine.dispatch",
            "engine.upload": "engine.dispatch", "engine.replay": "engine.dispatch",
            "engine.dispatch": "serve.step", "engine.drain": "serve.step",
            "serve.deliver": "serve.step", "sched.on_batch_done": "serve.step"}
    for s in spans:
        if s.name in want:
            parent = spans[s.parent]
            assert parent.name == want[s.name], (s, parent)
            assert _inside(s, parent), (s, parent)
    steps = [s for s in spans if s.name == "serve.step"]
    assert all(s.parent == -1 for s in steps)
    assert {s.attrs["status"] for s in steps} <= {"round", "drained", "starved"}


def test_round_attributes_add_up_to_the_counters(traced):
    spans, _reqs, sched, bucket_rounds, batches = traced
    dispatch = [s for s in spans if s.name == "engine.dispatch"]
    by_bucket = {}
    for s in dispatch:
        by_bucket[s.attrs["C"]] = by_bucket.get(s.attrs["C"], 0) + 1
    assert by_bucket == bucket_rounds
    st = sched.stats
    assert sum(s.attrs["prefill_tokens"] for s in dispatch) == st.scheduled_prefill_tokens
    assert sum(s.attrs["decode_tokens"] for s in dispatch) == st.scheduled_decode_tokens
    scheduled = [s for s in spans if s.name == "sched.schedule"]
    assert (sum(s.attrs["prefill_tokens"] + s.attrs["decode_tokens"] for s in scheduled)
            == st.scheduled_prefill_tokens + st.scheduled_decode_tokens)
    # each round's drain is the round dispatched under the same index
    drains = {s.attrs["round"]: s for s in spans if s.name == "engine.drain"}
    assert set(drains) == {s.attrs["round"] for s in dispatch}
    assert all(d.attrs["wall_ms"] > 0 for d in drains.values())
    # the round's prediction is the predictor's reading of the state it
    # dispatched, whether LPRS's chunk survived the gates or not
    pred = AnalyticPredictor()
    lprs = [s for s in scheduled if s.attrs.get("lprs_chunks")]
    assert lprs and all(s.attrs["target_ms"] == 3.0 for s in lprs)
    batch = {b.round_idx: b for b in batches}
    for s in lprs:
        want = pred.predict(batch[s.attrs["round"]].state.features()[None])[0]
        assert s.attrs["pred_ms"] == pytest.approx(want, abs=1e-9)
    searches = [s for s in spans if s.name == "sched.lprs"]
    assert sum(s.attrs["chunk"] > 0 for s in searches) >= sum(
        s.attrs["lprs_chunks"] for s in lprs)


def test_queue_wait_opens_at_submit_and_ends_before_the_first_token(engine, monkeypatch):
    submits, starts = {}, []
    orig_submit, orig_start = ReplicaServer.submit, ReplicaServer.start

    def submit(self, req):
        a = time.perf_counter_ns()
        orig_submit(self, req)
        submits[req.req_id] = (a, time.perf_counter_ns())

    def start(self, t_start):
        starts.append(t_start)
        orig_start(self, t_start)

    monkeypatch.setattr(ReplicaServer, "submit", submit)
    monkeypatch.setattr(ReplicaServer, "start", start)
    tracer = tracing.Tracer()
    _res, reqs, _ = _serve(engine, tracer)
    first = {}
    for s in tracer.spans():
        if s.name == tracing.QUEUE and not s.attrs["requeue"]:
            assert s.attrs["req_id"] not in first
            first[s.attrs["req_id"]] = s
    assert set(first) == {r.req_id for r in reqs}
    for r in reqs:
        s, (a, b) = first[r.req_id], submits[r.req_id]
        assert a <= s.t0 <= b
        assert s.t1 <= (starts[0] + r.token_times[0]) * 1e9


def test_anchors_put_spans_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    tracer = tracing.Tracer()
    probes = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracer.anchor()
        for k in range(5):
            time.sleep(0.01)
            i = tracer.open("probe")
            with record_function("probe"):
                pass
            tracer.close(i)
            probes.append(i)
        time.sleep(0.01)
        tracer.anchor()
    events = [e for e in prof.profiler.kineto_results.events()]
    anchors = sorted(e.end_ns() for e in events if e.name() == "repro.anchor")
    rf = sorted((e.start_ns(), e.end_ns()) for e in events if e.name() == "probe")
    assert len(anchors) == 2 and len(rf) == len(probes)
    to_trace = tracing.clock(tracer.anchors, anchors)
    spans = tracer.spans()
    err_us = [max(abs(to_trace(spans[i].t0) - a), abs(to_trace(spans[i].t1) - b)) / 1e3
              for i, (a, b) in zip(probes, rf)]
    assert float(np.median(err_us)) < 200, err_us


@pytest.mark.parametrize("profiled", [False, True])
def test_serve_cli_writes_chrome_trace_spans(tmp_path, capsys, profiled):
    path = tmp_path / "spans.json"
    argv = ["--device", "cpu", "--n-requests", "4", "--spans", str(path)]
    if profiled:
        argv += ["--profile", str(tmp_path / "trace.json")]
    serve_cli.main(argv)
    events = json.loads(path.read_text())["traceEvents"]
    complete = [e for e in events if e["ph"] == "X"]
    assert complete and all(e["dur"] >= 0 and isinstance(e["ts"], float)
                            and {"name", "pid", "tid", "args"} <= set(e)
                            for e in complete)
    begins = sorted(e["id"] for e in events if e["ph"] == "b")
    assert begins == sorted(e["id"] for e in events if e["ph"] == "e")
    assert len(begins) == 4
    out = capsys.readouterr().out
    for line in ("self ms per round", "device ms per round by bucket",
                 "queue wait: p50", "LPRS rounds over T*"):
        assert line in out
    if profiled:
        trace = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
        # on the profiler's clock: each eager step's ops start inside its
        # engine.replay span
        ops = np.sort([e["ts"] for e in trace
                       if e.get("ph") == "X" and e.get("cat") == "cpu_op"])
        replays = [e for e in trace if e.get("name") == "engine.replay"]
        assert replays
        for e in replays:
            i = np.searchsorted(ops, e["ts"])
            assert i < len(ops) and ops[i] <= e["ts"] + e["dur"], e


def test_moe_counts_per_round_add_up():
    """A traced serve of tiny arctic (dropless at its capacity factor 8.0):
    each drain span carries the round's experts read and expert rows, the
    rows are the round's real tokens x top-k x layers, and the summary
    reports both by bucket; a model without experts carries neither."""
    cfg = tiny_config("arctic-480b").with_(param_dtype="float32")
    eng = TorchEngine(cfg, EngineConfig(n_slots=4, max_context=256,
                                        chunk_buckets=(1, 16, 32, 64)),
                      device="cpu")
    tracer = tracing.Tracer()
    _serve(eng, tracer)
    spans = tracer.spans()
    dispatch = {s.attrs["round"]: s.attrs for s in spans
                if s.name == "engine.dispatch"}
    drains = [s.attrs for s in spans if s.name == "engine.drain"]
    assert drains and all("expert_rows" in d for d in drains)
    per = cfg.moe.top_k * cfg.n_layers
    for s in spans:
        if s.name == "engine.drain":
            a = dispatch[s.attrs["round"]]
            tokens = a["prefill_tokens"] + a["decode_tokens"]
            assert s.attrs["expert_rows"] == tokens * per
            assert 0 < s.attrs["experts_read"] <= cfg.moe.n_experts * cfg.n_layers
    assert any(line.startswith("MoE per round by bucket")
               for line in tracing.summary(spans))


def test_dense_model_has_no_moe_counts(traced):
    spans = traced[0]
    assert not any("expert_rows" in s.attrs for s in spans)
    assert not any(line.startswith("MoE") for line in tracing.summary(spans))


def _layered(**kw):
    """Tiny qwen1.5-0.5b's sizes as a ``LayeredModelConfig`` (float32)."""
    import dataclasses
    from repro_torch.configs.base import LayeredModelConfig
    cfg = tiny_config("qwen1.5-0.5b").with_(param_dtype="float32")
    return LayeredModelConfig(**{**{f.name: getattr(cfg, f.name)
                                    for f in dataclasses.fields(cfg)}, **kw})


def test_dispatch_counts_the_keys_each_kind_of_layer_reads():
    """Known lengths: a decode at 9 keys cached, a chunk of 6 from 0 and one
    of 3 from 2, under windows (3, 0, 3, 0): each sliding layer reads
    min(c + n, W + n - 1) keys a row (3 + 6 + 5), each global one c + n (10
    + 6 + 5); a traced serve puts the counts on every dispatch span and the
    summary reports the share the windows skip."""
    from types import SimpleNamespace as NS
    cfg = _layered(layer_windows=(3, 0, 3, 0))
    assert cfg.n_layers == 4
    eng = TorchEngine(cfg, EngineConfig(n_slots=4, max_context=256,
                                        chunk_buckets=(1, 16, 32, 64)),
                      device="cpu")
    batch = NS(decode_reqs=[NS(context_len=10)],
               prefill_chunks=[(NS(prefill_done=0), 6), (NS(prefill_done=2), 3)])
    assert eng._keys_read(batch) == {"window_keys": 2 * 14, "full_keys": 2 * 21,
                                     "window_context_keys": 2 * 21}
    tracer = tracing.Tracer()
    _serve(eng, tracer)
    spans = [s.attrs for s in tracer.spans() if s.name == "engine.dispatch"]
    assert spans and all(a["full_keys"] == a["window_context_keys"]
                         >= a["window_keys"] > 0 for a in spans)
    assert any(a["window_keys"] < a["window_context_keys"] for a in spans)
    assert any(line.startswith("sliding-window layers read")
               for line in tracing.summary(tracer.spans()))


def test_absent_choices_are_counted_on_a_known_routing():
    """8 experts top-2 of which 0-3 are held; a selection bias of 10 on
    experts 0 and 5 makes every token choose both: per real token and
    sparse layer one row computed (expert 0, the only one read) and one
    choice absent, on each drain span and in the summary's share (50%)."""
    import dataclasses
    from repro_torch.configs.base import RoutedMoEConfig
    moe = RoutedMoEConfig(n_experts=8, top_k=2, d_ff=32, capacity_factor=4.0,
                          scoring="sigmoid", n_held=4)
    cfg = _layered(family="moe", moe=moe, moe_impl="scatter",
                   layer_sparse=(False, True, True, True))
    eng = TorchEngine(cfg, EngineConfig(n_slots=4, max_context=256,
                                        chunk_buckets=(1, 16, 32, 64)),
                      device="cpu")
    for lp in eng.params["layers"][1:]:
        lp["moe"]["router_bias"][[0, 5]] = 10.0
    tracer = tracing.Tracer()
    _serve(eng, tracer)
    spans = tracer.spans()
    dispatch = {s.attrs["round"]: s.attrs for s in spans
                if s.name == "engine.dispatch"}
    drains = [s for s in spans if s.name == "engine.drain"]
    assert drains
    for s in drains:
        a = dispatch[s.attrs["round"]]
        tokens = a["prefill_tokens"] + a["decode_tokens"]
        assert s.attrs["expert_rows"] == s.attrs["absent_choices"] == 3 * tokens
        assert s.attrs["experts_read"] == 3
    assert any("not held here" in line and "(50.0%)" in line
               for line in tracing.summary(spans))
