"""The port's copies of the paper's scheduling drivers -- the discrete-event
simulator (``repro_torch.engine.simulator``), the multi-replica router
(``repro_torch.engine.router``) and the unified adaptive controller
(``repro_torch.core.adaptive``) -- against the JAX package's, and the torch
examples.

(a) Mirrors of tests/test_adaptive.py (4 tests), the router tests of
    tests/test_distributed.py (:195-247), test_failover.py's
    ``test_sim_router_max_retries_sheds`` and test_tenancy.py's
    ``test_router_tenant_aware_completes_and_accounts``, on the port's
    modules.
(b) Parity: on the same seeds, the port's ``run_policy`` /
    ``ServingSimulator``, ``Router`` and ``AdaptiveController`` give the
    reference's metric rows, per-request timestamps, scheduler counters,
    events and journal states EXACTLY (fcfs, sjf, aging, aging + LPRS +
    APC, a multi-tenant mix, a KV pool under pressure).  Request ids come
    from a counter per package, so both sides renumber their workload
    0..N-1 first.
(c) Each torch example's ``main(["--device", "cpu"])`` finishes every
    request (exit code 0).
"""
import dataclasses
import enum
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core.adaptive as j_adaptive
import repro.core.apc as j_apc
import repro.core.lprs as j_lprs
import repro.core.predictor as j_predictor
import repro.core.scheduler as j_scheduler
import repro.engine.costmodel as j_costmodel
import repro.engine.kv_cache as j_kv
import repro.engine.router as j_router
import repro.engine.simulator as j_simulator
import repro.engine.workload as j_workload
import repro.tenancy as j_tenancy
import repro_torch.core.adaptive as t_adaptive
import repro_torch.core.apc as t_apc
import repro_torch.core.lprs as t_lprs
import repro_torch.core.predictor as t_predictor
import repro_torch.core.scheduler as t_scheduler
import repro_torch.engine.costmodel as t_costmodel
import repro_torch.engine.kv_cache as t_kv
import repro_torch.engine.router as t_router
import repro_torch.engine.simulator as t_simulator
import repro_torch.engine.workload as t_workload
import repro_torch.tenancy as t_tenancy
from repro_torch.core.adaptive import AdaptiveConfig, AdaptiveController
from repro_torch.core.apc import APCConfig
from repro_torch.core.lprs import LPRSConfig
from repro_torch.core.predictor import AnalyticPredictor
from repro_torch.core.request import Request, RequestState
from repro_torch.core.scheduler import ChunkedPrefillScheduler, SchedulerConfig
from repro_torch.engine.router import Router, RouterConfig
from repro_torch.engine.workload import WorkloadSpec, multi_tenant, sharegpt_like

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The examples' tiny engines run as fast on one intra-op thread, and
    several test workers sharing the CPU do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a) mirrors: the adaptive controller (tests/test_adaptive.py)
# ---------------------------------------------------------------------------


def mk_sched(**kw):
    pred = AnalyticPredictor()
    return ChunkedPrefillScheduler(
        SchedulerConfig(
            policy="aging", alpha=1.0, beta=-0.1, token_budget=512,
            max_seqs=32, lprs=LPRSConfig(target_latency_ms=50.0),
            apc=APCConfig(c_max=4, l_min=64), **kw,
        ),
        predictor=pred,
    )


def test_target_tracks_observed_latency():
    sched = mk_sched()
    ctl = AdaptiveController(sched, AdaptiveConfig(adjust_every=10))
    sched.submit(Request(prompt_len=5000, max_new_tokens=2, arrival_time=0.0))
    for i in range(30):
        b = sched.schedule(float(i))
        if b.is_empty():
            sched.submit(Request(prompt_len=5000, max_new_tokens=2,
                                 arrival_time=float(i)))
            continue
        ctl.observe(b, latency_ms=200.0, now=float(i))  # rounds run at 200ms
        sched.on_batch_done(b, float(i))
    # T* moved from 50 toward the observed 200 ms
    assert sched.cfg.lprs.target_latency_ms > 50.0


def test_starvation_raises_wait_weight():
    sched = mk_sched()
    ctl = AdaptiveController(sched, AdaptiveConfig(
        adjust_every=5, starvation_bound_s=1.0,
    ))
    ratio0 = sched.cfg.alpha / abs(sched.cfg.beta)
    # one ancient request stuck in the queue
    sched.submit(Request(prompt_len=100_000, max_new_tokens=1, arrival_time=0.0))
    for i in range(10):
        b = sched.schedule(100.0 + i)
        ctl.observe(b, latency_ms=10.0, now=100.0 + i)
        sched.on_batch_done(b, 100.0 + i)
        sched.submit(Request(prompt_len=100_000, max_new_tokens=1,
                             arrival_time=100.0 + i))
    ratio1 = sched.cfg.alpha / abs(sched.cfg.beta)
    assert ratio1 > ratio0


def test_rekey_preserves_queue_membership():
    sched = mk_sched()
    ctl = AdaptiveController(sched)
    reqs = [Request(prompt_len=p, max_new_tokens=1, arrival_time=0.0)
            for p in (10, 2000, 300)]
    for r in reqs:
        sched.submit(r)
    ctl._rekey_queue()
    ids = {r.req_id for r in sched.queue.requests()}
    assert ids == {r.req_id for r in reqs}


def _adaptive_workload(wl):
    a = wl.sharegpt_like(wl.WorkloadSpec(n_requests=60, inter_arrival_s=0.02,
                                         max_context=64, seed=1))
    b = wl.sharegpt_like(wl.WorkloadSpec(n_requests=60, inter_arrival_s=0.05,
                                         max_context=512, seed=2))
    for r in b:
        r.arrival_time += 1.5
    return _renumber(a + b)


def _adaptive_run(pkg, adaptive: bool):
    """tests/test_adaptive.py's phase-shifting run in package ``pkg``
    (the reference's or the port's modules), the controller wired through
    the simulator loop as that test wires it."""
    sched = pkg["scheduler"].ChunkedPrefillScheduler(
        pkg["scheduler"].SchedulerConfig(
            policy="aging", alpha=1.0, beta=-0.1, token_budget=512,
            max_seqs=32, lprs=pkg["lprs"].LPRSConfig(target_latency_ms=50.0),
            apc=pkg["apc"].APCConfig(c_max=4, l_min=64)),
        predictor=pkg["predictor"].AnalyticPredictor())
    sim = pkg["simulator"].ServingSimulator(
        sched, pkg["costmodel"].CostModel(
            pkg["costmodel"].CostModelConfig(noise_std=0.0)))
    ctl = None
    if adaptive:
        ctl = pkg["adaptive"].AdaptiveController(
            sched, pkg["adaptive"].AdaptiveConfig(adjust_every=20))
        orig = sim.sched.on_batch_done

        def hooked(batch, now, _o=orig, _c=ctl):
            _c.observe(batch, _c._last_lat, now)
            _o(batch, now)

        orig_cost = sim.cost.batch_latency_ms

        def cost_hook(batch, **kw):
            ms = orig_cost(batch, **kw)
            ctl._last_lat = ms
            return ms

        sim.cost.batch_latency_ms = cost_hook
        sim.sched.on_batch_done = hooked
    res = sim.run(_adaptive_workload(pkg["workload"]))
    return res, sched, ctl


def test_adaptive_end_to_end_no_regression():
    """Adaptive controller on a phase-shifting workload completes everything
    and does not blow up latency vs the static scheduler."""
    static, _, _ = _adaptive_run(T, adaptive=False)
    adaptive, _, _ = _adaptive_run(T, adaptive=True)
    assert static.report.n_finished == adaptive.report.n_finished == 120
    assert adaptive.report.e2e["mean"] <= static.report.e2e["mean"] * 1.25


# ---------------------------------------------------------------------------
# (a) mirrors: the router (tests/test_distributed.py, test_failover.py,
# test_tenancy.py)
# ---------------------------------------------------------------------------


def test_router_failover_completes_all():
    r = Router(RouterConfig(
        scheduler=SchedulerConfig(policy="aging", token_budget=256, max_seqs=32)
    ), n_replicas=3)
    reqs = sharegpt_like(WorkloadSpec(n_requests=40, inter_arrival_s=0.05, seed=2))
    r.run(reqs, fault_at={1.0: lambda rt: rt.kill_replica(0)})
    fin = sum(1 for q in r.journal.values() if q.state.value == "finished")
    assert fin == 40
    assert any("DIED" in e for e in r.events)


def test_router_elastic_add_remove():
    r = Router(RouterConfig(
        scheduler=SchedulerConfig(policy="fcfs", token_budget=256, max_seqs=32)
    ), n_replicas=2)
    reqs = sharegpt_like(WorkloadSpec(n_requests=30, inter_arrival_s=0.05, seed=3))
    r.run(reqs, fault_at={
        0.5: lambda rt: rt.add_replica(),
        1.5: lambda rt: rt.remove_replica(1),
    })
    fin = sum(1 for q in r.journal.values() if q.state.value == "finished")
    assert fin == 30


def test_router_straggler_detection():
    r = Router(RouterConfig(
        straggler_factor=0.5, straggler_window=1.0,
        scheduler=SchedulerConfig(policy="fcfs", token_budget=256, max_seqs=32),
    ), n_replicas=1)
    r.add_replica(speed=0.05)          # 20x slower replica
    reqs = sharegpt_like(WorkloadSpec(n_requests=60, inter_arrival_s=0.02, seed=4))
    r.run(reqs)
    fin = sum(1 for q in r.journal.values() if q.state.value == "finished")
    assert fin == 60
    assert any("STRAGGLER" in e for e in r.events)


def test_replay_preserves_seniority():
    """Replayed requests keep their original arrival time -> Aging rank."""
    r = Router(RouterConfig(
        scheduler=SchedulerConfig(policy="aging", token_budget=64, max_seqs=8)
    ), n_replicas=2)
    reqs = sharegpt_like(WorkloadSpec(n_requests=10, inter_arrival_s=0.01, seed=5))
    arrivals = {q.req_id: q.arrival_time for q in reqs}
    r.run(reqs, fault_at={0.05: lambda rt: rt.kill_replica(0)})
    for rid, q in r.journal.items():
        assert q.arrival_time == pytest.approx(arrivals[rid])


def test_sim_router_max_retries_sheds():
    cfg = RouterConfig(scheduler=SchedulerConfig(policy="fcfs",
                                                 token_budget=64),
                       max_retries=1)
    router = Router(cfg, n_replicas=3)
    reqs = [Request(req_id=i, prompt_len=64, max_new_tokens=16,
                    arrival_time=0.0) for i in range(6)]
    # kill two replicas in sequence: every request replays once (allowed),
    # then anything still unfinished on the second dead replica sheds
    router.run(reqs, fault_at={0.05: lambda r: r.kill_replica(0),
                               0.3: lambda r: r.kill_replica(1)})
    assert all(r.state == RequestState.FINISHED
               for r in router.journal.values())
    for r in router.shed_failed:
        assert r.shed_reason == "replica_failure"
    # the replay bound held: nobody exceeded max_retries + 1 placements
    assert all(k <= cfg.max_retries + 1 for k in router._replays.values())


def _fair_router(n_replicas=2, pkg=None):
    pkg = pkg or T
    return pkg["router"].Router(pkg["router"].RouterConfig(
        scheduler=pkg["scheduler"].SchedulerConfig(
            policy="aging", alpha=1.0, beta=-0.1, token_budget=256, max_seqs=32,
            fairness=pkg["tenancy"].FairnessConfig(tenants=(),
                                                   admission=False),
        ),
    ), n_replicas=n_replicas)


def test_router_tenant_aware_completes_and_accounts():
    r = _fair_router()
    reqs = multi_tenant(duration_s=5.0, seed=11)
    r.run(reqs)
    fin = sum(1 for q in r.journal.values() if q.state == RequestState.FINISHED)
    assert fin == len(reqs)
    svc = r.tenant_service()
    assert set(svc) == {q.tenant for q in reqs}
    # aggregated VTC charges across replicas == tokens executed fleet-wide
    # plus the first output tokens riding prefill-completion rounds
    executed = sum(
        st.scheduler.stats.scheduled_prefill_tokens
        + st.scheduler.stats.scheduled_decode_tokens
        for st in r.replicas.values()
    )
    first_tokens = sum(
        1 for q in r.journal.values() if q.prefill_end_time is not None
    )
    assert sum(svc.values()) == executed + first_tokens
    rep = r.fairness_report()
    assert set(rep.per_tenant) == set(svc)


# ---------------------------------------------------------------------------
# (b) parity with the reference, exact
# ---------------------------------------------------------------------------

J = dict(adaptive=j_adaptive, apc=j_apc, lprs=j_lprs, predictor=j_predictor,
         scheduler=j_scheduler, costmodel=j_costmodel, kv=j_kv,
         router=j_router, simulator=j_simulator, workload=j_workload,
         tenancy=j_tenancy)
T = dict(adaptive=t_adaptive, apc=t_apc, lprs=t_lprs, predictor=t_predictor,
         scheduler=t_scheduler, costmodel=t_costmodel, kv=t_kv,
         router=t_router, simulator=t_simulator, workload=t_workload,
         tenancy=t_tenancy)


def _renumber(reqs):
    """Request ids 0..N-1 in workload order: each package draws ids from a
    counter of its own, and the schedulers break ties on them."""
    for i, r in enumerate(reqs):
        r.req_id = i
    return reqs


def _plain(x):
    """A result as nested plain values: dataclasses as dicts, enums (each
    package has its own classes) as their values, numpy scalars as floats."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


def _sim_case(pkg, case):
    """One simulator run of ``case`` in package ``pkg``: its result."""
    S, wl = pkg["scheduler"], pkg["workload"]
    pool = None
    predictor = None
    kw = dict(token_budget=256, max_seqs=32)
    if case == "multi_tenant":
        reqs = wl.multi_tenant(duration_s=4.0, seed=7)
        fairness = pkg["tenancy"].FairnessConfig(tenants=(
            pkg["tenancy"].TenantSpec("heavy", weight=1.0),
            pkg["tenancy"].TenantSpec("light0", weight=2.0)))
        cfg = S.SchedulerConfig(policy="aging", alpha=1.0, beta=-0.1,
                                fairness=fairness, **kw)
    else:
        reqs = wl.sharegpt_like(wl.WorkloadSpec(
            n_requests=80, inter_arrival_s=0.01, max_context=1024, seed=3))
        if case == "lprs_apc":
            predictor = pkg["predictor"].AnalyticPredictor()
            cfg = S.SchedulerConfig(
                policy="aging", alpha=1.0, beta=-0.1,
                lprs=pkg["lprs"].LPRSConfig(target_latency_ms=40.0),
                apc=pkg["apc"].APCConfig(c_max=4, l_min=64), **kw)
        elif case == "aging_kv_pressure":
            pool = pkg["kv"].KVBlockPool(pkg["kv"].KVPoolConfig(
                n_blocks=160, block_size=16, bytes_per_token=4,
                enable_prefix_cache=True))
            cfg = S.SchedulerConfig(policy="aging", alpha=1.0, beta=-0.1, **kw)
        else:
            cfg = S.SchedulerConfig(policy=case, alpha=1.0, beta=-0.1, **kw)
    return pkg["simulator"].run_policy(
        _renumber(reqs), cfg, predictor=predictor, kv_pool=pool,
        cost_model=pkg["costmodel"].CostModel(
            pkg["costmodel"].CostModelConfig(seed=5)),
        collect_samples=True)


def _sim_rows(res):
    out = {
        "row": res.report.row(),
        "report": _plain(res.report),
        "rounds": res.rounds,
        "sim_time_s": res.sim_time_s,
        "stats": _plain(res.scheduler_stats),
        "memory": _plain(res.memory),
        "slo": _plain(res.slo),
        "requests": [_plain(r) for r in res.requests],
    }
    return out


@pytest.mark.parametrize("case", ["fcfs", "sjf", "aging", "lprs_apc",
                                  "multi_tenant", "aging_kv_pressure"])
def test_simulator_matches_jax_exactly(case):
    want, got = _sim_case(J, case), _sim_case(T, case)
    assert got.report.n_finished == got.report.n_total > 0
    np.testing.assert_equal(_sim_rows(got), _sim_rows(want))
    np.testing.assert_array_equal(got.samples[0], want.samples[0])
    np.testing.assert_array_equal(got.samples[1], want.samples[1])
    if case == "aging_kv_pressure":
        assert got.scheduler_stats.preemptions > 0


def test_adaptive_controller_matches_jax_exactly():
    """The phase-shifting run with the controller on: the same metric rows,
    the same retuned scheduler knobs and controller history."""
    (want, jsched, jctl), (got, tsched, tctl) = (
        _adaptive_run(J, True), _adaptive_run(T, True))
    np.testing.assert_equal(_sim_rows(got), _sim_rows(want))
    assert _plain(tsched.cfg) == _plain(jsched.cfg)
    assert tctl.state.adjustments          # the controller did retune
    np.testing.assert_equal(_plain(tctl.state), _plain(jctl.state))


def _router_case(pkg, case):
    R, S, wl = pkg["router"], pkg["scheduler"], pkg["workload"]
    if case == "tenants_failover":
        router = _fair_router(3, pkg)
        reqs = wl.multi_tenant(duration_s=5.0, seed=12)
        faults = {0.5: lambda rt: rt.kill_replica(0)}
    else:
        router = R.Router(R.RouterConfig(
            straggler_factor=0.5, straggler_window=1.0, max_retries=2,
            scheduler=S.SchedulerConfig(policy="aging", token_budget=256,
                                        max_seqs=32)), n_replicas=3)
        router.add_replica(speed=0.05)
        reqs = wl.sharegpt_like(wl.WorkloadSpec(n_requests=60,
                                                inter_arrival_s=0.02, seed=4))
        faults = {0.3: lambda rt: rt.kill_replica(0),
                  0.8: lambda rt: rt.add_replica(),
                  1.5: lambda rt: rt.remove_replica(1)}
    report = router.run(_renumber(reqs), fault_at=faults)
    return router, report


@pytest.mark.parametrize("case", ["faults_stragglers", "tenants_failover"])
def test_router_matches_jax_exactly(case):
    (jr, jrep), (tr, trep) = _router_case(J, case), _router_case(T, case)
    assert tr.events == jr.events
    assert any("DIED" in e for e in tr.events)
    np.testing.assert_equal(_plain(trep), _plain(jrep))
    assert tr.clock == jr.clock
    assert _plain(tr._replays) == _plain(jr._replays)
    np.testing.assert_equal(
        {k: _plain(v) for k, v in tr.journal.items()},
        {k: _plain(v) for k, v in jr.journal.items()})
    assert ([_plain(r) for r in tr.shed_failed]
            == [_plain(r) for r in jr.shed_failed])
    np.testing.assert_equal(_plain(tr.tenant_service()),
                            _plain(jr.tenant_service()))
    np.testing.assert_equal(_plain(tr.fairness_report()),
                            _plain(jr.fairness_report()))
    for rid, st in jr.replicas.items():
        np.testing.assert_equal(_plain(tr.replicas[rid].scheduler.stats),
                                _plain(st.scheduler.stats))


# ---------------------------------------------------------------------------
# (c) the torch examples, on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_serve_multitenant",
                                  "torch_serve_lprs_apc"])
def test_example_finishes_every_request_on_the_cpu(name, capsys):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert module.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "finished" in out
