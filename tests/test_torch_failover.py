"""The port's NaN guard and fault handling on the CPU, mirroring
tests/test_failover.py on the paged split, paged fused and dense layouts.

- ``nan_guard=True`` without a fault gives exactly the outputs of
  ``nan_guard=False``.
- A ``nan_logits`` fault poisons one decoding request's KV: the request is
  quarantined (terminal, ``shed_reason="numerics"``, its clean prefix
  delivered), its poisoned token's charge refunds, every other request's
  outputs stay bit-identical to the fault-free run, nothing stays
  poisoned and every value of the KV cache is finite at the end -- on the
  synchronous and the pipelined loop.
- Fuzzed colocated chaos plans with ``nan_logits`` among the sites keep
  exactly-once termination, a clean pool and the VTC charge identity.
- Releasing a victim zeroes what ``poison_kv`` wrote and what the
  victim's next round wrote from it, also when a crash unwinds the
  poisoned round before the quarantine sees it.
- Against ``JAXEngine(nan_guard=True)`` under the same fault on the same
  weights: the paged split and fused engines shed the same requests and
  deliver the same tokens; on the dense layout ``repro`` also sheds the
  victim slot's next owner (ROADMAP queue 3), the port does not.

On the card ``chip_smoke.py`` runs the same quarantine at full width
through the CUDA kernels, whose normalisation lets a NaN key through.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import tiny_config as jax_tiny_config
from repro.core.scheduler import ChunkedPrefillScheduler as JaxScheduler
from repro.core.scheduler import SchedulerConfig as JaxSchedulerConfig
from repro.engine.engine import EngineConfig as JaxEngineConfig
from repro.engine.engine import JAXEngine
from repro.engine.engine import serve as jax_serve
from repro.engine.kv_cache import KVBlockPool as JaxPool
from repro.engine.kv_cache import KVPoolConfig as JaxPoolConfig
from repro.engine.workload import shared_prefix as jax_shared_prefix
from repro.models.model import build_model as jax_build_model
from repro.robustness import FaultInjector as JaxFaultInjector
from repro.robustness import FaultPlan as JaxFaultPlan
from repro.robustness import FaultSpec as JaxFaultSpec
from repro.robustness import RobustnessConfig as JaxRobustnessConfig
from repro.tenancy import FairnessConfig as JaxFairnessConfig
from repro.tenancy import TenantSpec as JaxTenantSpec
from repro_torch.configs import tiny_config
from repro_torch.core.request import Request, RequestState
from repro_torch.core.scheduler import (
    ChunkedPrefillScheduler, ScheduledBatch, SchedulerConfig,
)
from repro_torch.engine.engine import EngineConfig, TorchEngine, serve
from repro_torch.engine.kv_cache import KVBlockPool, KVPoolConfig
from repro_torch.engine.workload import shared_prefix
from repro_torch.models.model import build_model
from repro_torch.robustness import (
    FaultInjector, FaultPlan, FaultSpec, RobustnessConfig,
)
from repro_torch.tenancy import FairnessConfig, TenantSpec
from repro_torch.weights import from_jax_params

FAIRNESS = FairnessConfig(tenants=(
    TenantSpec(name="a", weight=1.0), TenantSpec(name="b", weight=1.0),
))
LAYOUTS = {"split": dict(kv_layout="split"), "fused": dict(kv_layout="fused"),
           "dense": dict(paged_kv=False)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run as fast on one intra-op thread, and several test
    workers sharing the CPU do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """Tiny f32 qwen and one seeded weight set for every engine (f32, so
    greedy identity is exact)."""
    cfg = tiny_config("qwen1.5-0.5b").with_(param_dtype="float32")
    params = build_model(cfg).init(torch.Generator().manual_seed(3), "cpu")
    return cfg, params


def _two_wave(seed=5, n=12, new_tokens=10, tenants=False,
              make=shared_prefix):
    reqs = make(n_requests=n, n_prefixes=2, prefix_len=48,
                         suffix_range=(8, 16), max_new_tokens=new_tokens,
                         inter_arrival_s=0.0, vocab_size=512, seed=seed)
    for i, r in enumerate(reqs):
        r.arrival_time = 0.0 if i < n // 2 else 60.0
        if tenants:
            r.tenant = "a" if i % 2 == 0 else "b"
    return reqs


def _engine(setup, layout, *, pipelined=True, nan_guard=False):
    cfg, params = setup
    return TorchEngine(cfg, EngineConfig(
        n_slots=6, max_context=128, pipelined=pipelined,
        preemption_mode="swap", nan_guard=nan_guard, seed=3,
        **LAYOUTS[layout]), params=params, device="cpu")


def _serve_colocated(setup, reqs, layout, *, robustness=None, pipelined=True,
                     fairness=None, nan_guard=None, n_blocks=64):
    eng = _engine(setup, layout, pipelined=pipelined,
                  nan_guard=(robustness is not None) if nan_guard is None
                  else nan_guard)
    pool = KVBlockPool(KVPoolConfig(n_blocks=n_blocks, block_size=16,
                                    bytes_per_token=4,
                                    enable_prefix_cache=True))
    sched = ChunkedPrefillScheduler(
        SchedulerConfig(policy="fcfs", token_budget=96, max_seqs=6,
                        fairness=fairness))
    res = serve(reqs, sched, eng, kv_pool=pool, robustness=robustness)
    return res, sched, eng, pool


def _assert_all_terminal(reqs):
    for r in reqs:
        assert r.state == RequestState.FINISHED, r.req_id
        if r.finish_time is None:
            assert r.shed_reason is not None, r.req_id


def _charge_identity(sched):
    """charged == executed tokens + first-token bonuses, net of refunds."""
    fair = sched.fairness
    vtc = fair.vtc
    executed = (sched.stats.scheduled_prefill_tokens
                + sched.stats.scheduled_decode_tokens)
    charged = sum(vtc.actual_tokens(t) for t in vtc.tenants())
    assert charged == executed + fair.first_token_charges


def _assert_clean_storage(eng):
    assert not eng._poisoned
    for name, cache in eng.cache.items():
        assert bool(torch.isfinite(cache).all()), name


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_nan_guard_without_faults_is_bit_identical(setup, layout):
    reqs_a = _two_wave()
    res_a, *_ = _serve_colocated(setup, reqs_a, layout, nan_guard=False)
    reqs_b = _two_wave()
    res_b, _, eng, _ = _serve_colocated(setup, reqs_b, layout,
                                        nan_guard=True)
    assert any(t != 0 for out in res_a.outputs.values() for t in out)
    for a, b in zip(reqs_a, reqs_b):
        assert res_a.outputs[a.req_id] == res_b.outputs[b.req_id]
        assert b.shed_reason is None
    assert eng.cfg.nan_guard and not eng.last_nonfinite


@pytest.mark.parametrize("pipelined", [True, False], ids=["pipelined", "sync"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_nan_quarantine_sheds_victim_only(setup, layout, pipelined):
    reqs_base = _two_wave(tenants=True)
    base, *_ = _serve_colocated(setup, reqs_base, layout, pipelined=pipelined,
                                fairness=FAIRNESS, nan_guard=False)

    reqs = _two_wave(tenants=True)
    victim = reqs[1].req_id
    plan = FaultPlan(specs=(FaultSpec(site="nan_logits", nth=2,
                                      req_id=victim),))
    res, sched, eng, pool = _serve_colocated(
        setup, reqs, layout,
        robustness=RobustnessConfig(injector=FaultInjector(plan)),
        pipelined=pipelined, fairness=FAIRNESS)

    assert res.robustness.faults_fired == 1
    assert reqs[1].shed_reason == "numerics"
    assert res.robustness.quarantined == 1
    # the victim kept its clean prefix -- shorter than the full decode
    assert len(res.outputs[victim]) < len(base.outputs[reqs_base[1].req_id])
    assert (res.outputs[victim]
            == base.outputs[reqs_base[1].req_id][:len(res.outputs[victim])])
    _assert_all_terminal(reqs)
    for i, r in enumerate(reqs):
        if r.req_id != victim:
            assert r.shed_reason is None
            assert res.outputs[r.req_id] == base.outputs[reqs_base[i].req_id]
    pool.check_invariants()
    assert not eng.slot_of
    _charge_identity(sched)
    _assert_clean_storage(eng)


@pytest.mark.parametrize("seed", [4, 5])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_chaos_colocated_invariants(setup, layout, seed):
    """tests/test_failover.py's fuzz harness on the single fault-tolerant
    replica, numerics quarantine included: exactly-once termination, a
    clean pool, the VTC charge identity."""
    plan = FaultPlan.fuzz(seed, n_faults=3,
                          sites=("replica_step_crash", "nan_logits",
                                 "slow_round_ms"),
                          max_nth=15)
    injector = FaultInjector(plan)
    reqs = _two_wave(tenants=True)
    res, sched, eng, pool = _serve_colocated(
        setup, reqs, layout, robustness=RobustnessConfig(injector=injector),
        fairness=FAIRNESS)
    n_nan = sum(f.site == "nan_logits" for f in injector.fired)
    assert res.robustness.quarantined <= n_nan
    if seed == 5:      # its plan's nan_logits fault is reached and sheds
        assert n_nan == 1 and res.robustness.quarantined == 1
    _assert_all_terminal(reqs)
    pool.check_invariants()
    assert not eng.slot_of
    _charge_identity(sched)
    assert not eng._poisoned


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_scrub_zeroes_the_poisoned_storage(setup, layout):
    """poison_kv writes NaN into the victim's last cached row (its page, on
    a paged pool); the victim's next round reads it -- its logits are
    flagged -- and writes NaN K/V for its new token; releasing the victim
    zeroes both at once, and the other request's storage is left as it
    was."""
    eng = _engine(setup, layout, pipelined=False, nan_guard=True)
    pool = KVBlockPool(KVPoolConfig(n_blocks=16, block_size=16,
                                    bytes_per_token=4))
    eng.bind_kv_pool(pool)
    reqs = [Request(prompt_len=n, max_new_tokens=4, arrival_time=0.0,
                    prompt_tokens=list(range(1, n + 1))) for n in (32, 20)]
    for r in reqs:
        pool.register_request(r.req_id, prompt_len=r.prompt_len)
        pool.allocate(r.req_id, r.prompt_len)
        assert eng.acquire_slot(r)
    eng.execute(ScheduledBatch(round_idx=0, prefill_chunks=[
        (r, r.prompt_len) for r in reqs]))
    assert not eng.last_nonfinite
    victim, other = reqs
    eng.poison_kv(victim)
    assert victim.req_id in eng._poisoned
    assert all(bool(torch.isnan(c).any()) for c in eng.cache.values())
    for r in reqs:
        pool.allocate(r.req_id, 1)
    eng.execute(ScheduledBatch(round_idx=1, decode_reqs=list(reqs)))
    assert eng.last_nonfinite == {victim.req_id}     # the other is clean

    def others_storage():
        if layout == "dense":
            return [c[:, eng.slot_of[other.req_id]].clone()
                    for c in eng.cache.values()]
        return [c[:, pool.tables[other.req_id]].clone()
                for c in eng.cache.values()]

    kept = others_storage()
    eng.release(victim)
    pool.release(victim.req_id)
    _assert_clean_storage(eng)
    for want, got in zip(kept, others_storage()):
        assert torch.equal(want, got)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_crash_unwinding_a_poisoned_round_leaves_no_poison(setup, layout):
    """A replica crash tears the round that read a ``nan_logits`` poison
    (step 4 poisons request 1's KV and dispatches; the crash hits step 5,
    before the drain): the unwind releases the victim, whose storage is
    zeroed then and there, and it recomputes from clean KV.  A second
    ``nan_logits`` later quarantines its own victim only; nobody else is
    shed, every other output equals the fault-free run's, and the cache
    ends finite."""
    reqs_base = _two_wave(tenants=True)
    base, *_ = _serve_colocated(setup, reqs_base, layout, fairness=FAIRNESS,
                                nan_guard=False)
    reqs = _two_wave(tenants=True)
    plan = FaultPlan(specs=(
        FaultSpec(site="nan_logits", nth=2, req_id=reqs[1].req_id),
        FaultSpec(site="replica_step_crash", nth=5),
        FaultSpec(site="nan_logits", nth=3, req_id=reqs[8].req_id),
    ))
    res, sched, eng, pool = _serve_colocated(
        setup, reqs, layout,
        robustness=RobustnessConfig(injector=FaultInjector(plan)),
        fairness=FAIRNESS)
    assert res.robustness.faults_fired == 3
    assert {i for i, r in enumerate(reqs) if r.shed_reason} == {8}
    assert reqs[8].shed_reason == "numerics"
    _assert_all_terminal(reqs)
    for i, r in enumerate(reqs):
        if i != 8:
            assert res.outputs[r.req_id] == base.outputs[reqs_base[i].req_id]
    pool.check_invariants()
    assert not eng.slot_of
    _charge_identity(sched)
    _assert_clean_storage(eng)


# -- against the reference ---------------------------------------------------
@pytest.fixture(scope="module")
def weights():
    """Tiny f32 qwen JAX params (PRNGKey 3), and the same weights in the
    port."""
    jcfg = jax_tiny_config("qwen1.5-0.5b").with_(param_dtype="float32")
    tcfg = tiny_config("qwen1.5-0.5b").with_(param_dtype="float32")
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(3))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, tcfg, from_jax_params(np_params, tcfg, device="cpu")


def _serve_under_nan_fault(weights, layout, pipelined, *, jax_side):
    """tests/test_failover.py's nan-quarantine run (two tenants, a
    ``nan_logits`` fault at request 1's 2nd decode) in either package.
    Returns (outputs by workload position, shed reasons by position, the
    cache is finite)."""
    jcfg, jparams, tcfg, tparams = weights
    if jax_side:
        mods = (jax_shared_prefix, JaxEngineConfig, JaxPool, JaxPoolConfig,
                JaxScheduler, JaxSchedulerConfig, JaxFairnessConfig,
                JaxTenantSpec, JaxFaultPlan, JaxFaultSpec, JaxFaultInjector,
                JaxRobustnessConfig, jax_serve)
    else:
        mods = (shared_prefix, EngineConfig, KVBlockPool, KVPoolConfig,
                ChunkedPrefillScheduler, SchedulerConfig, FairnessConfig,
                TenantSpec, FaultPlan, FaultSpec, FaultInjector,
                RobustnessConfig, serve)
    (make, ECfg, Pool, PCfg, Sched, SCfg, FCfg, Tenant, Plan, Spec, Inj,
     RCfg, run) = mods
    reqs = _two_wave(tenants=True, make=make)
    ecfg = ECfg(n_slots=6, max_context=128, pipelined=pipelined,
                preemption_mode="swap", nan_guard=True, seed=3,
                **LAYOUTS[layout])
    if jax_side:
        eng = JAXEngine(jcfg, ecfg, params=jparams)
    else:
        eng = TorchEngine(tcfg, ecfg, params=tparams, device="cpu")
    pool = Pool(PCfg(n_blocks=64, block_size=16, bytes_per_token=4,
                     enable_prefix_cache=True))
    fairness = FCfg(tenants=(Tenant(name="a", weight=1.0),
                             Tenant(name="b", weight=1.0)))
    sched = Sched(SCfg(policy="fcfs", token_budget=96, max_seqs=6,
                       fairness=fairness))
    plan = Plan(specs=(Spec(site="nan_logits", nth=2,
                            req_id=reqs[1].req_id),))
    res = run(reqs, sched, eng, kv_pool=pool,
              robustness=RCfg(injector=Inj(plan)))
    assert all(r.state.value == "finished" for r in reqs)
    outs = [list(res.outputs[r.req_id]) for r in reqs]
    shed = {i: r.shed_reason for i, r in enumerate(reqs) if r.shed_reason}
    finite = all(bool(np.isfinite(np.asarray(c)).all())
                 for c in eng.cache.values())
    return outs, shed, finite


@pytest.mark.parametrize("pipelined", [True, False], ids=["pipelined", "sync"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_nan_quarantine_matches_jax_engine(weights, layout, pipelined):
    """The same fault on the same f32 weights in both packages.  Paged
    (split, fused): the same shed set, the victim's same clean prefix and
    the same outputs for everyone.  Dense: ``repro``'s scrub leaves the NaN
    K/V the poisoned round wrote, so it also quarantines request 11, the
    victim slot's next owner, and ends with NaN in its cache; the port
    zeroes that storage and sheds the victim only.  Every other output is
    equal."""
    got, got_shed, got_finite = _serve_under_nan_fault(
        weights, layout, pipelined, jax_side=False)
    want, want_shed, want_finite = _serve_under_nan_fault(
        weights, layout, pipelined, jax_side=True)
    assert got_shed == {1: "numerics"} and got_finite
    assert 0 < len(got[1]) < 10
    if layout == "dense":
        assert want_shed == {1: "numerics", 11: "numerics"}
        assert not want_finite
        assert [o for i, o in enumerate(got) if i != 11] == [
            o for i, o in enumerate(want) if i != 11]
        assert len(want[11]) < len(got[11])
    else:
        assert want_shed == got_shed and want_finite
        assert got == want
