"""The disaggregated fleet's ledger on ``TorchEngine`` replicas (the port's
``repro_torch.disagg``), on the CPU: the reference's property tests of
tests/test_disagg.py mirrored on the port.

- every live request's KV is accounted in exactly one place -- source pool,
  handoff store or destination pool -- after every sweep of the fleet loop,
  with prefetch on and off (tests/test_disagg.py:210);
- a request killed by a stop token equal to its first output id (:309)
  leaks nothing, and every request's output is the single engine's cut at
  its own first stop.  Run on the SYNCHRONOUS loop, where rounds do not
  depend on wall-clock time (the reference's own cases, on the pipelined
  loop, fail in the reference itself).  There the first token is read
  before the prefill-completing round hands off, so the stop retires the
  request at its source with nothing staged -- no gather is in flight and
  no handoff is dropped, in the JAX package's fleet as in the port's -- and
  the port's counts and outputs equal the JAX fleet's on the same f32
  weights;
- placement prefers the decode replica holding a request's prefix over a
  less loaded one (:355);
- ``cache_credit`` ranks the candidate whose KV is resident first (:390).
"""
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import tiny_config as jax_tiny_config
from repro.core.scheduler import SchedulerConfig as JaxSchedulerConfig
from repro.disagg import DisaggConfig as JaxDisaggConfig
from repro.disagg import build_disagg as jax_build_disagg
from repro.disagg import serve_disagg as jax_serve_disagg
from repro.engine.engine import EngineConfig as JaxEngineConfig
from repro.engine.workload import shared_prefix as jax_shared_prefix
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import tiny_config
from repro_torch.core.request import Request, RequestState
from repro_torch.core.scheduler import ChunkedPrefillScheduler, SchedulerConfig
from repro_torch.disagg import DisaggConfig, build_disagg, serve_disagg
from repro_torch.engine.engine import (
    EngineConfig, TorchEngine, compress_idle_gap, serve,
)
from repro_torch.engine.kv_cache import KVBlockPool, KVPoolConfig
from repro_torch.engine.workload import shared_prefix
from repro_torch.weights import from_jax_params

SEED = 3          # the JAX fleet's replicas init from PRNGKey(engine seed)
SCHED = dict(policy="fcfs", token_budget=96, max_seqs=6)
CFG = tiny_config("qwen1.5-0.5b").with_(param_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run as fast on one intra-op thread, and several test
    workers sharing the CPU do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    """Tiny f32 qwen: the JAX fleet's own init, in the port, for every
    engine of the module."""
    jcfg = jax_tiny_config("qwen1.5-0.5b").with_(param_dtype="float32")
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(SEED))
    return from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), CFG,
                           device="cpu")


def _two_wave(seed=5, n=12, new_tokens=10, make=shared_prefix):
    """tests/test_disagg.py's pressure generator: two deterministic waves,
    concurrency forcing KV preemption on a small pool."""
    reqs = make(n_requests=n, n_prefixes=2, prefix_len=48,
                suffix_range=(8, 16), max_new_tokens=new_tokens,
                inter_arrival_s=0.0, vocab_size=512, seed=seed)
    for i, r in enumerate(reqs):
        r.arrival_time = 0.0 if i < n // 2 else 60.0
    return reqs


def _serve_single(reqs, params, *, pipelined=True):
    """The unconstrained single engine on the same weights."""
    eng = TorchEngine(CFG,
                      EngineConfig(n_slots=6, max_context=128,
                                   pipelined=pipelined, seed=SEED),
                      params=params, device="cpu")
    pool = KVBlockPool(KVPoolConfig(n_blocks=400, block_size=16,
                                    bytes_per_token=4,
                                    enable_prefix_cache=True))
    res = serve(reqs, ChunkedPrefillScheduler(SchedulerConfig(**SCHED)), eng,
                kv_pool=pool)
    pool.check_invariants()
    return res


def _build_pressured(params, *, pipelined=True, n_blocks=11, n_decode=1,
                     prefetch=True):
    return build_disagg(
        CFG,
        cfg=DisaggConfig(n_prefill=1, n_decode=n_decode, prefetch=prefetch),
        engine_cfg=EngineConfig(n_slots=6, max_context=128,
                                pipelined=pipelined, preemption_mode="swap",
                                seed=SEED),
        sched_cfg=SchedulerConfig(**SCHED), n_blocks=n_blocks, block_size=16,
        params=params, device="cpu")


@pytest.mark.parametrize("prefetch", [True, False], ids=["prefetch", "wait"])
def test_kv_accounted_in_exactly_one_location_throughout(params, prefetch):
    """Drive the fleet sweep by sweep (``serve_disagg``'s loop,
    instrumented): after every sweep each unfinished request's KV is in at
    most one place, a decoding or swapped one in exactly one; at quiesce the
    store is empty and every pool balances."""
    reqs = _two_wave(new_tokens=24)
    router = _build_pressured(params, n_blocks=9, prefetch=prefetch)
    pending = sorted(reqs, key=lambda r: r.arrival_time)
    t_start = time.perf_counter()
    for rs in router.replicas:
        rs.start(t_start)
    next_i = 0
    checks = 0
    for _ in range(200_000):
        now = time.perf_counter() - t_start
        while next_i < len(pending) and pending[next_i].arrival_time <= now:
            router.submit(pending[next_i])
            next_i += 1
        statuses = [rs.step(now) for rs in router.replicas]
        moved = router.pump()
        for r in pending[:next_i]:
            if r.state == RequestState.FINISHED:
                continue
            n = router.kv_locations(r.req_id)
            assert n <= 1, f"req {r.req_id} KV in {n} places"
            if r.state == RequestState.DECODING or r.swapped:
                assert n == 1, f"req {r.req_id} ({r.state}) KV nowhere"
                checks += 1
        progress = moved > 0 or any(
            s in ("round", "drained", "finalized") for s in statuses)
        if (not progress and not router._pending
                and not any(rs.busy() for rs in router.replicas)):
            if next_i >= len(pending):
                break
            compress_idle_gap(pending, next_i, now)
    for rs in router.replicas:
        rs.finish()
    router.pump()

    assert checks > 0
    assert all(r.state == RequestState.FINISHED for r in reqs)
    assert len(router.store) == 0
    for r in reqs:
        assert router.kv_locations(r.req_id) == 0
    router.check_invariants()


@pytest.mark.parametrize("prefetch", [True, False], ids=["prefetch", "wait"])
def test_killed_mid_handoff_leaks_nothing_sync(params, prefetch):
    """A stop token equal to request 0's first output id, on the sync loop:
    every request whose first token is the stop retires at its source with
    nothing staged (no handoff dropped), every other one is delivered once,
    nothing leaks, every pool balances, each output is the single engine's
    cut at its own first stop -- and the counts and outputs are the JAX
    fleet's on the same weights."""
    reqs_ref = _two_wave()
    res_ref = _serve_single(reqs_ref, params, pipelined=False)
    stop = res_ref.outputs[reqs_ref[0].req_id][0]

    reqs = _two_wave()
    for r in reqs:
        r.stop_token = stop
    router = _build_pressured(params, pipelined=False, prefetch=prefetch)
    res = serve_disagg(reqs, router)

    assert all(r.state == RequestState.FINISHED for r in reqs)
    assert reqs[0].stopped and len(res.outputs[reqs[0].req_id]) == 1
    at_source = [r for r in reqs if res.outputs[r.req_id] == [stop]]
    assert reqs[0] in at_source and all(r.handoffs == 0 for r in at_source)
    stats = router.store.stats
    assert stats.colocated == 0 and res.dropped_handoffs == 0
    assert stats.delivered == len(reqs) - len(at_source)
    for a, b in zip(reqs, reqs_ref):
        ref = res_ref.outputs[b.req_id]
        want = ref[:ref.index(stop) + 1] if stop in ref else ref
        assert res.outputs[a.req_id] == want
        assert a.stopped == (stop in ref)
    assert len(router.store) == 0
    for r in reqs:
        assert router.kv_locations(r.req_id) == 0
    router.check_invariants()

    jcfg = jax_tiny_config("qwen1.5-0.5b").with_(param_dtype="float32")
    jrouter = jax_build_disagg(
        jcfg, cfg=JaxDisaggConfig(prefetch=prefetch),
        engine_cfg=JaxEngineConfig(n_slots=6, max_context=128,
                                   pipelined=False, preemption_mode="swap",
                                   seed=SEED),
        sched_cfg=JaxSchedulerConfig(**SCHED), n_blocks=11, block_size=16)
    jreqs = _two_wave(make=jax_shared_prefix)
    for r in jreqs:
        r.stop_token = stop
    jres = jax_serve_disagg(jreqs, jrouter)
    assert ([jres.outputs[r.req_id] for r in jreqs]
            == [res.outputs[r.req_id] for r in reqs])
    assert (jres.dropped_handoffs, jres.handoffs, jrouter.store.stats.delivered,
            [r.handoffs for r in jreqs]) == (
        res.dropped_handoffs, res.handoffs, stats.delivered,
        [r.handoffs for r in reqs])


def test_placement_prefers_replica_with_resident_prefix(params):
    """After one request's handoff lands (its blocks released into the
    destination's prefix cache), a second request sharing its prompt places
    onto that replica even when it is the more loaded one; an unrelated
    request follows load to the other replica."""
    reqs = shared_prefix(n_requests=1, n_prefixes=1, prefix_len=48,
                         suffix_range=(8, 16), max_new_tokens=6,
                         inter_arrival_s=0.0, vocab_size=512, seed=9)
    router = _build_pressured(params, n_blocks=64, n_decode=2)
    res = serve_disagg(reqs, router)
    assert res.handoffs == 1
    # the index tie-break sent the only handoff to decode replica 0, whose
    # pool now content-addresses the prompt's full blocks
    imports = [rs.kv_pool.stats.handoff_imports for rs in router.decode]
    assert imports == [1, 0]
    assert router.decode[0].kv_pool.probe_prefix(reqs[0].prompt_tokens) >= 48

    # load decode 0 with queued work: load alone would pick decode 1,
    # locality must override it
    dummy = Request(prompt_len=64, max_new_tokens=32,
                    prompt_tokens=list(range(100, 164)))
    router.decode[0].submit(dummy)
    warm = Request(prompt_len=reqs[0].prompt_len, max_new_tokens=8,
                   prompt_tokens=list(reqs[0].prompt_tokens))
    assert router._place(warm) is router.decode[0]
    cold = Request(prompt_len=64, max_new_tokens=8,
                   prompt_tokens=list(range(300, 364)))
    assert router._place(cold) is router.decode[1]


def test_cache_credit_orders_resident_kv_first():
    """Two equal-priority candidates: with ``cache_credit`` on, the one whose
    KV is already materialized on the pool ranks first; with it off,
    submission order wins."""

    class _Pool:
        def __init__(self):
            self.resident = {}

        def resident_tokens(self, req_id):
            return self.resident.get(req_id, 0)

    pool = _Pool()
    cold = Request(prompt_len=64, max_new_tokens=4, arrival_time=0.0)
    warm = Request(prompt_len=64, max_new_tokens=4, arrival_time=0.0)
    pool.resident[warm.req_id] = 64

    def order(credit):
        sched = ChunkedPrefillScheduler(
            SchedulerConfig(policy="aging", alpha=1.0, beta=-0.01,
                            cache_credit=credit),
            kv_pool=pool, kv_booking=False,
        )
        sched.submit(cold)
        sched.submit(warm)
        return sched.queue.pop()

    assert order(credit=0.5) is warm
    assert order(credit=0.0) is cold
