"""The port's disaggregated prefill/decode serving (``repro_torch.disagg``) on
the CPU against the JAX package.

A 1-prefill + 1-decode fleet of ``TorchEngine`` replicas -- every request's
KV exported at prefill completion through the swap gather, the host-side
handoff store and the swap scatter into the decode replica, with KV-pressure
swap preemptions racing the handoffs -- must produce exactly the greedy
tokens (f32) of the port's single unconstrained engine and of the JAX
package's fleet on the same weights, paged and dense alike, hand every
request off exactly once and prefill 0 tokens on the decode side.  Prefetch on and off, and the
synchronous and pipelined loops, give the same tokens.

The JAX package's ``test_killed_mid_handoff_leaks_nothing`` cases fail in the
reference itself and are not mirrored here.
"""
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
from repro_torch.core.scheduler import ChunkedPrefillScheduler, SchedulerConfig
from repro_torch.disagg import DisaggConfig, build_disagg, serve_disagg
from repro_torch.engine.engine import EngineConfig, TorchEngine, serve
from repro_torch.engine.kv_cache import KVBlockPool, KVPoolConfig
from repro_torch.engine.workload import shared_prefix
from repro_torch.weights import from_jax_params

SEED = 3          # the JAX fleet's replicas init from PRNGKey(engine seed)
ENGINE = dict(n_slots=6, max_context=128, seed=SEED)
SCHED = dict(policy="fcfs", token_budget=96, max_seqs=6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run as fast on one intra-op thread, and several test
    workers sharing the CPU do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """Tiny f32 qwen: the JAX fleet's own init, and the same weights in the
    port."""
    jcfg = jax_tiny_config("qwen1.5-0.5b").with_(param_dtype="float32")
    tcfg = tiny_config("qwen1.5-0.5b").with_(param_dtype="float32")
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(SEED))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, from_jax_params(np_params, tcfg, device="cpu")


def _two_wave(make, seed=5, n=12, new_tokens=24):
    """The JAX package's disagg workload: two deterministic waves whose
    decodes grow past block boundaries on a 9-block pool, so preemption
    races the in-flight handoffs."""
    reqs = make(n_requests=n, n_prefixes=2, prefix_len=48,
                suffix_range=(8, 16), max_new_tokens=new_tokens,
                inter_arrival_s=0.0, vocab_size=512, seed=seed)
    for i, r in enumerate(reqs):
        r.arrival_time = 0.0 if i < n // 2 else 60.0
    return reqs


def _port_fleet(tcfg, tparams, *, pipelined=True, prefetch=True, paged=True):
    router = build_disagg(
        tcfg, cfg=DisaggConfig(prefetch=prefetch),
        engine_cfg=EngineConfig(pipelined=pipelined, preemption_mode="swap",
                                paged_kv=paged, **ENGINE),
        sched_cfg=SchedulerConfig(**SCHED), n_blocks=9, block_size=16,
        params=tparams, device="cpu")
    reqs = _two_wave(shared_prefix)
    res = serve_disagg(reqs, router)
    router.check_invariants()
    assert res.report.n_finished == len(reqs)
    # every request crossed the link exactly once and resumed decode-only
    assert res.handoffs == len(reqs) and res.colocated == 0
    assert all(r.handoffs == 1 for r in reqs)
    assert sum(rs.sched.stats.scheduled_prefill_tokens
               for rs in router.decode) == 0
    # the replicas share one weight set
    assert router.prefill[0].engine.params is router.decode[0].engine.params
    return [res.outputs[r.req_id] for r in reqs], router


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_disagg_matches_single_engine_and_jax_fleet(weights, paged):
    """tests/test_disagg.py:94 on both layouts: the dense fleet hands whole
    slot rows over instead of pages."""
    jcfg, tcfg, tparams = weights
    got, router = _port_fleet(tcfg, tparams, pipelined=False, paged=paged)
    # pressure bit on the small pools: preemptions raced the handoffs
    assert sum(rs.sched.stats.preemptions for rs in router.replicas) > 0
    assert all(rs.engine.cfg.paged_kv == paged for rs in router.replicas)

    eng = TorchEngine(tcfg, EngineConfig(paged_kv=paged, **ENGINE),
                      params=tparams, device="cpu")
    pool = KVBlockPool(KVPoolConfig(n_blocks=400, block_size=16,
                                    bytes_per_token=4, enable_prefix_cache=True))
    reqs = _two_wave(shared_prefix)
    res = serve(reqs, ChunkedPrefillScheduler(SchedulerConfig(**SCHED)), eng,
                kv_pool=pool)
    single = [res.outputs[r.req_id] for r in reqs]

    jrouter = jax_build_disagg(
        jcfg, engine_cfg=JaxEngineConfig(pipelined=False, paged_kv=paged,
                                         preemption_mode="swap", **ENGINE),
        sched_cfg=JaxSchedulerConfig(**SCHED), cfg=JaxDisaggConfig(),
        n_blocks=9, block_size=16)
    jreqs = _two_wave(jax_shared_prefix)
    jres = jax_serve_disagg(jreqs, jrouter)
    assert jres.handoffs == len(jreqs)
    want = [jres.outputs[r.req_id] for r in jreqs]

    assert any(t != 0 for out in got for t in out)
    assert got == single == want


def test_disagg_prefetch_off_and_sync_match_pipelined_prefetch(weights):
    """Prefetch (adopting the record while the source gather is still in
    flight) and the pipelined loop change when a payload lands, never what
    it holds."""
    _, tcfg, tparams = weights
    base, router_p = _port_fleet(tcfg, tparams)
    wait, router_w = _port_fleet(tcfg, tparams, prefetch=False)
    sync, _ = _port_fleet(tcfg, tparams, pipelined=False)
    # pipelined: the gather lands one round late, so every prefetch-mode
    # adoption happens while the copy is still in flight
    assert router_p.store.stats.prefetched > 0
    assert router_w.store.stats.prefetched == 0
    assert base == wait == sync
