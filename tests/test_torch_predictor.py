"""The port's LPRS latency predictor (``repro_torch.core.predictor``) against
the JAX package's, on the CPU.

(a) Parity of persistence: a JAX-trained predictor's ``state_dict()`` loads
    with the port's ``from_state`` and predicts the same latencies (f32,
    rtol 1e-5) on seeded feature rows; the port's own ``state_dict``
    round-trips and loads into the JAX class.  ``select_chunk`` picks the
    same chunk with either predictor.
(b) Training, as tests/test_predictor.py holds the reference: convergence on
    the synthetic set, the asymmetric Huber loss, bucketing.  The port
    trains with ``torch.optim.AdamW`` and torch's generators, so it matches
    the reference in outcome, not bitwise.
(c) Serving: greedy ``serve()`` under aging + LPRS + APC on the fused
    layout with one predictor state loaded in both packages gives the
    ``JAXEngine``'s tokens on tiny f32; the serve CLI's ``--lprs --kv-layout
    fused`` path profiles, trains and serves.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tiny_config as jax_tiny_config
from repro.core.apc import APCConfig as JaxAPCConfig
from repro.core.features import BatchState as JaxBatchState
from repro.core.lprs import LPRSConfig as JaxLPRSConfig
from repro.core.lprs import select_chunk as jax_select_chunk
from repro.core.predictor import AnalyticPredictor as JaxAnalyticPredictor
from repro.core.predictor import LatencyPredictor as JaxPredictor
from repro.core.predictor import PredictorConfig as JaxPredictorConfig
from repro.core.predictor import asymmetric_huber as jax_huber
from repro.core.predictor import bucket_and_downsample as jax_bucket
from repro.core.scheduler import ChunkedPrefillScheduler as JaxScheduler
from repro.core.scheduler import SchedulerConfig as JaxSchedulerConfig
from repro.engine.engine import EngineConfig as JaxEngineConfig
from repro.engine.engine import JAXEngine
from repro.engine.engine import serve as jax_serve
from repro.engine.workload import WorkloadSpec as JaxWorkloadSpec
from repro.engine.workload import attach_prompt_tokens as jax_attach
from repro.engine.workload import sharegpt_like as jax_sharegpt_like
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import tiny_config
from repro_torch.core import (
    AnalyticPredictor, LatencyPredictor, PredictorConfig, bucket_and_downsample,
)
from repro_torch.core.apc import APCConfig
from repro_torch.core.features import BatchState, derive_features
from repro_torch.core.lprs import LPRSConfig, select_chunk
from repro_torch.core.predictor import asymmetric_huber
from repro_torch.core.scheduler import ChunkedPrefillScheduler, SchedulerConfig
from repro_torch.engine.engine import EngineConfig, TorchEngine, serve
from repro_torch.engine.kv_cache import KVBlockPool, KVPoolConfig
from repro_torch.engine.workload import (
    WorkloadSpec, attach_prompt_tokens, sharegpt_like,
)
from repro_torch.launch import serve as serve_cli
from repro_torch.weights import from_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run as fast on one intra-op thread, and several test
    workers sharing the CPU do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def synth_dataset(n=3000, seed=0):
    """Features + latencies from a noisy analytic model (stand-in GPU), as
    tests/test_predictor.py makes them."""
    rng = np.random.default_rng(seed)
    raw = np.zeros((n, 11))
    raw[:, 0] = rng.integers(0, 2048, n)            # prefill_tokens
    raw[:, 1] = rng.integers(0, 64, n)              # decode_tokens
    raw[:, 2] = raw[:, 1] + (raw[:, 0] > 0)
    raw[:, 3] = raw[:, 1] * rng.integers(10, 2000, n)
    raw[:, 4] = rng.integers(0, 4096, n)
    raw[:, 5] = rng.integers(0, 4096, n)
    feats = derive_features(raw)
    oracle = AnalyticPredictor(c0=2.0, c_prefill=0.05, c_decode=0.12,
                               c_ctx=3e-5, c_batch=0.06)
    y = oracle.predict(feats) * rng.lognormal(0, 0.02, n)
    return feats.astype(np.float64), y


@pytest.fixture(scope="module")
def jax_state():
    """A predictor trained by the JAX package, as its state_dict."""
    feats, y = synth_dataset(400)
    p = JaxPredictor(JaxPredictorConfig(epochs=10))
    p.fit(feats, y)
    return p.state_dict()


WORKLOAD = dict(n_requests=6, inter_arrival_s=0.01, max_context=100,
                max_new_tokens=8, seed=7)
ENGINE = dict(n_slots=8, max_context=256, kv_layout="fused")
SCHED = dict(policy="aging", token_budget=48, max_seqs=8)


@pytest.fixture(scope="module")
def engine_profile():
    """Round features of a static-budget serve on the tiny fused engine,
    labelled by a deterministic analytic cost model (not the wall clock),
    and a JAX predictor trained on them: its state_dict predicts sanely on
    the states this engine's scheduler builds."""
    tcfg = tiny_config("qwen1.5-0.5b").with_(param_dtype="float32")
    eng = TorchEngine(tcfg, EngineConfig(pipelined=False, **ENGINE),
                      device="cpu")
    reqs = sharegpt_like(WorkloadSpec(**dict(WORKLOAD, n_requests=12, seed=3)))
    attach_prompt_tokens(reqs, tcfg.vocab_size)
    res = serve(reqs, ChunkedPrefillScheduler(SchedulerConfig(**SCHED)), eng,
                collect_samples=True)
    feats = res.samples[0]
    y = AnalyticPredictor(c0=2.0, c_prefill=0.05, c_decode=0.12).predict(feats)
    p = JaxPredictor(JaxPredictorConfig(epochs=60))
    p.fit(feats, y)
    return feats, p.state_dict()


# -- (a) persistence and chunk selection ------------------------------------------
def test_jax_state_dict_loads_and_predicts_the_same(jax_state):
    jp = JaxPredictor.from_state(jax_state)
    tp = LatencyPredictor.from_state(jax_state, device="cpu")
    feats, _ = synth_dataset(256, seed=4)
    want = jp.predict(feats)
    got = tp.predict(feats)
    assert got.shape == (256,) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # one row gives a float, as in the reference
    assert isinstance(tp.predict(feats[0]), float)
    assert tp.predict(feats[0]) == pytest.approx(jp.predict(feats[0]),
                                                 rel=1e-5)


def test_port_state_dict_round_trips_and_loads_in_jax(jax_state):
    feats, y = synth_dataset(400)
    p = LatencyPredictor(PredictorConfig(epochs=10), device="cpu")
    p.fit(feats, y)
    state = p.state_dict()
    # the reference's format: w_i (in, out) numpy float32, b_i (out,)
    assert set(state) == set(jax_state)
    assert set(state["params"]) == set(jax_state["params"])
    for name, a in jax_state["params"].items():
        assert state["params"][name].shape == a.shape, name
        assert state["params"][name].dtype == np.float32, name
    q = LatencyPredictor.from_state(state, device="cpu")
    np.testing.assert_allclose(p.predict(feats[:16]), q.predict(feats[:16]),
                               rtol=1e-6)
    np.testing.assert_allclose(JaxPredictor.from_state(state).predict(feats[:16]),
                               p.predict(feats[:16]), rtol=1e-5)


def test_predictor_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        LatencyPredictor()


def test_select_chunk_matches_jax(engine_profile):
    """Round states the engine really built, with seeded remaining work,
    committed tokens, progress and targets."""
    feats, state = engine_profile
    jp = JaxPredictor.from_state(state)
    tp = LatencyPredictor.from_state(state, device="cpu")
    rng = np.random.default_rng(11)
    lo, hi = np.percentile(jp.predict(feats), [5, 95])
    picks = []
    for i in range(64):
        raw = dict(zip(BatchState.__dataclass_fields__,
                       feats[rng.integers(len(feats)), :11].tolist()))
        for name in list(raw)[:7]:
            raw[name] = int(raw[name])
        target = float(rng.uniform(lo, hi))
        kw = dict(remaining=int(rng.integers(1, 100)),
                  committed=int(rng.integers(0, 40)), token_budget=48,
                  processed=int(rng.integers(0, 100)))
        got = select_chunk(batch_state=BatchState(**raw), predictor=tp,
                           cfg=LPRSConfig(target_latency_ms=target,
                                          search_delta=8), **kw)
        want = jax_select_chunk(batch_state=JaxBatchState(**raw), predictor=jp,
                                cfg=JaxLPRSConfig(target_latency_ms=target,
                                                  search_delta=8), **kw)
        assert got == want, i
        picks.append(got)
    assert len(set(picks)) > 3           # the search really chose


# -- (b) training ------------------------------------------------------------------
def test_predictor_converges_to_low_mape():
    feats, y = synth_dataset()
    n_tr = 2400
    pred = LatencyPredictor(PredictorConfig(epochs=150, seed=1), device="cpu")
    pred.fit(feats[:n_tr], y[:n_tr])
    m = pred.evaluate(feats[n_tr:], y[n_tr:])
    assert m["mape_pct"] < 10.0, m
    assert m["mae_ms"] < 5.0, m


def test_asymmetric_huber_penalizes_underestimation():
    y = torch.tensor([100.0])
    under = asymmetric_huber(y, torch.tensor([90.0]), 5.0, w_under=2.0,
                             w_over=1.0)
    over = asymmetric_huber(y, torch.tensor([110.0]), 5.0, w_under=2.0,
                            w_over=1.0)
    assert float(under[0]) == pytest.approx(2 * float(over[0]))


def test_huber_is_quadratic_then_linear_as_the_reference():
    y = np.zeros(5, np.float32)
    y_hat = np.array([1.0, -3.0, 5.0, -20.0, 100.0], np.float32)
    got = asymmetric_huber(torch.from_numpy(y), torch.from_numpy(y_hat), 5.0,
                           2.0, 1.0).numpy()
    want = np.asarray(jax_huber(jnp.asarray(y), jnp.asarray(y_hat), 5.0, 2.0,
                                1.0))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == pytest.approx(0.5)
    assert got[4] == pytest.approx(5 * (100 - 2.5))


def test_bucket_downsample_matches_reference_and_caps():
    st = np.concatenate([np.full(900, 1024.0), np.linspace(1, 512, 100)])
    keep, w = bucket_and_downsample(st, n_buckets=8, max_bucket_frac=0.25,
                                    seed=0)
    jkeep, jw = jax_bucket(st, n_buckets=8, max_bucket_frac=0.25, seed=0)
    np.testing.assert_array_equal(keep, jkeep)
    np.testing.assert_array_equal(w, jw)
    assert (st[keep] == 1024.0).sum() <= 0.30 * len(st)
    assert len(w) == len(keep) and w.min() > 0
    feats, _ = synth_dataset(50)
    np.testing.assert_array_equal(
        AnalyticPredictor().predict(feats),
        JaxAnalyticPredictor().predict(feats))


# -- (c) serving under aging + LPRS + APC ---------------------------------------------
# every request arrives at t=0, so admission and aging order do not depend on
# either engine's wall clock and the two schedulers see the same states
LPRS_WORKLOAD = dict(WORKLOAD, inter_arrival_s=0.0)


def test_lprs_apc_serve_on_fused_layout_matches_jax_engine(engine_profile):
    feats, state = engine_profile
    # a target inside the profiled range: LPRS must cut some chunks
    target_ms = float(np.percentile(
        JaxPredictor.from_state(state).predict(feats), 40))
    jcfg = jax_tiny_config("qwen1.5-0.5b").with_(param_dtype="float32")
    tcfg = tiny_config("qwen1.5-0.5b").with_(param_dtype="float32")
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")

    jeng = JAXEngine(jcfg, JaxEngineConfig(pipelined=False, **ENGINE),
                     params=jparams)
    jreqs = jax_sharegpt_like(JaxWorkloadSpec(**LPRS_WORKLOAD))
    jax_attach(jreqs, jcfg.vocab_size)
    jsched = JaxScheduler(JaxSchedulerConfig(
        lprs=JaxLPRSConfig(target_latency_ms=target_ms, search_delta=16),
        apc=JaxAPCConfig(c_max=4, l_min=16), **SCHED),
        predictor=JaxPredictor.from_state(state))
    jres = jax_serve(jreqs, jsched, jeng)
    want = [jres.outputs[r.req_id] for r in jreqs]

    tp = LatencyPredictor.from_state(state, device="cpu")
    calls = []
    predict = tp.predict
    tp.predict = lambda f: calls.append(len(f)) or predict(f)
    eng = TorchEngine(tcfg, EngineConfig(pipelined=False, **ENGINE),
                      params=tparams, device="cpu")
    reqs = sharegpt_like(WorkloadSpec(**LPRS_WORKLOAD))
    attach_prompt_tokens(reqs, tcfg.vocab_size)
    sched = ChunkedPrefillScheduler(SchedulerConfig(
        lprs=LPRSConfig(target_latency_ms=target_ms, search_delta=16),
        apc=APCConfig(c_max=4, l_min=16), **SCHED), predictor=tp)
    res = serve(reqs, sched, eng)
    got = [res.outputs[r.req_id] for r in reqs]

    assert res.report.n_finished == len(reqs) and calls
    # LPRS cut chunks below the budget somewhere
    assert sched.stats.avg_chunk_size < SCHED["token_budget"]
    # the same chunk decisions, round by round
    for name in ("rounds", "scheduled_prefill_seqs", "scheduled_prefill_tokens"):
        assert getattr(sched.stats, name) == getattr(jsched.stats, name), name
    assert got == want


def test_serve_cli_lprs_on_fused_layout_builds_and_serves(capsys):
    args = serve_cli.build_parser().parse_args(
        ["--device", "cpu", "--kv-layout", "fused", "--policy", "aging",
         "--lprs", "--apc", "--target-ms", "12.5", "--n-requests", "4"])
    engine, sched, kv_pool, reqs = serve_cli.build(args)
    assert engine.cfg.kv_layout == "fused" and tuple(engine.cache) == ("kv",)
    assert engine.warmed and sched.predictor is not None
    assert sched.predictor.device.type == "cpu"
    assert sched.cfg.lprs.target_latency_ms == 12.5
    assert sched.cfg.lprs.search_delta == 32 and sched.cfg.apc is not None
    assert "predictor trained on" in capsys.readouterr().out
    # the profiling run left the pool as built
    assert_pool_as_built(kv_pool)
    res = serve(reqs, sched, engine, kv_pool=kv_pool)
    assert res.report.n_finished == len(reqs) == 4
    assert all(len(res.outputs[r.req_id]) == r.max_new_tokens for r in reqs)
    # --target-ms 0 (the default) takes the reference's 30 ms
    args.target_ms = 0.0
    assert serve_cli.build_scheduler(
        args, sched.predictor).cfg.lprs.target_latency_ms == 30.0


def assert_pool_as_built(pool):
    fresh = KVBlockPool(pool.cfg)
    assert pool.free_blocks == fresh.free_blocks
    assert not pool.tables and pool.cached_blocks == 0
    assert not pool._reg and not pool._payload and pool._now == 0.0
    assert pool.stats == fresh.stats and pool.host.stats == fresh.host.stats


def test_kv_pool_reset_frees_the_prefix_cache_and_counters():
    pool = KVBlockPool(KVPoolConfig(n_blocks=16, block_size=4,
                                    enable_prefix_cache=True))
    prompt = list(range(10))
    for req_id in (0, 1):
        pool.register_request(req_id, prompt_tokens=prompt)
        pool.match_prefix(req_id)
        pool.allocate(req_id, len(prompt) - pool.lens.get(req_id, 0))
        pool.release(req_id)
    pool.advance_clock(3.0)
    assert pool.cached_blocks == 2 and pool.stats.hit_blocks == 2
    pool.reset()
    assert_pool_as_built(pool)
    pool.check_invariants()
    # the same prompt misses now
    pool.register_request(2, prompt_tokens=prompt)
    assert pool.match_prefix(2) == 0 and pool.stats.miss_blocks == 2
    pool.allocate(2, len(prompt))
    with pytest.raises(AssertionError, match="live or staged"):
        pool.reset()


def test_serve_cli_lprs_with_prefix_cache_serves_on_a_reset_pool():
    args = serve_cli.build_parser().parse_args(
        ["--device", "cpu", "--kv-layout", "fused", "--lprs",
         "--prefix-cache", "--n-requests", "4"])
    engine, sched, kv_pool, reqs = serve_cli.build(args)
    assert kv_pool.cfg.enable_prefix_cache
    # the profiling run's sealed prompt blocks are not left to hit on
    assert_pool_as_built(kv_pool)
    res = serve(reqs, sched, engine, kv_pool=kv_pool)
    assert res.report.n_finished == len(reqs) == 4
    assert all(len(res.outputs[r.req_id]) == r.max_new_tokens for r in reqs)
    assert res.memory.cache_lookups == kv_pool.stats.lookups > 0
    kv_pool.check_invariants()
