"""The port's KV swap path on the CPU against the JAX package.

(a) The plain versions of the four swap kernels (``repro_torch.kernels.swap``,
which a CPU tensor takes) against ``repro.kernels.swap`` -- its jnp oracles
and its Pallas kernels in interpret mode -- on the same numpy-made pages,
sink-padded ids, split (H=2) and fused (H=4) head counts, f32 and bf16:
gather, scatter and the INT8 codes exactly equal, the scales and the
dequantized pages within rtol 1e-6 (the tolerance the JAX package holds its
own kernels to against its oracle: XLA may divide by 127 as a multiply by
the reciprocal).  (b) The sink-duplicate scatter and the all-zero page.
(c-e) ``serve()`` under swap preemption, with the INT8 host tier and with
tail-only (partial) restores on the two-wave pressure workload: the port's
greedy outputs in f32 equal ``JAXEngine``'s on the same weights, and inside
the port swap == recompute == unconstrained, pipelined and synchronous.

The CUDA kernels themselves need nvcc and a card; ``chip_smoke.py`` holds
them bitwise against these plain versions on the GPU.
"""
import jax
import jax.numpy as jnp
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
from repro.kernels import ref as jref
from repro.kernels import swap as jswap
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import tiny_config
from repro_torch.core.request import Request
from repro_torch.core.scheduler import (
    ChunkedPrefillScheduler, ScheduledBatch, SchedulerConfig,
)
from repro_torch.engine.engine import EngineConfig, TorchEngine, serve
from repro_torch.engine.kv_cache import KVBlockPool, KVPoolConfig
from repro_torch.engine.workload import shared_prefix
from repro_torch.kernels import ref as tref
from repro_torch.kernels import swap as tswap
from repro_torch.weights import from_jax_params

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
N_PHYS = 9                       # page 8 is the sink
GATHER_IDS = np.array([7, 2, 5, 8], np.int32)     # 3 real pages, sink-padded
SCATTER_IDS = np.array([1, 6, 3, 8], np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run as fast on one intra-op thread, and several test
    workers sharing the CPU do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(a, dtype):
    """One numpy array as a jnp array and a torch CPU tensor of the same
    values (bf16 rounds identically in both)."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(np.asarray(a)).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x).astype(np.float32) if jnp.issubdtype(
        x.dtype, jnp.floating) else np.asarray(x)


def _pool(rng, H):
    pages = rng.standard_normal((2, N_PHYS, 8, H, 8)).astype(np.float32) * 3.0
    pages[:, 5] = 0.0                     # an all-zero page: scale 0
    pages[:, 2, :, 1] = 0.0               # an all-zero head
    return pages


# -- (a) plain versions vs the JAX package ---------------------------------------
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("H", [2, 4], ids=["split", "fused"])
@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
def test_swap_gather_scatter_match_jax(rng, use_pallas, H, dtype):
    pages = _pool(rng, H)
    staged = rng.standard_normal((2, 4, 8, H, 8)).astype(np.float32)
    (jp, tp), (js, ts) = _both(pages, dtype), _both(staged, dtype)
    kw = dict(use_pallas=use_pallas, interpret=True)
    before = (tswap.swap_gather_pages.launches,
              tswap.swap_scatter_pages.launches)

    got = tswap.swap_gather_pages(tp, torch.from_numpy(GATHER_IDS))
    want = jswap.swap_gather_pages(jp, jnp.asarray(GATHER_IDS), **kw)
    assert got.dtype == tp.dtype and got.shape == (2, 4, 8, H, 8)
    np.testing.assert_array_equal(_np(got), _np(want))

    got = tswap.swap_scatter_pages(tp.clone(), torch.from_numpy(SCATTER_IDS),
                                   ts)
    # a fresh jnp pool: the JAX scatter donates its input
    want = jswap.swap_scatter_pages(_both(pages, dtype)[0],
                                    jnp.asarray(SCATTER_IDS), js, **kw)
    np.testing.assert_array_equal(_np(got), _np(want))
    # CPU tensors never launch a kernel
    assert (tswap.swap_gather_pages.launches,
            tswap.swap_scatter_pages.launches) == before


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("H", [2, 4], ids=["split", "fused"])
@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
def test_swap_q8_match_jax(rng, use_pallas, H, dtype):
    pages = _pool(rng, H)
    jp, tp = _both(pages, dtype)
    kw = dict(use_pallas=use_pallas, interpret=True)

    q, scales = tswap.swap_gather_pages_q8(tp, torch.from_numpy(GATHER_IDS))
    jq, jscales = jswap.swap_gather_pages_q8(jp, jnp.asarray(GATHER_IDS), **kw)
    assert q.dtype == torch.int8 and scales.dtype == torch.float32
    assert scales.shape == (2, 4, 1, H, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(scales.numpy(), np.asarray(jscales), rtol=1e-6)
    # the all-zero page (id 5) and head (page 2, head 1) have scale 0
    assert (scales[:, 2] == 0).all() and (scales[:, 1, :, 1] == 0).all()

    # the dequantizing scatter, fed the same codes and scales
    got = tswap.swap_scatter_pages_q8(tp.clone(), torch.from_numpy(SCATTER_IDS),
                                      q, scales)
    want = jswap.swap_scatter_pages_q8(
        _both(pages, dtype)[0], jnp.asarray(SCATTER_IDS), jnp.asarray(q.numpy()),
        jnp.asarray(scales.numpy()), **kw)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


# -- (b) sink duplicates and the all-zero page -----------------------------------
@pytest.mark.parametrize("q8", [False, True], ids=["fp", "int8"])
def test_swap_scatter_duplicate_sink_ids_only_touch_sink(rng, q8):
    """Padding entries point at the sink page: duplicate writes there must
    leave every real page untouched."""
    L, P, bs, H, hd = 1, 6, 4, 1, 8
    sink = P - 1
    pages = torch.from_numpy(rng.normal(size=(L, P, bs, H, hd)).astype(np.float32))
    before = pages.clone()
    staged = -torch.ones((L, 3, bs, H, hd))
    ids = torch.tensor([2, sink, sink], dtype=torch.int32)
    if q8:
        q, scales = tref.quantize_pages(staged)
        out = tswap.swap_scatter_pages_q8(pages, ids, q, scales)
    else:
        out = tswap.swap_scatter_pages(pages, ids, staged)
    assert out is pages                    # in place
    keep = [0, 1, 3, 4]
    assert torch.equal(out[:, keep], before[:, keep])
    assert torch.equal(out[:, 2], staged[:, 0])


def test_int8_quantize_zero_page_is_exact():
    pages = torch.zeros((1, 2, 4, 2, 4))
    q, scales = tref.quantize_pages(pages)
    jq, jscales = jref.quantize_pages(jnp.zeros((1, 2, 4, 2, 4), jnp.float32))
    assert not q.any() and not scales.any()
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))
    assert not tref.dequantize_pages(q, scales, torch.float32).any()


# -- (c-e) serve() under swap preemption vs the JAX engine -----------------------
ENGINE = dict(n_slots=6, max_context=128, seed=3)


@pytest.fixture(scope="module")
def weights():
    """Tiny f32 qwen JAX params, and the same weights in the port."""
    jcfg = jax_tiny_config("qwen1.5-0.5b").with_(param_dtype="float32")
    tcfg = tiny_config("qwen1.5-0.5b").with_(param_dtype="float32")
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(3))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, tcfg, from_jax_params(np_params, tcfg, device="cpu")


def _two_wave(make, seed=5, n=12, new_tokens=10):
    """The JAX package's two-wave pressure workload (t=0 and far behind):
    concurrency forces KV preemption on a small pool, with round structure
    independent of wall-clock timing so output comparisons are exact."""
    reqs = make(n_requests=n, n_prefixes=2, prefix_len=48,
                suffix_range=(8, 16), max_new_tokens=new_tokens,
                inter_arrival_s=0.0, vocab_size=512, seed=seed)
    for i, r in enumerate(reqs):
        r.arrival_time = 0.0 if i < n // 2 else 60.0
    return reqs


def _pressured(jax_side, cfg, params, *, mode="swap", pipelined=False,
               n_blocks=11, host_kv_dtype="auto", token_budget=96,
               partial_restore_after=None):
    """Serve the two-wave workload on the JAX engine or the port's; returns
    (outputs by workload position, scheduler stats)."""
    if jax_side:
        Engine, ECfg, Pool, PCfg, Sched, SCfg, run, make = (
            JAXEngine, JaxEngineConfig, JaxPool, JaxPoolConfig, JaxScheduler,
            JaxSchedulerConfig, jax_serve, jax_shared_prefix)
        eng = Engine(cfg, ECfg(pipelined=pipelined, preemption_mode=mode,
                               **ENGINE), params=params)
    else:
        Pool, PCfg, Sched, SCfg, run, make = (
            KVBlockPool, KVPoolConfig, ChunkedPrefillScheduler,
            SchedulerConfig, serve, shared_prefix)
        eng = TorchEngine(cfg, EngineConfig(
            pipelined=pipelined, preemption_mode=mode, **ENGINE),
            params=params, device="cpu")
    pool = Pool(PCfg(n_blocks=n_blocks, block_size=16, bytes_per_token=4,
                     enable_prefix_cache=True, host_kv_dtype=host_kv_dtype))
    sched = Sched(SCfg(policy="fcfs", token_budget=token_budget, max_seqs=6,
                       partial_restore_after=partial_restore_after))
    reqs = _two_wave(make)
    res = run(reqs, sched, eng, kv_pool=pool)
    pool.check_invariants()
    assert not pool.swapped_requests()          # nothing left staged at exit
    assert res.report.n_finished == len(reqs)
    assert any(t != 0 for out in res.outputs.values() for t in out)
    # req_ids are globally assigned: outputs by workload POSITION
    return [res.outputs[r.req_id] for r in reqs], sched.stats


@pytest.mark.parametrize("case", ["swap", "int8", "tail"])
def test_swap_serve_matches_jax_engine(weights, case):
    """(c) swap preemption, (d) the INT8 host tier, (e) tail-only restores
    through ``slice_swap_payload`` and ``swap_in_tail``: the port's greedy
    outputs equal the JAX engine's, with the same scheduling decisions."""
    jcfg, jparams, tcfg, tparams = weights
    kw = {"swap": {}, "int8": dict(host_kv_dtype="int8"),
          "tail": dict(n_blocks=9, token_budget=64, partial_restore_after=2),
          }[case]
    got, st = _pressured(False, tcfg, tparams, **kw)
    want, jst = _pressured(True, jcfg, jparams, **kw)
    assert st.swap_preemptions > 0
    if case == "tail":
        # some staged tails are dropped when a prefix-cache hit jumps past
        # them (tail_aborts), so restores fall short of swap-outs here
        assert st.partial_restores > 0
    else:
        assert st.swap_restores == st.swap_preemptions
    for name in ("preemptions", "swap_preemptions", "swap_restores",
                 "partial_restores", "tail_aborts"):
        assert getattr(st, name) == getattr(jst, name), name
    assert got == want


@pytest.mark.parametrize("pipelined", [True, False], ids=["pipelined", "sync"])
def test_swap_outputs_identical_to_recompute_and_unconstrained(weights,
                                                               pipelined):
    _, _, tcfg, tparams = weights
    swap, st_s = _pressured(False, tcfg, tparams, pipelined=pipelined)
    recompute, st_r = _pressured(False, tcfg, tparams, mode="recompute",
                                 pipelined=pipelined)
    free, st_u = _pressured(False, tcfg, tparams, mode="recompute",
                            pipelined=pipelined, n_blocks=400)
    # the pressure actually bit, and swap mode actually swapped
    assert st_s.swap_preemptions > 0
    assert st_s.swap_restores == st_s.swap_preemptions
    assert st_r.preemptions > 0 and st_r.swap_preemptions == 0
    assert st_u.preemptions == 0
    assert swap == recompute == free


def test_drain_finalizes_pending_swaps(weights):
    """A swap-out's payload lands at the next drain, as in the JAX engine:
    the record turns SWAPPED_OUT holding numpy copies of the gathered
    pages, padded with the sink page to a power-of-two bucket."""
    _, _, tcfg, tparams = weights
    eng = TorchEngine(tcfg, EngineConfig(preemption_mode="swap", **ENGINE),
                      params=tparams, device="cpu")
    pool = KVBlockPool(KVPoolConfig(n_blocks=16, block_size=16,
                                    bytes_per_token=4))
    eng.bind_kv_pool(pool)
    req = Request(prompt_len=20, max_new_tokens=4, arrival_time=0.0,
                  prompt_tokens=list(range(1, 21)))
    pool.register_request(req.req_id, prompt_len=20)
    pool.allocate(req.req_id, 20)
    table = list(pool.tables[req.req_id])
    assert eng.acquire_slot(req) and len(table) == 2
    inflight = eng.dispatch(ScheduledBatch(round_idx=0,
                                           prefill_chunks=[(req, 20)]))
    eng.swap_out(req)
    assert eng.has_pending_swaps() and not pool.swap_ready(req.req_id)
    eng.drain(inflight)
    assert not eng.has_pending_swaps() and pool.swap_ready(req.req_id)
    payload = pool._swap[req.req_id].payload
    for name, staged in zip(("k", "v"), payload):
        assert isinstance(staged, np.ndarray) and staged.shape[1] == 2
        np.testing.assert_array_equal(staged, eng.cache[name][:, table].numpy())
        assert np.abs(staged).sum() > 0
