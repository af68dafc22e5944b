"""The port's fused KV layout on the CPU against the JAX package.

The fused pool ``(n_pages, page_size, 2*Hkv, hd)`` stores K of kv head h at
head 2h and V at 2h+1.  Checked here, on numpy-made inputs:

(a) ``fuse_pages`` / ``split_fused_pages`` against the reference's, both
    ways; the fused plain attention (what a CPU tensor takes) against the
    reference's fused jnp oracles and, at one shape, its fused Pallas
    kernels in interpret mode -- GQA groups 1/2/4, ragged lengths, permuted
    tables, an idle row, f32 and bf16.
(b) ``chunked_step_paged`` on a fused pool: logits and the un-interleaved
    pool against the JAX fused step over a 4-round mixed schedule, and the
    logits against the port's own split step.
(c) greedy ``serve()``: fused == split inside the port, sync and pipelined;
    fused == ``JAXEngine(kv_layout="fused")`` on tiny f32; fused swap ==
    fused recompute == split swap under KV pressure; the INT8 host tier on
    the fused pool == the split tier == the JAX fused tier; a disaggregated
    1+1 fused fleet == one engine; a payload staged under one layout is
    refused by an engine of the other.

The CUDA kernels need nvcc and a card; ``chip_smoke.py`` holds them against
these plain versions, and bitwise against the split kernels, on the GPU.
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
from repro.engine.workload import WorkloadSpec as JaxWorkloadSpec
from repro.engine.workload import attach_prompt_tokens as jax_attach
from repro.engine.workload import shared_prefix as jax_shared_prefix
from repro.engine.workload import sharegpt_like as jax_sharegpt_like
from repro.kernels import ref as jref
from repro.kernels.paged_decode_attention import (
    paged_decode_attention_fused as pallas_decode_fused,
)
from repro.kernels.paged_prefill_attention import (
    paged_prefill_attention_fused as pallas_prefill_fused,
)
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import tiny_config
from repro_torch.core.request import Request
from repro_torch.core.scheduler import (
    ChunkedPrefillScheduler, ScheduledBatch, SchedulerConfig,
)
from repro_torch.disagg import DisaggConfig, build_disagg, serve_disagg
from repro_torch.engine.engine import EngineConfig, TorchEngine, serve
from repro_torch.engine.kv_cache import KVBlockPool, KVPoolConfig
from repro_torch.engine.workload import (
    WorkloadSpec, attach_prompt_tokens, shared_prefix, sharegpt_like,
)
from repro_torch.kernels import ref as tref
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention_fused,
)
from repro_torch.kernels.paged_prefill_attention import (
    paged_prefill_attention_fused,
)
from repro_torch.models.model import build_model as torch_build_model
from repro_torch.weights import from_jax_params

TOL_F32 = 1e-5
TOL_BF16 = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32, TOL_F32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, TOL_BF16)}
# (B, Hq, Hkv, hd, page_size, max_pages, also run the Pallas kernel):
# GQA groups 1, 2 and 4; interpret-mode Pallas at one shape only
SHAPES = [
    (3, 4, 4, 16, 16, 5, True),
    (3, 8, 4, 32, 16, 4, False),
    (4, 8, 2, 32, 8, 6, False),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run as fast on one intra-op thread, and several test
    workers sharing the CPU do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(a, jdt, tdt):
    return jnp.asarray(a, jdt), torch.from_numpy(np.asarray(a)).to(tdt)


def _to_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _fused_setup(rng, B, Hkv, hd, page_size, max_pages):
    """A fused pool larger than needed and per-sequence tables that scatter
    each sequence's pages across it."""
    n_pages = 2 * B * max_pages + 3
    kv = rng.standard_normal((n_pages, page_size, 2 * Hkv, hd)).astype(
        np.float32)
    ids = rng.permutation(n_pages - 1)[: B * max_pages]
    return kv, ids.reshape(B, max_pages).astype(np.int32)


# -- (a) layout helpers and the fused plain attention ---------------------------
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fuse_and_split_pages_match_jax(rng, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    k = rng.standard_normal((5, 8, 3, 16)).astype(np.float32)
    v = rng.standard_normal((5, 8, 3, 16)).astype(np.float32)
    (jk, tk), (jv, tv) = _both(k, jdt, tdt), _both(v, jdt, tdt)
    fused = tref.fuse_pages(tk, tv)
    assert fused.shape == (5, 8, 6, 16)
    np.testing.assert_array_equal(_to_np(fused), _to_np(jref.fuse_pages(jk, jv)))
    # K of head h at 2h, V at 2h+1
    assert torch.equal(fused[:, :, 2], tk[:, :, 1])
    assert torch.equal(fused[:, :, 3], tv[:, :, 1])
    for got, want, orig in zip(tref.split_fused_pages(fused),
                               jref.split_fused_pages(jref.fuse_pages(jk, jv)),
                               (tk, tv)):
        np.testing.assert_array_equal(_to_np(got), _to_np(want))
        assert torch.equal(got, orig)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,Hq,Hkv,hd,page_size,max_pages,pallas", SHAPES)
def test_paged_decode_fused_plain_matches_jax(rng, dtype, B, Hq, Hkv, hd,
                                              page_size, max_pages, pallas):
    jdt, tdt, tol = DTYPES[dtype]
    kv, tables = _fused_setup(rng, B, Hkv, hd, page_size, max_pages)
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    kv_lens = rng.integers(1, max_pages * page_size + 1, B).astype(np.int32)
    kv_lens[-1] = 0                            # an idle row
    (jq, tq), (jkv, tkv) = _both(q, jdt, tdt), _both(kv, jdt, tdt)
    tt, tl = torch.from_numpy(tables), torch.from_numpy(kv_lens)
    jt, jl = jnp.asarray(tables), jnp.asarray(kv_lens)
    before = paged_decode_attention_fused.launches

    got = _to_np(paged_decode_attention_fused(tq, tkv, tt, tl))
    assert paged_decode_attention_fused.launches == before   # CPU: plain
    live = kv_lens > 0
    assert np.isnan(got[~live]).all()          # like the jnp oracle
    want = _to_np(jref.paged_decode_attention_fused_ref(jq, jkv, jt, jl))
    np.testing.assert_allclose(got[live], want[live], atol=tol, rtol=tol)
    if pallas:
        want = _to_np(pallas_decode_fused(jq, jkv, jt, jl))
        np.testing.assert_allclose(got[live], want[live], atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,Hq,Hkv,hd,page_size,max_pages,pallas", SHAPES)
def test_paged_prefill_fused_plain_matches_jax(rng, dtype, B, Hq, Hkv, hd,
                                               page_size, max_pages, pallas):
    jdt, tdt, tol = DTYPES[dtype]
    Sq = 16
    kv, tables = _fused_setup(rng, B, Hkv, hd, page_size, max_pages)
    q = rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32)
    chunk = rng.integers(1, Sq + 1, B)
    prefix = rng.integers(0, max_pages * page_size - Sq + 1, B)
    q_offset = prefix.astype(np.int32)
    kv_lens = (prefix + chunk).astype(np.int32)
    q_offset[-1], kv_lens[-1] = 0, 0            # an idle row
    (jq, tq), (jkv, tkv) = _both(q, jdt, tdt), _both(kv, jdt, tdt)
    args_t = (torch.from_numpy(tables), torch.from_numpy(kv_lens),
              torch.from_numpy(q_offset))
    args_j = (jnp.asarray(tables), jnp.asarray(kv_lens), jnp.asarray(q_offset))
    before = paged_prefill_attention_fused.launches

    got = _to_np(paged_prefill_attention_fused(tq, tkv, *args_t))
    assert paged_prefill_attention_fused.launches == before
    live = kv_lens > 0
    assert np.isnan(got[~live]).all()
    want = _to_np(jref.paged_prefill_attention_fused_ref(jq, jkv, *args_j))
    np.testing.assert_allclose(got[live], want[live], atol=tol, rtol=tol)
    if pallas:
        want = _to_np(pallas_prefill_fused(jq, jkv, *args_j))
        np.testing.assert_allclose(got[live], want[live], atol=tol, rtol=tol)


# -- (b) the model step over the fused pool -------------------------------------
# slot -> chunk_len per round (1 after its prefill: a decode, 0: idle); round
# 3 is a pure-decode round (bucket C == 1)
SCHEDULE = [
    (16, (16, 10, 0, 5)),
    (16, (12, 1, 16, 1)),
    (1, (1, 1, 0, 1)),
    (32, (1, 0, 20, 1)),
]
PAGE_SIZE, MAX_PAGES = 8, 8
CONFIGS = [("qwen1.5-0.5b", {}), ("llama3.2-1b", {"n_kv_heads": 2})]


def _run_fused_schedule(name, param_dtype, rng, overrides):
    """The schedule through the JAX fused step, the port's fused step and
    the port's split step on the same weights; returns per-round live
    logits (jax, fused, split) and the final pools (jax fused, port fused,
    port split as (k, v))."""
    jcfg = jax_tiny_config(name).with_(param_dtype=param_dtype, **overrides)
    tcfg = tiny_config(name).with_(param_dtype=param_dtype, **overrides)
    np_params = jax.tree_util.tree_map(
        np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    layers = np_params["layers"]
    for nm in ("bq", "bk", "bv"):           # exercise the QKV biases
        if nm in layers["attn"]:
            a = layers["attn"][nm]
            layers["attn"][nm] = (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    tparams = from_jax_params(np_params, tcfg, device="cpu")
    jstep = jax.jit(jax_build_model(jcfg).impl.chunked_step_paged,
                    static_argnames=("kv_layout",))
    timpl = torch_build_model(tcfg).impl

    B = len(SCHEDULE[0][1])
    Hkv, hd = jcfg.n_kv_heads, jcfg.resolved_head_dim
    n_phys = B * MAX_PAGES + 5                      # last page is the sink
    sink = n_phys - 1
    fshape = (jcfg.n_layers, n_phys, PAGE_SIZE, 2 * Hkv, hd)
    sshape = (jcfg.n_layers, n_phys, PAGE_SIZE, Hkv, hd)
    tdt = getattr(torch, param_dtype)
    jcache = {"kv": jnp.zeros(fshape, jnp.dtype(param_dtype))}
    fcache = {"kv": torch.zeros(fshape, dtype=tdt)}
    scache = {"k": torch.zeros(sshape, dtype=tdt),
              "v": torch.zeros(sshape, dtype=tdt)}
    ids = rng.permutation(sink)[: B * MAX_PAGES].reshape(B, MAX_PAGES)
    lens = np.zeros(B, np.int32)
    rounds = []
    for C, chunks in SCHEDULE:
        chunk_lens = np.asarray(chunks, np.int32)
        tokens = np.zeros((B, C), np.int32)
        for b, c in enumerate(chunks):
            tokens[b, :c] = rng.integers(1, jcfg.vocab_size, c)
        tables = np.full((B, MAX_PAGES), sink, np.int32)
        for b in range(B):
            n = -(-int(lens[b] + chunk_lens[b]) // PAGE_SIZE)
            tables[b, :n] = ids[b, :n]
        jlogits, jcache = jstep(
            jparams, jnp.asarray(tokens), jcache, jnp.asarray(lens),
            jnp.asarray(chunk_lens), jnp.asarray(tables), kv_layout="fused")
        targs = (torch.from_numpy(tokens), None, torch.from_numpy(lens),
                 torch.from_numpy(chunk_lens), torch.from_numpy(tables))
        flogits = timpl.chunked_step_paged(tparams, targs[0], fcache,
                                           *targs[2:])
        slogits = timpl.chunked_step_paged(tparams, targs[0], scache,
                                           *targs[2:])
        live = chunk_lens > 0
        rounds.append((np.asarray(jlogits, np.float32)[live],
                       flogits.float().numpy()[live],
                       slogits.float().numpy()[live]))
        lens = lens + chunk_lens
    pools = (np.asarray(jcache["kv"], np.float32), fcache["kv"].float().numpy(),
             (scache["k"].float().numpy(), scache["v"].float().numpy()))
    return rounds, pools


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,overrides", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_chunked_step_paged_fused_matches_jax_and_split(rng, name, overrides,
                                                       dtype):
    rounds, (jpool, fpool, (sk, sv)) = _run_fused_schedule(
        name, dtype, rng, overrides)
    # f32: the JAX step's own tolerance against the port (test_torch_model);
    # bf16: accumulation-order tolerance (tests/test_engine.py:52-55)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else dict(
        atol=0.25, rtol=0.05)
    for want, fused, split in rounds:
        np.testing.assert_allclose(fused, want, **tol)
        # the layout is data movement: the port's two steps agree to f32
        # rounding of the same sums
        np.testing.assert_allclose(fused, split, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(fpool, jpool, **tol)
    # un-interleaved, the fused pool holds exactly the split pools' K and V
    np.testing.assert_array_equal(fpool[:, :, :, 0::2], sk)
    np.testing.assert_array_equal(fpool[:, :, :, 1::2], sv)


# -- (c) serve() on the fused layout ---------------------------------------------
WORKLOAD = dict(n_requests=6, inter_arrival_s=0.01, max_context=100,
                max_new_tokens=8, seed=7)
ENGINE = dict(n_slots=8, max_context=256)
SCHED = dict(policy="aging", token_budget=48, max_seqs=8)


@pytest.fixture(scope="module")
def weights():
    """Tiny f32 qwen JAX params (PRNGKey 3, the seed the JAX fleet of (c)
    inits from), and the same weights in the port."""
    jcfg = jax_tiny_config("qwen1.5-0.5b").with_(param_dtype="float32")
    tcfg = tiny_config("qwen1.5-0.5b").with_(param_dtype="float32")
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(3))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, tcfg, from_jax_params(np_params, tcfg, device="cpu")


def _torch_serve(cfg, params, *, kv_layout, pipelined):
    eng = TorchEngine(cfg, EngineConfig(pipelined=pipelined,
                                        kv_layout=kv_layout, **ENGINE),
                      params=params, device="cpu")
    reqs = sharegpt_like(WorkloadSpec(**WORKLOAD))
    attach_prompt_tokens(reqs, cfg.vocab_size)
    res = serve(reqs, ChunkedPrefillScheduler(SchedulerConfig(**SCHED)), eng)
    assert res.report.n_finished == len(reqs)
    assert tuple(eng.cache) == (("kv",) if kv_layout == "fused" else ("k", "v"))
    return [res.outputs[r.req_id] for r in reqs]


@pytest.mark.parametrize("pipelined", [True, False], ids=["pipelined", "sync"])
def test_fused_serve_matches_split(weights, pipelined):
    _, _, tcfg, tparams = weights
    fused = _torch_serve(tcfg, tparams, kv_layout="fused", pipelined=pipelined)
    split = _torch_serve(tcfg, tparams, kv_layout="split", pipelined=pipelined)
    assert any(t != 0 for out in fused for t in out)
    assert fused == split


def test_fused_serve_matches_jax_fused_engine(weights):
    jcfg, jparams, tcfg, tparams = weights
    jeng = JAXEngine(jcfg, JaxEngineConfig(pipelined=False, kv_layout="fused",
                                           **ENGINE), params=jparams)
    jreqs = jax_sharegpt_like(JaxWorkloadSpec(**WORKLOAD))
    jax_attach(jreqs, jcfg.vocab_size)
    jres = jax_serve(jreqs, JaxScheduler(JaxSchedulerConfig(**SCHED)), jeng)
    want = [jres.outputs[r.req_id] for r in jreqs]
    got = _torch_serve(tcfg, tparams, kv_layout="fused", pipelined=False)
    assert got == want


PRESSURE_ENGINE = dict(n_slots=6, max_context=128, seed=3)


def _two_wave(make, seed=5, n=12, new_tokens=10):
    """The JAX package's two-wave pressure workload (t=0 and far behind):
    round structure independent of wall-clock timing."""
    reqs = make(n_requests=n, n_prefixes=2, prefix_len=48,
                suffix_range=(8, 16), max_new_tokens=new_tokens,
                inter_arrival_s=0.0, vocab_size=512, seed=seed)
    for i, r in enumerate(reqs):
        r.arrival_time = 0.0 if i < n // 2 else 60.0
    return reqs


def _pressured(jax_side, cfg, params, *, kv_layout="fused", mode="swap",
               pipelined=False, n_blocks=11, host_kv_dtype="auto"):
    """Serve the two-wave workload on an 11-block pool; returns (outputs by
    workload position, scheduler stats)."""
    if jax_side:
        eng = JAXEngine(cfg, JaxEngineConfig(
            pipelined=pipelined, preemption_mode=mode, kv_layout=kv_layout,
            **PRESSURE_ENGINE), params=params)
        Pool, PCfg, Sched, SCfg, run, make = (
            JaxPool, JaxPoolConfig, JaxScheduler, JaxSchedulerConfig,
            jax_serve, jax_shared_prefix)
    else:
        eng = TorchEngine(cfg, EngineConfig(
            pipelined=pipelined, preemption_mode=mode, kv_layout=kv_layout,
            **PRESSURE_ENGINE), params=params, device="cpu")
        Pool, PCfg, Sched, SCfg, run, make = (
            KVBlockPool, KVPoolConfig, ChunkedPrefillScheduler,
            SchedulerConfig, serve, shared_prefix)
    pool = Pool(PCfg(n_blocks=n_blocks, block_size=16, bytes_per_token=4,
                     enable_prefix_cache=True, host_kv_dtype=host_kv_dtype))
    sched = Sched(SCfg(policy="fcfs", token_budget=96, max_seqs=6))
    reqs = _two_wave(make)
    res = run(reqs, sched, eng, kv_pool=pool)
    pool.check_invariants()
    assert not pool.swapped_requests()
    assert res.report.n_finished == len(reqs)
    return [res.outputs[r.req_id] for r in reqs], sched.stats


@pytest.mark.parametrize("pipelined", [True, False], ids=["pipelined", "sync"])
def test_fused_swap_matches_recompute_and_split(weights, pipelined):
    """Mirrors tests/test_swap_preemption.py::
    test_fused_layout_swap_outputs_bit_identical: forced swap preemptions on
    the fused pool, with single-tensor payloads, change no token."""
    _, _, tcfg, tparams = weights
    swap, st = _pressured(False, tcfg, tparams, pipelined=pipelined)
    recompute, st_r = _pressured(False, tcfg, tparams, mode="recompute",
                                 pipelined=pipelined)
    split, _ = _pressured(False, tcfg, tparams, kv_layout="split",
                          pipelined=pipelined)
    assert st.swap_preemptions > 0
    assert st.swap_restores == st.swap_preemptions
    assert st_r.preemptions > 0 and st_r.swap_preemptions == 0
    assert any(t != 0 for out in swap for t in out)
    assert swap == recompute == split


def test_fused_int8_tier_matches_split_and_jax(weights):
    """The INT8 host tier on the fused pool: per-page-per-head scales over
    the 2*Hkv interleaved heads quantize K and V heads apart, exactly as
    the split tier does, so the tokens equal the split tier's and the JAX
    fused tier's."""
    jcfg, jparams, tcfg, tparams = weights
    got, st = _pressured(False, tcfg, tparams, host_kv_dtype="int8")
    split, _ = _pressured(False, tcfg, tparams, kv_layout="split",
                          host_kv_dtype="int8")
    want, jst = _pressured(True, jcfg, jparams, host_kv_dtype="int8")
    assert st.swap_preemptions > 0
    for name in ("preemptions", "swap_preemptions", "swap_restores"):
        assert getattr(st, name) == getattr(jst, name), name
    assert got == split == want


def test_disagg_fused_matches_single_engine(weights):
    """Mirrors tests/test_disagg.py::test_disagg_fused_layout_outputs_identical:
    every handoff moves a one-entry fused payload through the gather, the
    handoff store and the scatter into the decode replica, with swap
    preemptions racing the handoffs on the 9-block pools; the tokens equal
    one unconstrained engine's (tests/test_torch_disagg.py holds the split
    fleet to the same engine)."""
    _, _, tcfg, tparams = weights
    router = build_disagg(
        tcfg, cfg=DisaggConfig(),
        engine_cfg=EngineConfig(pipelined=True, preemption_mode="swap",
                                kv_layout="fused", **PRESSURE_ENGINE),
        sched_cfg=SchedulerConfig(policy="fcfs", token_budget=96, max_seqs=6),
        n_blocks=9, block_size=16, params=tparams, device="cpu")
    reqs = _two_wave(shared_prefix, new_tokens=24)
    res = serve_disagg(reqs, router)
    router.check_invariants()
    assert res.handoffs == len(reqs) and res.colocated == 0
    assert sum(rs.sched.stats.scheduled_prefill_tokens
               for rs in router.decode) == 0
    assert sum(rs.sched.stats.preemptions for rs in router.replicas) > 0
    assert all(tuple(rs.engine.cache) == ("kv",) for rs in router.replicas)
    fused = [res.outputs[r.req_id] for r in reqs]

    eng = TorchEngine(tcfg, EngineConfig(**PRESSURE_ENGINE), params=tparams,
                      device="cpu")
    pool = KVBlockPool(KVPoolConfig(n_blocks=400, block_size=16,
                                    bytes_per_token=4, enable_prefix_cache=True))
    reqs = _two_wave(shared_prefix, new_tokens=24)
    res = serve(reqs, ChunkedPrefillScheduler(SchedulerConfig(
        policy="fcfs", token_budget=96, max_seqs=6)), eng, kv_pool=pool)
    single = [res.outputs[r.req_id] for r in reqs]
    assert any(t != 0 for out in fused for t in out)
    assert fused == single


@pytest.mark.parametrize("staged,restored", [("split", "fused"),
                                             ("fused", "split")])
def test_payload_of_the_other_layout_is_refused(weights, staged, restored):
    """A swap payload carries one staged array per cache tensor: a split
    payload (K, V) cannot restore into a fused engine's single pool, nor a
    fused one into a split engine."""
    _, _, tcfg, tparams = weights

    def engine(layout):
        eng = TorchEngine(tcfg, EngineConfig(preemption_mode="swap",
                                             kv_layout=layout,
                                             **PRESSURE_ENGINE),
                          params=tparams, device="cpu")
        pool = KVBlockPool(KVPoolConfig(n_blocks=16, block_size=16,
                                        bytes_per_token=4))
        eng.bind_kv_pool(pool)
        return eng, pool

    src, src_pool = engine(staged)
    req = Request(prompt_len=20, max_new_tokens=4, arrival_time=0.0,
                  prompt_tokens=list(range(1, 21)))
    src_pool.register_request(req.req_id, prompt_len=20)
    src_pool.allocate(req.req_id, 20)
    assert src.acquire_slot(req)
    src.drain(src.dispatch(ScheduledBatch(round_idx=0,
                                          prefill_chunks=[(req, 20)])))
    src.swap_out(req)
    src.finalize_swaps()
    payload = src_pool._swap[req.req_id].payload
    assert len(payload) == (1 if staged == "fused" else 2)

    dst, dst_pool = engine(restored)
    dst_pool.register_request(req.req_id, prompt_len=20)
    dst_pool.allocate(req.req_id, 20)
    assert dst.acquire_slot(req)
    with pytest.raises(AssertionError, match="different kv_layout"):
        dst.swap_in(req, payload)
