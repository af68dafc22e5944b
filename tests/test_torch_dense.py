"""The port's dense-KV A/B path and its three kernels' plain versions on the
CPU, against the JAX package.

(a) The plain versions a CPU tensor takes -- ``chunked_prefill_attention``,
    ``decode_attention`` and ``fused_swiglu`` -- against the reference's jnp
    oracles and its Pallas kernels in interpret mode, on the shapes of
    tests/test_kernels.py at that file's tolerances; the dense attention on
    a ``cache[:, :-1]`` view (the engine's, not contiguous) as on a copy.
(b) ``TransformerLM.chunked_step``: logits and caches against the JAX step
    over a 4-round mixed schedule (tiny qwen and GQA llama, f32 and bf16).
(c) greedy ``serve()`` with ``paged_kv=False``: equal to
    ``JAXEngine(paged_kv=False)`` in f32; equal to the port's paged engine
    on the two-wave shared-prefix case (preemptions and prefix hits both
    happen); dense swap == recompute == unconstrained; pipelined == sync;
    the INT8 host tier refused; ``--dense-kv`` through the serve CLI.

The CUDA kernels need nvcc and a card; ``chip_smoke.py`` holds them against
these plain versions, and the dense attention kernels bitwise against the
paged ones, on the GPU.
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
from repro.kernels.chunked_prefill_attention import (
    chunked_prefill_attention as pallas_chunked_prefill,
)
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.fused_swiglu import fused_swiglu as pallas_swiglu
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import tiny_config
from repro_torch.core.scheduler import ChunkedPrefillScheduler, SchedulerConfig
from repro_torch.engine.engine import EngineConfig, TorchEngine, serve
from repro_torch.engine.kv_cache import KVBlockPool, KVPoolConfig
from repro_torch.engine.workload import shared_prefix
from repro_torch.kernels.chunked_prefill_attention import (
    chunked_prefill_attention,
)
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.fused_swiglu import fused_swiglu
from repro_torch.kernels.ref import fused_swiglu_ref
from repro_torch.launch import serve as serve_cli
from repro_torch.models.model import build_model as torch_build_model
from repro_torch.weights import from_jax_params

# tests/test_kernels.py's tolerances
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run as fast on one intra-op thread, and several test
    workers sharing the CPU do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, shape, dtype):
    """tests/test_kernels.py's inputs: numpy normals cast to the dtype in
    JAX; the port gets the same values."""
    return jnp.asarray(rng.standard_normal(shape), JDT[dtype])


def _t(a):
    """The same values as a torch CPU tensor (bf16 converts exactly)."""
    t = torch.from_numpy(np.array(a, np.float32))
    return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _sink_view(a):
    """A torch copy of cache ``a`` (B, S, H, hd) inside a (B, S + 1, H, hd)
    tensor whose last row holds garbage, returned as the ``[:, :-1]`` view
    the engine passes."""
    t = _t(a)
    full = torch.full((t.shape[0], t.shape[1] + 1) + tuple(t.shape[2:]),
                      float("nan"), dtype=t.dtype)
    full[:, :-1] = t
    view = full[:, :-1]
    assert view.shape[0] == 1 or not view.is_contiguous()
    return view


# -- (a) the plain versions against the oracles and the Pallas kernels ----------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,Sq,Skv,Hq,Hkv,hd,blk_q,blk_k",
    [
        (1, 64, 128, 4, 4, 32, 32, 64),      # MHA
        (2, 128, 256, 8, 2, 64, 64, 128),    # GQA g=4
        (1, 32, 96, 8, 1, 64, 32, 32),       # MQA
        (3, 64, 64, 4, 4, 128, 64, 64),      # hd=128, self only
        (2, 256, 256, 2, 2, 16, 128, 128),   # long chunk
    ],
)
def test_chunked_prefill_plain_matches_jax(rng, dtype, B, Sq, Skv, Hq, Hkv,
                                           hd, blk_q, blk_k):
    q = _rand(rng, (B, Sq, Hq, hd), dtype)
    k = _rand(rng, (B, Skv, Hkv, hd), dtype)
    v = _rand(rng, (B, Skv, Hkv, hd), dtype)
    q_off = jnp.asarray(rng.integers(0, Skv - Sq + 1, B), jnp.int32)
    kv_lens = q_off + Sq
    targs = (torch.from_numpy(np.array(kv_lens)),
             torch.from_numpy(np.array(q_off)))
    got = chunked_prefill_attention(_t(q), _t(k), _t(v), *targs)
    strided = chunked_prefill_attention(_t(q), _sink_view(k), _sink_view(v),
                                        *targs)
    oracle = jref.chunked_prefill_attention_ref(q, k, v, kv_lens, q_off)
    pallas = pallas_chunked_prefill(q, k, v, kv_lens, q_off, block_q=blk_q,
                                    block_k=blk_k)
    assert got.dtype == _t(q).dtype
    np.testing.assert_array_equal(_np(strided), _np(got))
    for want in (oracle, pallas):
        np.testing.assert_allclose(_np(got), _np(want), atol=TOLS[dtype],
                                   rtol=TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,Hq,Hkv,hd,S,blk",
    [
        (1, 4, 4, 32, 128, 64),
        (4, 8, 2, 64, 512, 128),
        (2, 8, 1, 128, 256, 256),
        (3, 16, 4, 64, 384, 128),
        (2, 24, 2, 128, 256, 128),   # group 12 (mistral-large-123b)
        (2, 48, 1, 128, 256, 128),   # group 48 (granite-34b, MQA)
    ],
)
def test_decode_plain_matches_jax(rng, dtype, B, Hq, Hkv, hd, S, blk):
    q = _rand(rng, (B, Hq, hd), dtype)
    k = _rand(rng, (B, S, Hkv, hd), dtype)
    v = _rand(rng, (B, S, Hkv, hd), dtype)
    lens = jnp.asarray(rng.integers(1, S + 1, B), jnp.int32)
    tlens = torch.from_numpy(np.array(lens))
    got = decode_attention(_t(q), _t(k), _t(v), tlens)
    strided = decode_attention(_t(q), _sink_view(k), _sink_view(v), tlens)
    oracle = jref.decode_attention_ref(q, k, v, lens)
    pallas = pallas_decode(q, k, v, lens, block_k=blk)
    np.testing.assert_array_equal(_np(strided), _np(got))
    for want in (oracle, pallas):
        np.testing.assert_allclose(_np(got), _np(want), atol=TOLS[dtype],
                                   rtol=TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "M,D,F,bm,bf",
    [
        (64, 32, 128, 32, 64),
        (128, 96, 256, 64, 128),
        (256, 128, 512, 128, 256),
        (32, 64, 64, 32, 64),
    ],
)
def test_fused_swiglu_plain_matches_jax(rng, dtype, M, D, F, bm, bf):
    """The plain version rounds the hidden activations to x's dtype, as the
    Pallas kernel does.  In f32 it is within TOLS of the interpret-mode
    kernel.  In bf16 the two round the hidden tile from f32 sums taken in
    another order, so a hidden value next to a rounding boundary may round
    the other way, one bf16 step, moving output k by that step times
    |Wd_fk|.  chip_smoke.py's gates for the CUDA kernel account for those
    values exactly, and so does this test: the Pallas kernel's own hidden
    values, read back through a down projection that selects D of them per
    call, are each within one bf16 step of the float64 hidden (as the plain
    version's are), and the plain output is within one output rounding step
    (2**-7 |x|) of the kernel's plus ``|h_kernel - h_plain| @ |Wd|``.  Both
    are within the reference's own 5 x TOLS of the f32-hidden oracle
    (tests/test_kernels.py)."""
    s = 0.1
    x = _rand(rng, (M, D), dtype)
    wg = _rand(rng, (D, F), dtype) * s
    wu = _rand(rng, (D, F), dtype) * s
    wd = _rand(rng, (F, D), dtype) * s
    targs = [_t(a) for a in (x, wg, wu, wd)]
    got = _np(fused_swiglu(*targs))
    kernel = np.asarray(pallas_swiglu(x, wg, wu, wd, block_m=bm, block_f=bf),
                        np.float32)
    oracle = np.asarray(jref.fused_swiglu_ref(x, wg, wu, wd), np.float32)
    if dtype == "bfloat16":
        h_kernel = []
        for f0 in range(0, F, D):
            n = min(D, F - f0)
            sel = np.zeros((F, D), np.float32)
            sel[f0 + np.arange(n), np.arange(n)] = 1
            out = pallas_swiglu(x, wg, wu, jnp.asarray(sel, JDT[dtype]),
                                block_m=bm, block_f=bf)
            h_kernel.append(np.asarray(out, np.float32)[:, :n])
        h_kernel = np.concatenate(h_kernel, 1)
        def hidden(x_, wg_, wu_):
            g = x_ @ wg_
            return _np((g * torch.sigmoid(g) * (x_ @ wu_)).to(torch.bfloat16))

        h_exact = hidden(*(a.double() for a in targs[:3]))
        h_plain = hidden(*(a.float() for a in targs[:3]))
        h_step = 1e-5 + 2.0 ** -7 * np.abs(h_exact)
        for h in (h_kernel, h_plain):
            assert (np.abs(h - h_exact) <= h_step).all()
        moved = np.abs(h_kernel - h_plain) @ np.abs(_np(targs[3]))
        step = 1e-5 + 2.0 ** -7 * np.abs(kernel)
        assert (np.abs(got - kernel) <= step + moved).all()
    else:
        np.testing.assert_allclose(got, kernel, atol=TOLS[dtype],
                                   rtol=TOLS[dtype])
    np.testing.assert_allclose(got, oracle, atol=5 * TOLS[dtype],
                               rtol=5 * TOLS[dtype])
    # the port's oracle is the reference's, to f32 rounding
    np.testing.assert_allclose(_np(fused_swiglu_ref(*targs)), oracle,
                               atol=TOLS[dtype], rtol=TOLS[dtype])


# -- (b) the dense chunked step against the JAX step -----------------------------
# slot -> chunk_len per round; 1 after the prefill is a decode, 0 an idle
# slot.  Round 3 is a pure-decode round (bucket C == 1).
SCHEDULE = [
    (16, (16, 10, 0, 5)),
    (16, (12, 1, 16, 1)),
    (1, (1, 1, 0, 1)),
    (32, (1, 0, 20, 1)),
]
MAX_CTX = 64
CONFIGS = [
    ("qwen1.5-0.5b", {}),                   # QKV bias, MHA
    ("llama3.2-1b", {"n_kv_heads": 2}),     # GQA, group 2
]


def _params(cfg, rng):
    """JAX init params as numpy, with random biases and norm weights (init
    makes them zeros and ones)."""
    params = jax.tree_util.tree_map(
        np.asarray, jax_build_model(cfg).init(jax.random.PRNGKey(0)))
    layers = params["layers"]
    for name in ("attn_norm", "ffn_norm"):
        layers[name] = (1 + 0.1 * rng.standard_normal(layers[name].shape)
                        ).astype(layers[name].dtype)
    for name in ("bq", "bk", "bv"):
        if name in layers["attn"]:
            a = layers["attn"][name]
            layers["attn"][name] = (0.5 * rng.standard_normal(a.shape)
                                    ).astype(a.dtype)
    return params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,overrides", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_chunked_step_matches_jax(rng, name, overrides, dtype):
    jcfg = jax_tiny_config(name).with_(param_dtype=dtype, **overrides)
    tcfg = tiny_config(name).with_(param_dtype=dtype, **overrides)
    np_params = _params(jcfg, rng)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    tparams = from_jax_params(np_params, tcfg, device="cpu")
    jstep = jax.jit(jax_build_model(jcfg).impl.chunked_step)
    timpl = torch_build_model(tcfg).impl
    B = len(SCHEDULE[0][1])
    shape = (jcfg.n_layers, B, MAX_CTX + 1, jcfg.n_kv_heads,
             jcfg.resolved_head_dim)
    jcache = {n: jnp.zeros(shape, JDT[dtype]) for n in ("k", "v")}
    tcache = {n: torch.zeros(shape, dtype=getattr(torch, dtype))
              for n in ("k", "v")}
    # f32: the paged step's tolerance against the JAX step
    # (test_torch_model); bf16: accumulation order (tests/test_engine.py)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else dict(
        atol=0.25, rtol=0.05)
    lens = np.zeros(B, np.int32)
    for C, chunks in SCHEDULE:
        chunk_lens = np.asarray(chunks, np.int32)
        tokens = np.zeros((B, C), np.int32)
        for b, c in enumerate(chunks):
            tokens[b, :c] = rng.integers(1, jcfg.vocab_size, c)
        jlogits, jcache = jstep(jparams, jnp.asarray(tokens), jcache,
                                jnp.asarray(lens), jnp.asarray(chunk_lens))
        tlogits = timpl.chunked_step(tparams, torch.from_numpy(tokens),
                                     tcache, torch.from_numpy(lens),
                                     torch.from_numpy(chunk_lens))
        live = chunk_lens > 0
        np.testing.assert_allclose(_np(tlogits)[live],
                                   np.asarray(jlogits, np.float32)[live], **tol)
        lens = lens + chunk_lens
    for n in ("k", "v"):
        # the sink rows differ by design: the port writes zeros there, the
        # reference the padding lanes' values (NaN for idle slots)
        np.testing.assert_allclose(_np(tcache[n])[:, :, :-1],
                                   np.asarray(jcache[n], np.float32)[:, :, :-1],
                                   **tol)
        assert not tcache[n][:, :, -1].any()


# -- (c) serve() on the dense layout ----------------------------------------------
ENGINE = dict(n_slots=6, max_context=128, seed=3)


@pytest.fixture(scope="module")
def weights():
    """Tiny f32 qwen JAX params (PRNGKey 3), and the same weights in the
    port."""
    jcfg = jax_tiny_config("qwen1.5-0.5b").with_(param_dtype="float32")
    tcfg = tiny_config("qwen1.5-0.5b").with_(param_dtype="float32")
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(3))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, tcfg, from_jax_params(np_params, tcfg, device="cpu")


def _two_wave(make, seed=5, n=12, new_tokens=10):
    """The reference's paged-vs-dense workload (tests/test_engine.py): two
    deterministic waves of shared-prefix requests; the second arrives after
    the first sealed its prefix blocks, so prefix restores happen."""
    reqs = make(n_requests=n, n_prefixes=2, prefix_len=48,
                suffix_range=(8, 16), max_new_tokens=new_tokens,
                inter_arrival_s=0.0, vocab_size=512, seed=seed)
    for i, r in enumerate(reqs):
        r.arrival_time = 0.0 if i < n // 2 else 60.0
    return reqs


def _serve(cfg, params, *, jax_side=False, paged=False, pipelined=False,
           mode="recompute", n_blocks=11):
    """The two-wave workload on an 11-block pool (preemption forced) with
    the prefix cache on; returns (outputs by workload position, scheduler
    stats, pool stats)."""
    if jax_side:
        eng = JAXEngine(cfg, JaxEngineConfig(paged_kv=paged,
                                             pipelined=pipelined,
                                             preemption_mode=mode, **ENGINE),
                        params=params)
        Pool, PCfg, Sched, SCfg, run, make = (
            JaxPool, JaxPoolConfig, JaxScheduler, JaxSchedulerConfig,
            jax_serve, jax_shared_prefix)
    else:
        eng = TorchEngine(cfg, EngineConfig(paged_kv=paged,
                                            pipelined=pipelined,
                                            preemption_mode=mode, **ENGINE),
                          params=params, device="cpu")
        Pool, PCfg, Sched, SCfg, run, make = (
            KVBlockPool, KVPoolConfig, ChunkedPrefillScheduler,
            SchedulerConfig, serve, shared_prefix)
    pool = Pool(PCfg(n_blocks=n_blocks, block_size=16, bytes_per_token=4,
                     enable_prefix_cache=True))
    sched = Sched(SCfg(policy="fcfs", token_budget=96, max_seqs=6))
    reqs = _two_wave(make)
    res = run(reqs, sched, eng, kv_pool=pool)
    pool.check_invariants()
    assert not pool.swapped_requests()
    assert res.report.n_finished == len(reqs)
    if not jax_side:
        assert (eng.block_tables is None) == (not paged)
        assert not eng.slot_of
    return [res.outputs[r.req_id] for r in reqs], sched.stats, pool.stats


def test_dense_serve_matches_jax_dense_engine(weights):
    jcfg, jparams, tcfg, tparams = weights
    got, st, pst = _serve(tcfg, tparams)
    want, jst, jpst = _serve(jcfg, jparams, jax_side=True)
    assert st.preemptions == jst.preemptions > 0
    assert pst.hit_tokens == jpst.hit_tokens > 0
    assert any(t != 0 for out in got for t in out)
    assert got == want


def test_dense_matches_paged_with_preemption_and_prefix_hits(weights):
    """tests/test_engine.py's paged == dense identity inside the port:
    preemptions and prefix-cache restores happen in both layouts (the dense
    one copies parked block payloads into the slot)."""
    _, _, tcfg, tparams = weights
    dense, st_d, pst_d = _serve(tcfg, tparams)
    paged, st_p, pst_p = _serve(tcfg, tparams, paged=True)
    assert st_d.preemptions > 0 and st_p.preemptions > 0
    assert pst_d.hit_tokens > 0 and pst_p.hit_tokens > 0
    assert dense == paged


def test_dense_swap_matches_recompute_and_unconstrained(weights):
    _, _, tcfg, tparams = weights
    swap, st_s, _ = _serve(tcfg, tparams, mode="swap")
    recompute, st_r, _ = _serve(tcfg, tparams)
    free, st_u, _ = _serve(tcfg, tparams, n_blocks=400)
    assert st_s.swap_preemptions > 0
    assert st_s.swap_restores == st_s.swap_preemptions
    assert st_r.preemptions > 0 and st_r.swap_preemptions == 0
    assert st_u.preemptions == 0
    assert swap == recompute == free


@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_dense_pipelined_matches_sync(weights, mode):
    _, _, tcfg, tparams = weights
    piped, st, _ = _serve(tcfg, tparams, pipelined=True, mode=mode)
    sync, _, _ = _serve(tcfg, tparams, mode=mode)
    assert st.preemptions > 0
    assert piped == sync


def test_dense_refuses_the_int8_host_tier(weights):
    """As in the reference: the quantized swap kernels are page-shaped."""
    _, _, tcfg, tparams = weights
    eng = TorchEngine(tcfg, EngineConfig(paged_kv=False, **ENGINE),
                      params=tparams, device="cpu")
    pool = KVBlockPool(KVPoolConfig(n_blocks=16, block_size=16,
                                    bytes_per_token=4, host_kv_dtype="int8"))
    with pytest.raises(RuntimeError, match="requires paged_kv"):
        eng.bind_kv_pool(pool)
    with pytest.raises(AssertionError, match="requires paged_kv"):
        TorchEngine(tcfg, EngineConfig(paged_kv=False, kv_layout="fused",
                                       **ENGINE), params=tparams,
                    device="cpu")


@pytest.mark.parametrize("disagg", [False, True], ids=["colocated", "disagg"])
def test_serve_cli_dense_kv_builds_and_serves(capsys, disagg):
    flags = ["--device", "cpu", "--dense-kv", "--n-requests", "3",
             "--preemption-mode", "swap"] + (["--disagg"] if disagg else [])
    res = serve_cli.main(flags)
    assert res.report.n_finished == 3
    out = capsys.readouterr().out
    assert "kv=dense" in out
    args = serve_cli.build_parser().parse_args(flags)
    if disagg:
        router, _ = serve_cli.build_fleet(args)
        engines = [rs.engine for rs in router.replicas]
    else:
        engines = [serve_cli.build(args)[0]]
    for eng in engines:
        assert not eng.cfg.paged_kv and eng.block_tables is None
        assert tuple(eng.cache) == ("k", "v")
        assert eng.cache["k"].shape[1:3] == (16, 513)
