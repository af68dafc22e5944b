"""The port's whole-sequence attention and ``TransformerLM`` entry points
(``prefill``, ``decode`` with the sliding-window ring cache,
``train_hidden``, ``cache_struct``) on the CPU against the JAX package.

(a) ``attention_naive`` and ``flash_attention`` against
    ``repro.models.layers``' on numpy-made inputs: causal, a scalar and a
    per-row ``q_offset``, ``kv_lens``, a sliding window, ring positions
    with ``INVALID_POS``, GQA groups 1, 2 and 4, Sq > 512 (the naive path's
    query chunks), small flash blocks (several of each), a row with no
    valid key (naive: the uniform mean of V; flash: 0); f32 within 1e-5,
    bf16 within the reference's bf16 bar (atol 0.25 / rtol 0.05,
    tests/test_engine.py:52-55); ``attention``'s dispatch.
(b) ``Model.prefill`` / ``decode`` / ``train_hidden`` / ``cache_struct``
    for tiny llama3.2-1b, qwen1.5-0.5b, arctic-480b, llava-next-mistral-7b
    (with patch embeddings) and mixtral-8x7b (the ring at S = 48 > W = 32
    and S = 20 < W) on the JAX init converted to the port, f32: logits and
    hidden states within 1e-5, caches within 1e-5 and ``kv_pos`` equal;
    decode starts from the reference's own cache (``cache_from_jax``); a
    linear cache's write at ``lens == S`` is dropped.
(c) the port's mirrors of tests/test_engine.py's
    ``test_chunked_step_equals_whole_prefill`` and
    ``test_chunked_step_mixed_decode_and_prefill`` and of
    tests/test_models_smoke.py's ``test_smoke_prefill_decode`` (dense, moe,
    vlm) and ``test_sliding_window_ring_cache_decode``, on the port's own
    seeded bf16 weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tiny_config as jax_tiny_config
from repro.models import layers as jL
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import tiny_config
from repro_torch.models import layers as L
from repro_torch.models.model import build_model
from repro_torch.weights import cache_from_jax, from_jax_params

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=0.25, rtol=0.05)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run as fast on one intra-op thread, and several test
    workers sharing the CPU do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _both(a, dtype):
    """A numpy array as (jnp array, torch tensor) in ``dtype``."""
    j = jnp.asarray(a).astype(jnp.dtype(dtype))
    t = torch.from_numpy(np.asarray(a)).to(getattr(torch, dtype))
    return j, t


# ---------------------------------------------------------------------------
# (a) the two attentions against the reference's
# ---------------------------------------------------------------------------

# (name, B, Sq, Skv, Hq, Hkv, hd, kwargs); kwargs hold numpy arrays, which
# go to both sides (ints stay ints)
def _ring_positions(B, W, lens):
    """Ring slots holding each row's last ``min(len, W)`` positions at
    ``pos % W`` and ``INVALID_POS`` in the unwritten ones."""
    kp = np.full((B, W), jL.INVALID_POS, np.int32)
    for b, n in enumerate(lens):
        for p in range(max(0, n - W), n):
            kp[b, p % W] = p
    return kp


ATTN_CASES = [
    ("causal_g1", 2, 24, 24, 4, 4, 16, {}),
    ("offset_scalar_g2", 2, 8, 40, 4, 2, 16, {"q_offset": 32}),
    ("offset_rows_kv_lens_g4", 3, 5, 40, 8, 2, 16,
     {"q_offset": np.array([3, 20, 35], np.int32),
      "kv_lens": np.array([8, 25, 40], np.int32)}),
    ("decode_rows_g4", 3, 1, 32, 4, 1, 16,
     {"q_offset": np.array([0, 17, 31], np.int32),
      "kv_lens": np.array([1, 18, 32], np.int32)}),
    ("window_g2", 2, 48, 48, 4, 2, 16, {"sliding_window": 16}),
    ("ring_invalid_g2", 3, 1, 16, 4, 2, 16,
     {"q_offset": np.array([5, 16, 40], np.int32), "sliding_window": 16,
      "kv_positions": _ring_positions(3, 16, [6, 17, 41])}),
    ("long_chunks_g2", 1, 640, 640, 2, 1, 16, {}),
    ("long_window_g1", 1, 576, 576, 2, 2, 8, {"sliding_window": 100}),
    ("flash_blocks_g4", 2, 48, 48, 8, 2, 16,
     {"kv_lens": np.array([48, 30], np.int32), "block_q": 16, "block_k": 8}),
    ("flash_blocks_window_g1", 2, 64, 64, 2, 2, 16,
     {"sliding_window": 12, "block_q": 8, "block_k": 16}),
]


def _attn_inputs(rng, B, Sq, Skv, Hq, Hkv, hd):
    return (rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32))


def _kwargs(kw, impl, as_torch):
    out = {}
    for k, v in kw.items():
        if impl == "naive" and k in ("block_q", "block_k"):
            continue
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v) if as_torch else jnp.asarray(v)
        out[k] = v
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["naive", "flash"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_attention_matches_jax(case, impl, dtype):
    _, B, Sq, Skv, Hq, Hkv, hd, kw = case
    rng = np.random.default_rng(Sq * 1000 + Skv)
    arrays = [_both(a, dtype) for a in _attn_inputs(rng, B, Sq, Skv, Hq,
                                                    Hkv, hd)]
    jfn = jL.attention_naive if impl == "naive" else jL.flash_attention
    tfn = L.attention_naive if impl == "naive" else L.flash_attention
    want = jfn(*(a[0] for a in arrays), **_kwargs(kw, impl, False))
    got = tfn(*(a[1] for a in arrays), **_kwargs(kw, impl, True))
    assert got.shape == (B, Sq, Hq, hd) and str(got.dtype)[6:] == dtype
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_pick_chunk_splits_long_queries():
    assert L._pick_chunk(512) == 512
    assert L._pick_chunk(640) == 320
    assert L._pick_chunk(4352) == jL._pick_chunk(4352) == 272
    assert L._pick_chunk(8192, L.FLASH_BLOCK_Q) == 1024
    for s in (1, 48, 513, 521, 1000, 8192):   # 521: a prime, chunks of 1
        assert L._pick_chunk(s) == jL._pick_chunk(s)
        assert L._pick_chunk(s, 16) == jL._pick_chunk(s, 16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fully_masked_row_naive_mean_flash_zero(dtype):
    """A row whose kv_lens is 0: the naive path's -1e30 scores soften to the
    uniform mean of V (in f32, then rounded), the flash path's -inf guards
    return 0; both as the reference."""
    rng = np.random.default_rng(7)
    q, k, v = (_both(a, dtype) for a in _attn_inputs(rng, 2, 4, 12, 4, 2, 16))
    lens = np.array([12, 0], np.int32)
    kw = dict(q_offset=np.array([8, 0], np.int32), kv_lens=lens)
    for impl, jfn, tfn in (("naive", jL.attention_naive, L.attention_naive),
                           ("flash", jL.flash_attention, L.flash_attention)):
        got = tfn(q[1], k[1], v[1], **_kwargs(kw, impl, True))
        want = jfn(q[0], k[0], v[0], **_kwargs(kw, impl, False))
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
        row = _np(got)[1]                             # (Sq, Hq, hd)
        if impl == "flash":
            assert (row == 0).all()
        else:
            mean = v[1][1].float().mean(dim=0).numpy()   # (Hkv, hd)
            np.testing.assert_allclose(
                row, np.repeat(mean, 2, axis=0)[None].repeat(4, 0),
                atol=1e-5 if dtype == "float32" else 2e-2)


def test_attention_dispatch(monkeypatch):
    """``attention`` mirrors the reference's choice: one query and "naive"
    take the exact path, "flash" the blocked one, "auto" the exact path in
    the prefill phase and the blocked one otherwise."""
    calls = []
    monkeypatch.setattr(L, "attention_naive",
                        lambda *a, **k: calls.append("naive"))
    monkeypatch.setattr(L, "flash_attention",
                        lambda *a, **k: calls.append("flash"))
    one, many = torch.zeros(1, 1, 2, 4), torch.zeros(1, 3, 2, 4)
    L.attention(one, one, one)
    L.attention(many, many, many)
    with L.attention_phase("prefill"):
        L.attention(many, many, many)
        with L.attention_phase("train"):
            L.attention(many, many, many)
        L.attention(many, many, many)
    L.attention(many, many, many)
    monkeypatch.setattr(L, "ATTN_IMPL", "naive")
    L.attention(many, many, many)
    monkeypatch.setattr(L, "ATTN_IMPL", "flash")
    with L.attention_phase("prefill"):
        L.attention(many, many, many)
    assert calls == ["naive", "flash", "naive", "flash", "naive", "flash",
                     "naive", "flash"]


# ---------------------------------------------------------------------------
# (b) the model entry points against the reference's, f32
# ---------------------------------------------------------------------------

ARCHS = ["llama3.2-1b", "qwen1.5-0.5b", "arctic-480b",
         "llava-next-mistral-7b", "mixtral-8x7b"]


def _models(arch, dtype="float32"):
    """(jcfg, jmodel, jparams, tcfg, tmodel, tparams): the JAX init (norm
    weights and QKV biases randomised, so they are exercised) and the same
    weights in the port."""
    jcfg = jax_tiny_config(arch).with_(param_dtype=dtype)
    tcfg = tiny_config(arch).with_(param_dtype=dtype)
    jmodel = jax_build_model(jcfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    layers = params["layers"]
    for name in ("attn_norm", "ffn_norm"):
        layers[name] = (1 + 0.1 * rng.standard_normal(layers[name].shape)
                        ).astype(layers[name].dtype)
    for name in ("bq", "bk", "bv"):
        if name in layers["attn"]:
            a = layers["attn"][name]
            layers["attn"][name] = (0.5 * rng.standard_normal(a.shape)
                                    ).astype(a.dtype)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tparams = from_jax_params(params, tcfg, device="cpu")
    return jcfg, jmodel, jparams, tcfg, build_model(tcfg), tparams


def _batch(cfg, B, S, seed):
    """Token ids (and, for the VLM family, patch embeddings in front of
    them) for a prompt of S positions, as numpy arrays."""
    rng = np.random.default_rng(seed)
    P = cfg.n_patch_tokens
    b = {"tokens": rng.integers(1, cfg.vocab_size, (B, S - P)).astype(np.int32)}
    if P:
        b["patch_embeds"] = rng.standard_normal((B, P, cfg.d_model)).astype(
            np.float32)
    return b


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _assert_cache(tcache, jcache):
    assert set(tcache) == set(jcache)
    for name, want in jcache.items():
        got = tcache[name]
        assert tuple(got.shape) == want.shape, name
        if name == "kv_pos":
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


# (arch, S): a prompt of S positions, B = 2; mixtral's ring at S > W and S < W
PREFILL_CASES = [(a, 24) for a in ARCHS[:4]] + [("mixtral-8x7b", 48),
                                                 ("mixtral-8x7b", 20)]


@pytest.mark.parametrize("arch,S", PREFILL_CASES,
                         ids=[f"{a}-S{s}" for a, s in PREFILL_CASES])
def test_prefill_and_decode_match_jax(arch, S):
    """``Model.prefill``'s logits and cache, then 4 ``decode`` steps from the
    reference's own cache (a linear cache padded by 4 rows, so each write
    lands; the ring wraps), logits and cache after every step."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = _models(arch)
    B, steps = 2, 4
    b = _batch(jcfg, B, S, seed=S)
    jlogits, jcache = jmodel.prefill(jparams, _jbatch(b))
    tlogits, tcache = tmodel.prefill(tparams, _tbatch(b))
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), **F32_TOL)
    _assert_cache(tcache, jcache)
    W = jcfg.sliding_window
    if W:
        assert jcache["k"].shape[2] == W
        np.testing.assert_array_equal(
            np.sort(np.asarray(jcache["kv_pos"])[0, 0]),
            np.arange(S - W, S) if S >= W
            else np.r_[np.full(W - S, jL.INVALID_POS), np.arange(S)])
    else:
        pad = ((0, 0), (0, 0), (0, steps), (0, 0), (0, 0))
        jcache = {n: jnp.pad(c, pad) for n, c in jcache.items()}

    tcache = cache_from_jax(jax.tree_util.tree_map(np.asarray, jcache),
                            device="cpu")
    jdecode = jax.jit(jmodel.decode)
    lens = np.full((B,), S, np.int32)
    for i in range(steps):
        tok = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
        jlogits, jcache = jdecode(jparams, jnp.asarray(tok), jcache,
                                  jnp.asarray(lens + i))
        tlogits, tcache2 = tmodel.decode(tparams, torch.from_numpy(tok),
                                         tcache, torch.from_numpy(lens + i))
        assert tcache2 is tcache                    # updated in place
        np.testing.assert_allclose(_np(tlogits), _np(jlogits), **F32_TOL)
        _assert_cache(tcache, jcache)


def test_decode_at_full_linear_cache_drops_the_write():
    """``prefill`` returns exactly S rows; a decode at ``lens == S`` (as
    tests/test_models_smoke.py:55-58 runs it) writes past the end, which
    JAX drops: the port neither raises nor wraps, its cache is unchanged,
    and the logits attend over the S cached keys as the reference's do."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = _models("qwen1.5-0.5b")
    B, S = 2, 16
    b = _batch(jcfg, B, S, seed=3)
    jlogits, jcache = jmodel.prefill(jparams, _jbatch(b))
    tcache = cache_from_jax(jax.tree_util.tree_map(np.asarray, jcache),
                            device="cpu")
    before = {n: c.clone() for n, c in tcache.items()}
    # one row at the end, one inside: only the first write drops
    lens = np.array([S, S - 3], np.int32)
    tok = np.array([[7], [9]], np.int32)
    want, jnew = jmodel.decode(jparams, jnp.asarray(tok), jcache,
                               jnp.asarray(lens))
    got, tnew = tmodel.decode(tparams, torch.from_numpy(tok), tcache,
                              torch.from_numpy(lens))
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    _assert_cache(tnew, jnew)
    for n in ("k", "v"):
        assert torch.equal(tnew[n][:, 0], before[n][:, 0])
        assert not torch.equal(tnew[n][:, 1], before[n][:, 1])


@pytest.mark.parametrize("arch,S", PREFILL_CASES,
                         ids=[f"{a}-S{s}" for a, s in PREFILL_CASES])
def test_train_hidden_matches_jax(arch, S):
    """``train_hidden`` (flash under "auto") and ``train_logits`` against the
    reference's; with grad enabled, the per-layer checkpoint gives the same
    values and a finite gradient."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = _models(arch)
    b = _batch(jcfg, 2, S, seed=S + 1)
    want = jmodel.train_hidden(jparams, _jbatch(b))
    with torch.no_grad():
        got = tmodel.train_hidden(tparams, _tbatch(b))
        logits = tmodel.train_logits(tparams, _tbatch(b))
    assert tuple(got.shape) == (2, S, tcfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    np.testing.assert_allclose(
        _np(logits), _np(jmodel.train_logits(jparams, _jbatch(b))),
        **F32_TOL)
    w = tparams["layers"][0]["attn"]["wq"].requires_grad_(True)
    try:
        hidden = tmodel.train_hidden(tparams, _tbatch(b), remat=True)
        np.testing.assert_allclose(_np(hidden.detach()), _np(want), **F32_TOL)
        hidden.square().mean().backward()
        assert w.grad is not None and torch.isfinite(w.grad).all()
        assert w.grad.abs().sum() > 0
    finally:
        w.requires_grad_(False)
        w.grad = None


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_struct_and_unembed_weight_match_jax(arch, dtype):
    jcfg = jax_tiny_config(arch).with_(param_dtype=dtype)
    tcfg = tiny_config(arch).with_(param_dtype=dtype)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    want = jmodel.cache_struct(3, 40)
    got = tmodel.cache_struct(3, 40)
    assert set(got) == set(want)
    for name, s in want.items():
        assert got[name].device.type == "meta"
        assert tuple(got[name].shape) == s.shape
        assert str(got[name].dtype)[6:] == s.dtype.name
    params = tmodel.init(torch.Generator().manual_seed(0), device="cpu")
    w, kind = tmodel.impl.unembed_weight(params)
    assert kind == ("vd" if tcfg.tie_embeddings else "dv")
    assert w is params["embed" if tcfg.tie_embeddings else "lm_head"]


def test_flash_prefill_direct_and_naive_prefill_differ_only_in_rounding():
    """``TransformerLM.prefill`` called directly runs flash, ``Model.prefill``
    the exact path, as the reference; in bf16 they round differently yet
    stay within the bf16 bar of each other and of the reference's."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = _models("llama3.2-1b",
                                                           "bfloat16")
    b = _batch(jcfg, 2, 32, seed=5)
    for jfn, tfn in ((jmodel.prefill, tmodel.prefill),
                     (jmodel.impl.prefill, tmodel.impl.prefill)):
        want, _ = jfn(jparams, _jbatch(b))
        got, _ = tfn(tparams, _tbatch(b))
        np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


# ---------------------------------------------------------------------------
# (c) mirrors of the reference's own prefill / decode tests
# ---------------------------------------------------------------------------

def _port_model(arch):
    cfg = tiny_config(arch)
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0),
                                  device="cpu")


def test_chunked_step_equals_whole_prefill():
    """tests/test_engine.py:23: three chunks of 16 through ``chunked_step``
    give the one-shot ``prefill``'s last logits (bf16 bar) and argmax."""
    cfg, model, params = _port_model("llama3.2-1b")
    B, S, C = 2, 48, 16
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (B, S)).astype(np.int32))
    ref_logits, _ = model.prefill(params, {"tokens": tokens})
    hd = cfg.resolved_head_dim
    shape = (cfg.n_layers, B, S + 1, cfg.n_kv_heads, hd)
    cache = {"k": torch.zeros(shape, dtype=torch.bfloat16),
             "v": torch.zeros(shape, dtype=torch.bfloat16)}
    lens = torch.zeros(B, dtype=torch.int32)
    for i in range(3):
        logits = model.impl.chunked_step(
            params, tokens[:, i * C:(i + 1) * C], cache, lens,
            torch.full((B,), C, dtype=torch.int32))
        lens = lens + C
    np.testing.assert_allclose(_np(logits), _np(ref_logits), **BF16_TOL)
    assert (_np(logits).argmax(-1) == _np(ref_logits).argmax(-1)).all()


def test_chunked_step_mixed_decode_and_prefill():
    """tests/test_engine.py:61: one round advancing a decode slot (chunk 1)
    and a prefill slot (chunk 8) together, after a round with an idle slot."""
    cfg, model, params = _port_model("qwen1.5-0.5b")
    B, S = 2, 64
    hd = cfg.resolved_head_dim
    shape = (cfg.n_layers, B, S + 1, cfg.n_kv_heads, hd)
    cache = {"k": torch.zeros(shape, dtype=torch.bfloat16),
             "v": torch.zeros(shape, dtype=torch.bfloat16)}
    lens = torch.zeros(B, dtype=torch.int32)
    model.impl.chunked_step(params, torch.ones((B, 16), dtype=torch.int32),
                            cache, lens, torch.tensor([16, 0], dtype=torch.int32))
    lens = lens + torch.tensor([16, 0], dtype=torch.int32)
    logits2 = model.impl.chunked_step(
        params, torch.ones((B, 8), dtype=torch.int32), cache, lens,
        torch.tensor([1, 8], dtype=torch.int32))
    assert torch.isfinite(logits2.float()).all()


def _smoke_batch(cfg, B, S):
    """tests/test_models_smoke.py's ``_batch_for``: ones, zero patches."""
    P = cfg.n_patch_tokens
    b = {"tokens": torch.ones((B, S - P), dtype=torch.int32)}
    if cfg.family == "vlm":
        b["patch_embeds"] = torch.zeros((B, P, cfg.d_model),
                                        dtype=torch.bfloat16)
    return b


SMOKE_ARCHS = ["llama3.2-1b", "arctic-480b", "mixtral-8x7b",
               "llava-next-mistral-7b"]


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_smoke_prefill_decode(arch):
    """tests/test_models_smoke.py:47 for the dense, MoE and VLM families: a
    decode at ``lens == S`` after a prefill of S (its write dropped on a
    linear cache), finite logits, the cache's structure kept."""
    cfg, model, params = _port_model(arch)
    B, S = 2, 32
    logits, cache = model.prefill(params, _smoke_batch(cfg, B, S))
    assert tuple(logits.shape) == (B, cfg.vocab_size)
    assert torch.isfinite(logits.float()).all()
    shapes = {n: tuple(c.shape) for n, c in cache.items()}
    lens = torch.full((B,), S, dtype=torch.int32)
    tok = logits.argmax(-1)[:, None].int()
    logits2, cache2 = model.decode(params, tok, cache, lens)
    assert tuple(logits2.shape) == (B, cfg.vocab_size)
    assert torch.isfinite(logits2.float()).all()
    assert {n: tuple(c.shape) for n, c in cache2.items()} == shapes


def test_sliding_window_ring_cache_decode():
    """tests/test_models_smoke.py:135: a 48-token prompt over a 32-token
    window gives a W-sized ring, and decode wraps it: each step writes slot
    ``lens % W`` and records its position."""
    cfg, model, params = _port_model("mixtral-8x7b")
    assert cfg.sliding_window == 32
    B, S = 1, 48
    logits, cache = model.prefill(
        params, {"tokens": torch.ones((B, S), dtype=torch.int32)})
    assert cache["k"].shape[2] == 32
    lens = torch.full((B,), S, dtype=torch.int32)
    for i in range(4):
        tok = torch.full((B, 1), 5, dtype=torch.int32)
        logits, cache = model.decode(params, tok, cache, lens + i)
        assert torch.isfinite(logits.float()).all()
        assert (cache["kv_pos"][:, 0, (S + i) % 32] == S + i).all()
