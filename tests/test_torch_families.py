"""The hybrid (Jamba), xLSTM and Whisper families of the port
(``repro_torch.models.{mamba,hybrid,xlstm,whisper}``) on the CPU against the
JAX package.

(a) Tiny jamba-1.5-large-398b, xlstm-1.3b and whisper-large-v3 on the JAX
    init converted to the port, f32: ``Model.prefill``'s logits and cache,
    3 ``decode`` steps from the reference's own cache and from the port's
    (the K/V caches padded by 3 rows, so each write lands), a decode at
    ``lens == S`` on an unpadded cache (the write dropped, as JAX drops
    it), ``train_hidden``, ``loss`` and its gradients.  Tolerances
    (``assert_allclose``'s atol and rtol, one value t: |d| <= t (1 + |want|)):
    whisper 1e-5, as ``TransformerLM`` is held; the two recurrent stacks
    amplify f32 rounding down their layers, so each is held at about twice
    its reading, the t it needs: the tiny jamba group 3e-5 (reading 1.15e-5,
    its mamba scans 32 sequential f32 steps a layer), the tiny 8-block
    xLSTM stack 1e-4 (reading 5.0e-5; whisper's reading 1.0e-6); each mixer
    alone (mLSTM, sLSTM, mamba) is held at 1e-5 (mLSTM and sLSTM read
    2.6e-6).  Grads max-normalised per leaf within 1e-4.
(b) Pins: the tanh GELU of whisper's MLP and the sLSTM FFN (torch's default
    GELU is the erf form); ``_causal_conv`` with a carried state; the mamba
    scan's gcd chunk at S = 48; ``from_jax_params`` keeping ``A_log``,
    ``dt_bias``, ``D``, ``wi``, ``wf``, ``bf``, ``w_gates``, ``r_gates`` and
    ``b_gates`` in f32 under a bf16 config; ``cache_struct``.
(c) Mirrors of tests/test_models_smoke.py's ``test_smoke_train_step`` and
    ``test_smoke_prefill_decode`` over all ten ``ASSIGNED_ARCHS`` on the
    port's own seeded bf16 weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_get_config
from repro.configs import tiny_config as jax_tiny_config
from repro.models import mamba as jM
from repro.models import whisper as jW
from repro.models import xlstm as jX
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import ASSIGNED_ARCHS, get_config, tiny_config
from repro_torch.models import mamba as M
from repro_torch.models import whisper as W
from repro_torch.models import xlstm as X
from repro_torch.models.model import build_model
from repro_torch.training.optimizer import global_norm
from repro_torch.tree import tree_leaves, tree_unflatten
from repro_torch.weights import cache_from_jax, from_jax_params

F32_TOL = dict(atol=1e-5, rtol=1e-5)
# the recurrent stacks, each from its reading (see the module docstring)
JAMBA_TOL = dict(atol=3e-5, rtol=3e-5)
XLSTM_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = 1e-4
FAMILIES = ["jamba-1.5-large-398b", "xlstm-1.3b", "whisper-large-v3"]
B, S, STEPS = 2, 32, 3


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
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _stacked(tree):
    """The port's tree in the reference's layout: lists stacked into a
    leading dim, tensors as f32 numpy."""
    if isinstance(tree, dict):
        return {k: _stacked(v) for k, v in tree.items()}
    if isinstance(tree, list):
        kids = [_stacked(v) for v in tree]
        return jax.tree_util.tree_map(lambda *a: np.stack(a), *kids)
    if isinstance(tree, tuple):
        return tuple(_stacked(v) for v in tree)
    return _np(tree)


def _assert_tree(got, want, tol, what):
    got = _stacked(got)
    flat_w, tree_w = jax.tree_util.tree_flatten(want)
    flat_g, tree_g = jax.tree_util.tree_flatten(got)
    assert tree_g == tree_w, what
    for g, w in zip(flat_g, flat_w):
        assert g.shape == np.shape(w), what
        np.testing.assert_allclose(g, _np(w), err_msg=what, **tol)


def _tol(arch):
    return {"jamba": JAMBA_TOL, "xlstm": XLSTM_TOL,
            "whisper": F32_TOL}[arch.split("-")[0]]


def _batch(cfg, seed, with_labels=False):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal(
            (B, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32)
    if with_labels:
        b["labels"] = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
        b["loss_mask"] = (rng.random((B, S)) > 0.1).astype(np.float32)
    return b


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _pad_kv(cache, n):
    """The K/V caches (5-d, sequence on axis 2) padded by n rows."""
    names = ("self_k", "self_v") if "self_k" in cache else ("k", "v")
    pad = ((0, 0), (0, 0), (0, n), (0, 0), (0, 0))
    return {k: (np.pad(v, pad) if k in names else v) for k, v in cache.items()}


def _norm_jitter(params, rng):
    """Norm weights off 1 (so they are exercised), in place, numpy tree."""
    if isinstance(params, dict):
        for k, v in params.items():
            if isinstance(v, dict):
                _norm_jitter(v, rng)
            elif k.endswith("norm"):
                params[k] = (1 + 0.1 * rng.standard_normal(v.shape)).astype(
                    v.dtype)


@pytest.fixture(scope="module", params=FAMILIES)
def models(request):
    """(arch, jcfg, jmodel, jparams, tcfg, tmodel, tparams): the JAX init in
    f32 and the same weights in the port."""
    arch = request.param
    jcfg = jax_tiny_config(arch).with_(param_dtype="float32")
    tcfg = tiny_config(arch).with_(param_dtype="float32")
    jmodel = jax_build_model(jcfg)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    _norm_jitter(params, np.random.default_rng(1))
    tparams = from_jax_params(params, tcfg, device="cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    return arch, jcfg, jmodel, jparams, tcfg, build_model(tcfg), tparams


# ---------------------------------------------------------------------------
# (a) the three families against the reference, f32
# ---------------------------------------------------------------------------

def test_prefill_and_decode_match_jax(models):
    """``prefill``'s logits and cache; a decode at ``lens == S`` on that
    cache (the write dropped); then 3 ``decode`` steps from the reference's
    cache padded by 3 rows and, alongside, from the port's own prefill
    cache: logits and cache after every step."""
    arch, jcfg, jmodel, jparams, tcfg, tmodel, tparams = models
    tol = _tol(arch)
    b = _batch(jcfg, seed=3)
    jlogits, jcache = jmodel.prefill(jparams, _jb(b))
    with torch.no_grad():
        tlogits, own = tmodel.prefill(tparams, _tb(b))
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), **tol)
    jcache = jax.tree_util.tree_map(np.asarray, jcache)
    _assert_tree(own, jcache, tol, "prefill cache")

    # a decode at lens == S on the cache of exactly S rows (as
    # tests/test_models_smoke.py:55-58 runs it): JAX drops the K/V write;
    # the port neither raises nor wraps
    tok = np.array([[7], [9]], np.int32)
    full = np.full((B,), S, np.int32)
    want, jnew = jmodel.decode(jparams, jnp.asarray(tok),
                               jax.tree_util.tree_map(jnp.asarray, jcache),
                               jnp.asarray(full))
    with torch.no_grad():
        got, tnew = tmodel.decode(tparams, torch.from_numpy(tok),
                                  cache_from_jax(jcache, device="cpu"),
                                  torch.from_numpy(full))
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    _assert_tree(tnew, jax.tree_util.tree_map(np.asarray, jnew), tol,
                 "cache after the dropped write")

    jcache = _pad_kv(jcache, STEPS)
    tcache = cache_from_jax(jcache, device="cpu")
    own = cache_from_jax(_pad_kv(_stacked(own), STEPS), device="cpu")
    jcache = jax.tree_util.tree_map(jnp.asarray, jcache)
    jdecode = jax.jit(jmodel.decode)
    lens = np.full((B,), S, np.int32)
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
        jlogits, jcache = jdecode(jparams, jnp.asarray(tok), jcache,
                                  jnp.asarray(lens + i))
        with torch.no_grad():
            tlogits, tnew = tmodel.decode(tparams, torch.from_numpy(tok),
                                          tcache, torch.from_numpy(lens + i))
            ologits, _ = tmodel.decode(tparams, torch.from_numpy(tok), own,
                                       torch.from_numpy(lens + i))
        assert tnew is tcache                       # updated in place
        np.testing.assert_allclose(_np(tlogits), _np(jlogits), **tol)
        np.testing.assert_allclose(_np(ologits), _np(jlogits), **tol)
        _assert_tree(tcache, jax.tree_util.tree_map(np.asarray, jcache), tol,
                     f"decode {i} cache")


def test_train_hidden_loss_and_grads_match_jax(models):
    """``train_hidden`` (flash attention under "auto"), ``loss`` (with a
    loss mask) and the loss's gradient of every leaf, max-normalised."""
    arch, jcfg, jmodel, jparams, tcfg, tmodel, tparams = models
    b = _batch(jcfg, seed=5, with_labels=True)
    want = jmodel.train_hidden(jparams, _jb(b))
    with torch.no_grad():
        got = tmodel.train_hidden(tparams, _tb(b))
    np.testing.assert_allclose(_np(got), _np(want), **_tol(arch))

    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, _jb(b)), has_aux=True))(jparams)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tparams)]
    tp = tree_unflatten(tparams, leaves)
    tloss, metrics = tmodel.loss(tp, _tb(b))
    assert metrics["loss"] is tloss
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    tgrads = tree_unflatten(tparams, torch.autograd.grad(tloss, leaves))
    flat_w, tree_w = jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(np.asarray, jgrads))
    flat_g, tree_g = jax.tree_util.tree_flatten(_stacked(tgrads))
    assert tree_g == tree_w
    for g, w in zip(flat_g, flat_w):
        denom = np.abs(w).max() + 1e-12
        assert np.abs(g - w).max() / denom < GRAD_TOL


def test_xlstm_mixers_match_jax_one_block_at_a_time():
    """Each xLSTM mixer alone, on the same input and weights, within 1e-5:
    the mLSTM block (two chunks of the chunkwise form) and the sLSTM
    block, and the states they return (the whole model's decode carries
    them)."""
    jcfg = jax_tiny_config("xlstm-1.3b").with_(param_dtype="float32")
    tcfg = tiny_config("xlstm-1.3b").with_(param_dtype="float32")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    for init, jfn, tfn in ((jX.init_mlstm, jX.mlstm_mixer, X.mlstm_mixer),
                           (jX.init_slstm, jX.slstm_mixer, X.slstm_mixer)):
        p = jax.tree_util.tree_map(np.asarray,
                                   init(jax.random.PRNGKey(2), jcfg))
        tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
        jy, jst = jfn(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
                      jcfg)
        ty, tst = tfn(tp, torch.from_numpy(x), tcfg)
        np.testing.assert_allclose(_np(ty), _np(jy), **F32_TOL)
        for a, w in zip(tst, jst):
            np.testing.assert_allclose(_np(a), _np(w), **F32_TOL)


@pytest.fixture(scope="module")
def xlstm_published_width():
    """xlstm-1.3b at its published width (d_model 2048, 4 heads of hd 512)
    cut to one mLSTM and one sLSTM block and a vocab of 512, f32: (the
    port's config, the reference's init as numpy, a batch, the reference's
    loss and its grads as numpy leaves)."""
    import dataclasses

    def cut(c):
        return dataclasses.replace(
            c, n_layers=2, vocab_size=512, param_dtype="float32",
            ssm=dataclasses.replace(c.ssm, slstm_every=2))

    jmodel = jax_build_model(cut(jax_get_config("xlstm-1.3b")))
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    b = {k: rng.integers(1, 512, (1, 64)).astype(np.int32)
         for k in ("tokens", "labels")}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, _jb(b)), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, params))
    return (cut(get_config("xlstm-1.3b")), params, b, float(jloss),
            jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                             jgrads)))


@pytest.mark.parametrize("threads", [1, 4])
def test_xlstm_at_its_published_width_matches_jax(xlstm_published_width,
                                                  threads):
    """The loss, its grad norm and every leaf's grad against the
    reference's at xLSTM's published width, on 1 and 4 intra-op threads.
    Only this width reaches the gates' real spread: ``wi``, ``wf`` and
    ``w_gates`` are drawn at scale 0.1 with no fan-in factor, so ``log_i``
    has std 0.1 sqrt(2048) ~ 4.5 here (0.8 in the tiny config), and the
    exponential gates turn summation order into visible differences.
    Readings (threads 1 / 4): loss 7.0e-7 / 1.1e-6 relative, grad norm
    2.3e-4 / 6.5e-5 relative (the reference's 1384.685), worst leaf
    max-normalised 4.3e-3 / 4.3e-4 (mLSTM's ``wf``); the reference's own
    grads move by up to 2.9e-4 between mLSTM chunks of 64 and 16.  Bars:
    the loss 1e-5 (as the tiny configs), the grad norm 1e-3, each leaf
    1e-2."""
    tcfg, params, b, jloss, flat_w = xlstm_published_width
    n = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        tparams = from_jax_params(params, tcfg, device="cpu")
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(tparams)]
        tloss, _ = build_model(tcfg).loss(tree_unflatten(tparams, leaves),
                                          _tb(b))
        tgrads = torch.autograd.grad(tloss, leaves)
    finally:
        torch.set_num_threads(n)
    np.testing.assert_allclose(tloss.item(), jloss, rtol=1e-5)
    want = np.sqrt(sum(np.square(w.astype(np.float64)).sum() for w in flat_w))
    np.testing.assert_allclose(global_norm(list(tgrads)).item(), want,
                               rtol=1e-3)
    flat_g = jax.tree_util.tree_leaves(_stacked(tree_unflatten(tparams,
                                                               tgrads)))
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        assert np.abs(g - w).max() / (np.abs(w).max() + 1e-12) < 1e-2


# ---------------------------------------------------------------------------
# (b) pins
# ---------------------------------------------------------------------------

def test_mlps_use_the_tanh_gelu():
    """Whisper's MLP and the sLSTM block's FFN use JAX's default GELU, the
    tanh approximation: within 1e-6 of the reference's MLP, where torch's
    default erf GELU is measurably off."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32) * 3
    p = jax.tree_util.tree_map(
        np.asarray, jW._init_mlp(jax.random.PRNGKey(3), 16, 32, jnp.float32))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    want = _np(jW._mlp(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x)))
    np.testing.assert_allclose(_np(W._mlp(tp, torch.from_numpy(x))), want,
                               atol=1e-6, rtol=1e-6)
    exact = F.gelu(torch.from_numpy(x) @ tp["w_in"]) @ tp["w_out"]
    assert np.abs(_np(exact) - want).max() > 1e-4


def test_causal_conv_carries_its_state():
    """``_causal_conv`` over a sequence equals two calls over its halves
    with the state carried, and the reference's; the state is the last W-1
    inputs in x's dtype."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 12, 6)).astype(np.float32)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    b = rng.standard_normal((6,)).astype(np.float32)
    st0 = rng.standard_normal((2, 3, 6)).astype(np.float32)
    jy, jst = jM._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              jnp.asarray(st0))
    T = torch.from_numpy
    y, st = M._causal_conv(T(x), T(w), T(b), T(st0))
    np.testing.assert_allclose(_np(y), _np(jy), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(_np(st), _np(jst))
    np.testing.assert_array_equal(_np(st), x[:, -3:])
    y1, s1 = M._causal_conv(T(x[:, :5]), T(w), T(b), T(st0))
    y2, s2 = M._causal_conv(T(x[:, 5:]), T(w), T(b), s1)
    np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), _np(y),
                               atol=1e-6, rtol=1e-6)
    assert torch.equal(s2, st)
    bf = M._causal_conv(T(x).bfloat16(), T(w).bfloat16(), T(b).bfloat16())[1]
    assert bf.dtype == torch.bfloat16 and bf.shape == (2, 3, 6)


def test_mamba_scan_takes_the_gcd_chunk(monkeypatch):
    """S = 48 with chunk 32: Q = gcd(48, 32) = 16, three chunks; the mixer
    agrees with the reference's at the same chunk and with one whole chunk
    of 48 (the chunks carry the state exactly); S = 1 is one step."""
    jcfg = jax_tiny_config("jamba-1.5-large-398b").with_(param_dtype="float32")
    tcfg = tiny_config("jamba-1.5-large-398b").with_(param_dtype="float32")
    p = jax.tree_util.tree_map(np.asarray,
                               jM.init_mamba(jax.random.PRNGKey(4), jcfg))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    x = np.random.default_rng(9).standard_normal((2, 48, jcfg.d_model)).astype(
        np.float32)
    want, jst = jM.mamba_mixer(jax.tree_util.tree_map(jnp.asarray, p),
                               jnp.asarray(x), jcfg, chunk=32)
    seen = []
    inner = M._ssm_chunk

    def spy(h0, x, *rest):
        seen.append(x.shape[1])
        return inner(h0, x, *rest)

    monkeypatch.setattr(M, "_ssm_chunk", spy)
    with torch.no_grad():
        got, st = M.mamba_mixer(tp, torch.from_numpy(x), tcfg, chunk=32)
        whole, _ = M.mamba_mixer(tp, torch.from_numpy(x), tcfg, chunk=48)
        M.mamba_mixer(tp, torch.from_numpy(x[:, :1]), tcfg, chunk=32)
    assert seen == [16, 16, 16, 48, 1]
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    np.testing.assert_allclose(_np(whole), _np(got), **F32_TOL)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(_np(st[name]), _np(jst[name]), **F32_TOL)
    assert st["ssm"].dtype == torch.float32


def _dtypes(tree):
    """Each leaf's dtype name, a list read at its first layer (every layer
    converts alike)."""
    if isinstance(tree, dict):
        return {k: _dtypes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return _dtypes(tree[0])
    return str(tree.dtype)[6:]


def _f32_names(dtypes, name=""):
    if isinstance(dtypes, dict):
        return set().union(*(_f32_names(v, k) for k, v in dtypes.items()))
    return {name} if dtypes == "float32" else set()


@pytest.mark.parametrize("arch", FAMILIES)
def test_from_jax_params_keeps_the_f32_leaves_under_bf16(arch):
    """Under a bf16 config every leaf converts in its own dtype, bitwise:
    the leaves the reference keeps in f32 (mamba's ``A_log`` / ``dt_bias``
    / ``D``, the MoE router, xLSTM's gate weights and biases) stay f32, the
    rest bf16."""
    jcfg, tcfg = jax_tiny_config(arch), tiny_config(arch)
    assert jcfg.param_dtype == "bfloat16"
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0)))
    tparams = from_jax_params(params, tcfg, device="cpu")
    dtypes = _dtypes(tparams)
    assert dtypes == jax.tree_util.tree_map(lambda a: a.dtype.name, params)
    want = {"jamba-1.5-large-398b": {"A_log", "dt_bias", "D", "router"},
            "xlstm-1.3b": {"wi", "wf", "bf", "w_gates", "r_gates", "b_gates"},
            "whisper-large-v3": set()}[arch]
    assert _f32_names(dtypes) == want
    for g, w in zip(jax.tree_util.tree_leaves(_stacked(tparams)),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(g, np.asarray(w, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_cache_struct_and_unembed_weight_match_jax(arch, dtype):
    jcfg = jax_tiny_config(arch).with_(param_dtype=dtype)
    tcfg = tiny_config(arch).with_(param_dtype=dtype)
    want = jax.tree_util.tree_flatten(jax_build_model(jcfg).cache_struct(3, 40))
    tmodel = build_model(tcfg)
    got = tmodel.cache_struct(3, 40)
    flat, tree = jax.tree_util.tree_flatten(got)
    assert tree == want[1]
    for g, s in zip(flat, want[0]):
        assert g.device.type == "meta"
        assert tuple(g.shape) == s.shape and str(g.dtype)[6:] == s.dtype.name
    params = tmodel.init(torch.Generator().manual_seed(0), device="cpu")
    w, kind = tmodel.impl.unembed_weight(params)
    name = "embed" if tcfg.family == "encdec" else "lm_head"
    assert w is params[name] and kind == ("vd" if name == "embed" else "dv")


# ---------------------------------------------------------------------------
# (c) mirrors of tests/test_models_smoke.py
# ---------------------------------------------------------------------------

def _smoke_batch(cfg, B=2, S=32, with_labels=True):
    b = {}
    if cfg.family == "encdec":
        b["frames"] = torch.zeros((B, cfg.encoder.seq_len, cfg.d_model),
                                  dtype=torch.bfloat16)
        b["tokens"] = torch.ones((B, S), dtype=torch.int32)
    elif cfg.family == "vlm":
        P = cfg.n_patch_tokens
        b["patch_embeds"] = torch.zeros((B, P, cfg.d_model),
                                        dtype=torch.bfloat16)
        b["tokens"] = torch.ones((B, S - P), dtype=torch.int32)
    else:
        b["tokens"] = torch.ones((B, S), dtype=torch.int32)
    if with_labels:
        b["labels"] = torch.ones_like(b["tokens"])
    return b


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_smoke_train_step(arch):
    cfg = tiny_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = _smoke_batch(cfg)
    with torch.no_grad():
        loss, metrics = model.loss(params, batch)
    assert loss.shape == ()
    assert np.isfinite(float(loss))
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = model.loss(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    gnorm = global_norm([g for g in grads if g is not None])
    assert np.isfinite(float(gnorm)) and float(gnorm) > 0


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_smoke_prefill_decode(arch):
    cfg = tiny_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    Bs, Ss = 2, 32
    batch = _smoke_batch(cfg, Bs, Ss, with_labels=False)
    with torch.no_grad():
        logits, cache = model.prefill(params, batch)
        assert logits.shape == (Bs, cfg.vocab_size)
        assert torch.isfinite(logits.float()).all()
        shapes = jax.tree_util.tree_map(lambda a: (tuple(a.shape), a.dtype),
                                        cache)
        lens = torch.full((Bs,), Ss, dtype=torch.int32)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        logits2, cache2 = model.decode(params, tok, cache, lens)
    assert logits2.shape == (Bs, cfg.vocab_size)
    assert torch.isfinite(logits2.float()).all()
    # cache structure (and every tensor's shape and dtype) preserved
    assert jax.tree_util.tree_structure(cache) == \
        jax.tree_util.tree_structure(cache2)
    assert jax.tree_util.tree_map(lambda a: (tuple(a.shape), a.dtype),
                                  cache2) == shapes
