"""The port's dense transformer step (``repro_torch.models``) against the
JAX package's on the same weights: JAX ``init`` params, converted with
``repro_torch.weights.from_jax_params``, run a 4-round mixed schedule of
prefill chunks, decodes, idle slots and one pure-decode (C == 1) round
through both ``chunked_step_paged``; logits and the final page pools must
agree.  QKV biases and norm weights are randomised first, so they are
exercised (``init`` makes them zeros and ones).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tiny_config
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import tiny_config as torch_tiny_config
from repro_torch.models.model import build_model as torch_build_model
from repro_torch.weights import from_jax_params

# slot -> (chunk_len, ...) per round; chunk 1 after the prefill is a decode,
# 0 is an idle slot.  Round 3 is a pure-decode round (bucket C == 1).
SCHEDULE = [
    (16, (16, 10, 0, 5)),
    (16, (12, 1, 16, 1)),
    (1, (1, 1, 0, 1)),
    (32, (1, 0, 20, 1)),
]
PAGE_SIZE = 8
MAX_PAGES = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run as fast on one intra-op thread, and several test
    workers sharing the CPU do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(cfg, rng):
    """JAX init params as numpy, with random biases and norm weights."""
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


def _run_both(cfg_name, param_dtype, rng, **overrides):
    jcfg = tiny_config(cfg_name).with_(param_dtype=param_dtype, **overrides)
    tcfg = torch_tiny_config(cfg_name).with_(param_dtype=param_dtype, **overrides)
    np_params = _params(jcfg, rng)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    tparams = from_jax_params(np_params, tcfg, device="cpu")
    jstep = jax.jit(jax_build_model(jcfg).impl.chunked_step_paged)
    timpl = torch_build_model(tcfg).impl

    B = len(SCHEDULE[0][1])
    hd = jcfg.resolved_head_dim
    n_phys = B * MAX_PAGES + 5                      # last page is the sink
    sink = n_phys - 1
    shape = (jcfg.n_layers, n_phys, PAGE_SIZE, jcfg.n_kv_heads, hd)
    jdt = jnp.dtype(param_dtype)
    jcache = {"k": jnp.zeros(shape, jdt), "v": jnp.zeros(shape, jdt)}
    tdt = getattr(torch, param_dtype)
    tcache = {"k": torch.zeros(shape, dtype=tdt),
              "v": torch.zeros(shape, dtype=tdt)}
    # permuted physical pages per slot, padded with the sink as the engine does
    ids = rng.permutation(sink)[: B * MAX_PAGES].reshape(B, MAX_PAGES)
    lens = np.zeros(B, np.int32)
    out = []
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
            jnp.asarray(chunk_lens), jnp.asarray(tables))
        tlogits = timpl.chunked_step_paged(
            tparams, torch.from_numpy(tokens), tcache, torch.from_numpy(lens),
            torch.from_numpy(chunk_lens), torch.from_numpy(tables))
        live = chunk_lens > 0
        out.append((np.asarray(jlogits, np.float32)[live],
                    tlogits.float().numpy()[live]))
        lens = lens + chunk_lens
    pools = [(np.asarray(jcache[n], np.float32), tcache[n].float().numpy())
             for n in ("k", "v")]
    return out, pools


CONFIGS = [
    ("qwen1.5-0.5b", {}),                   # QKV bias, MHA
    ("llama3.2-1b", {"n_kv_heads": 2}),     # GQA, group 2
]


@pytest.mark.parametrize("name,overrides", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_chunked_step_paged_f32_matches_jax(rng, name, overrides):
    rounds, pools = _run_both(name, "float32", rng, **overrides)
    for want, got in rounds:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    for want, got in pools:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name,overrides", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_chunked_step_paged_bf16_matches_jax(rng, name, overrides):
    rounds, pools = _run_both(name, "bfloat16", rng, **overrides)
    for want, got in rounds:
        # bf16 accumulation-order tolerance (tests/test_engine.py:52-55)
        np.testing.assert_allclose(got, want, atol=0.25, rtol=0.05)
    for want, got in pools:
        np.testing.assert_allclose(got, want, atol=0.25, rtol=0.05)
