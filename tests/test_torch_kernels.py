"""The port's paged attention (``repro_torch.kernels``) against the JAX
package: on CPU tensors the wrappers run their plain PyTorch versions, which
must agree with (a) the jnp oracles of ``repro.kernels.ref`` and (b) the
Pallas kernels in interpret mode, on the same numpy-made inputs -- across
GQA groups, ragged and non-page-aligned lengths, permuted block tables, an
idle row, f32 and bf16.  Rows with no valid key are NaN in every reference
(and 0 in the CUDA kernels) and are not compared.

The CUDA kernels themselves need nvcc and a card; ``chip_smoke.py`` holds
them against these plain versions on the GPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_decode_attention import (
    paged_decode_attention as pallas_decode,
)
from repro.kernels.paged_prefill_attention import (
    paged_prefill_attention as pallas_prefill,
)
from repro_torch.kernels import ref as tref
from repro_torch.kernels.paged_decode_attention import paged_decode_attention
from repro_torch.kernels.paged_prefill_attention import paged_prefill_attention

TOL_F32 = 1e-5
TOL_BF16 = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32, TOL_F32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, TOL_BF16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run as fast on one intra-op thread, and several test
    workers sharing the CPU do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(a, jdt, tdt):
    """One numpy array as a jnp array and a torch CPU tensor of the same
    values (bf16 rounds identically in both)."""
    return jnp.asarray(a, jdt), torch.from_numpy(np.asarray(a)).to(tdt)


def _setup(rng, B, Hkv, hd, page_size, max_pages):
    """A page pool larger than needed, with per-sequence tables that scatter
    each sequence's pages non-contiguously across it."""
    n_pages = 2 * B * max_pages + 3
    k = rng.standard_normal((n_pages, page_size, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((n_pages, page_size, Hkv, hd)).astype(np.float32)
    ids = rng.permutation(n_pages - 1)[: B * max_pages]
    tables = ids.reshape(B, max_pages).astype(np.int32)
    return k, v, tables


def _to_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# (B, Hq, Hkv, hd, page_size, max_pages): GQA groups 1, 2 and 4
SHAPES = [
    (3, 4, 4, 16, 16, 5),
    (3, 8, 4, 32, 16, 4),
    (4, 8, 2, 32, 8, 6),
]
# and for decode groups 12 (mistral-large-123b's 96/8) and 48 (granite-34b's
# MQA 48/1) at hd 128, which the decode kernels take like any other group
DECODE_SHAPES = SHAPES + [
    (2, 24, 2, 128, 16, 4),
    (2, 48, 1, 128, 16, 3),
]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,Hq,Hkv,hd,page_size,max_pages", DECODE_SHAPES)
def test_paged_decode_plain_matches_jax(rng, dtype, B, Hq, Hkv, hd, page_size,
                                        max_pages):
    jdt, tdt, tol = DTYPES[dtype]
    k, v, tables = _setup(rng, B, Hkv, hd, page_size, max_pages)
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    # ragged, non-page-aligned lengths; the last row is idle (no valid key)
    kv_lens = rng.integers(1, max_pages * page_size + 1, B).astype(np.int32)
    kv_lens[-1] = 0
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, jdt, tdt) for a in (q, k, v))
    tt, tl = torch.from_numpy(tables), torch.from_numpy(kv_lens)
    before = paged_decode_attention.launches

    got = _to_np(paged_decode_attention(tq, tk, tv, tt, tl))
    assert paged_decode_attention.launches == before  # CPU: no kernel launch
    want_ref = _to_np(jref.paged_decode_attention_ref(
        jq, jk, jv, jnp.asarray(tables), jnp.asarray(kv_lens)))
    want_pallas = _to_np(pallas_decode(
        jq, jk, jv, jnp.asarray(tables), jnp.asarray(kv_lens)))

    live = kv_lens > 0
    assert np.isnan(got[~live]).all()          # like the jnp oracle
    np.testing.assert_allclose(got[live], want_ref[live], atol=tol, rtol=tol)
    np.testing.assert_allclose(got[live], want_pallas[live], atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,Hq,Hkv,hd,page_size,max_pages", SHAPES)
def test_paged_prefill_plain_matches_jax(rng, dtype, B, Hq, Hkv, hd, page_size,
                                         max_pages):
    jdt, tdt, tol = DTYPES[dtype]
    Sq = 16
    k, v, tables = _setup(rng, B, Hkv, hd, page_size, max_pages)
    q = rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32)
    # each row: a chunk of 1..Sq tokens after a ragged prefix, as the engine
    # stages it (kv_len = prefix + chunk); the last row is idle
    chunk = rng.integers(1, Sq + 1, B)
    prefix = rng.integers(0, max_pages * page_size - Sq + 1, B)
    q_offset = prefix.astype(np.int32)
    kv_lens = (prefix + chunk).astype(np.int32)
    q_offset[-1], kv_lens[-1] = 0, 0
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, jdt, tdt) for a in (q, k, v))
    args_t = (torch.from_numpy(tables), torch.from_numpy(kv_lens),
              torch.from_numpy(q_offset))
    args_j = (jnp.asarray(tables), jnp.asarray(kv_lens), jnp.asarray(q_offset))
    before = paged_prefill_attention.launches

    got = _to_np(paged_prefill_attention(tq, tk, tv, *args_t))
    assert paged_prefill_attention.launches == before
    want_ref = _to_np(jref.paged_prefill_attention_ref(jq, jk, jv, *args_j))
    want_pallas = _to_np(pallas_prefill(jq, jk, jv, *args_j))

    live = kv_lens > 0          # key 0 is visible to every row of a live seq
    assert np.isnan(got[~live]).all()
    np.testing.assert_allclose(got[live], want_ref[live], atol=tol, rtol=tol)
    np.testing.assert_allclose(got[live], want_pallas[live], atol=tol, rtol=tol)


def test_gather_pages_matches_jax(rng):
    k, _, tables = _setup(rng, 3, 2, 16, 8, 4)
    got = tref.gather_pages(torch.from_numpy(k), torch.from_numpy(tables))
    want = jref.gather_pages(jnp.asarray(k), jnp.asarray(tables))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
