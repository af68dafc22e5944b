"""The arithmetic of the port's split-K decode body (``csrc/decode_splitk.cuh``,
shared by ``decode_attention``, ``paged_decode_attention`` and
``paged_decode_attention_fused``), modelled in plain PyTorch on the CPU.

The body cuts a sequence's keys into splits of ``kSplitKeys`` and walks each
split in tiles (64 bf16 / 32 f32 keys) with an f32 online softmax in base 2
(the 1/sqrt(hd) scale, times log2 e, applied to q . k in f32).  f32 runs on
CUDA cores; bf16 runs on the tensor cores, where each of a CTA's four warps
keeps its own softmax over a 16-key slice of every tile and P V takes P
split into bf16 hi + lo halves.  The slices merge at the end of the split, and the splits
merge in a fixed order: m = max m_i, l = sum l_i 2^(m_i - m), acc likewise; a
row stores acc / l, or 0 where l == 0.  The model repeats that arithmetic,
reading the constants from the CUDA source, and these tests hold it within
``chip_smoke.py``'s bf16 gate (|d| <= 1e-5 + 2**-7 |want|, at most 2e-2),
and within 1e-5 in f32, of the plain versions and of the JAX package's
Pallas kernels in interpret mode at GQA groups 1, 4, 12 and 48; and show
that the model gives the same bits on the dense and the paged layout of the
same keys, that a row with kv_len == 0 stores 0, that keys and splits past
kv_len change nothing, and that a NaN key reaches its sequence's rows and no
other.

The CUDA kernels themselves need nvcc and a card; ``chip_smoke.py`` holds
them against the plain versions on the GPU under the same gates, and bitwise
dense = paged and fused = split.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.paged_decode_attention import (
    paged_decode_attention as pallas_paged_decode,
)
from repro_torch.kernels import native
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention_plain,
)

SOURCE = (Path(native.__file__).resolve().parent / "csrc"
          / "decode_splitk.cuh").read_text()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


SPLIT_KEYS = _constant("kSplitKeys")
WARPS = _constant("kThreads") // 32
TOL_BF16 = (1e-5, 2.0 ** -7)     # chip_smoke.py's bf16 gate (atol, rtol)
TOL_BF16_CAP = 2e-2
TOL_F32 = 1e-5
LOG2E = 1.4426950408889634
NEG = -1e30                      # kNegInf: the running max's start
# (Hq, Hkv, hd): GQA groups 1, 4, 12 (mistral-large-123b's) and 48
# (granite-34b's MQA)
GROUPS = {1: (2, 2, 64), 4: (8, 2, 64), 12: (24, 2, 128), 48: (48, 1, 128)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _max(a, b):
    """fmaxf: the larger of a and b, a NaN dropped."""
    return torch.fmax(a, b)


def _merge(parts):
    """(m, l, acc) of several partials merged in order: m (...,), l (...,),
    acc (..., hd)."""
    m = parts[0][0]
    for p in parts[1:]:
        m = _max(m, p[0])
    l = torch.zeros_like(parts[0][1])
    acc = torch.zeros_like(parts[0][2])
    for pm, pl, pacc in parts:
        w = torch.exp2(pm - m)
        l = l + pl * w
        acc = acc + pacc * w[..., None]
    return m, l, acc


def _split(q, k, v, n_keys, scale_log2, tile, n_slices, split_p):
    """One split's (m, l, acc) per query row: q (Hkv, g, hd) f32, k and v
    (n, Hkv, hd) f32 of the split's n_keys keys."""
    Hkv, g, hd = q.shape
    ks = tile // n_slices
    state = [(torch.full((Hkv, g), NEG), torch.zeros((Hkv, g)),
              torch.zeros((Hkv, g, hd))) for _ in range(n_slices)]
    for t0 in range(0, n_keys, tile):
        for s in range(n_slices):
            lo, hi = t0 + s * ks, min(t0 + (s + 1) * ks, n_keys)
            if lo >= hi:
                continue        # every key masked: m, l, acc unchanged
            x = torch.einsum("hgd,khd->hgk", q, k[lo:hi]) * scale_log2
            m, l, acc = state[s]
            # the running max drops a NaN score (fmaxf); its exp does not
            x_max = torch.where(torch.isnan(x), -math.inf, x).amax(-1)
            m_new = _max(m, x_max)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            if split_p:
                p_hi = _bf16(p)
                pv = (torch.einsum("hgk,khd->hgd", p_hi, v[lo:hi])
                      + torch.einsum("hgk,khd->hgd", _bf16(p - p_hi),
                                     v[lo:hi]))
            else:
                pv = torch.einsum("hgk,khd->hgd", p, v[lo:hi])
            state[s] = (m_new, l * alpha + p.sum(-1),
                        acc * alpha[..., None] + pv)
    return _merge(state)


def body_model(q, keys, kv_lens, capacity):
    """What the decode body computes, in f32 on the CPU: q (B, Hq, hd);
    keys(b, n) gives sequence b's first n keys' K and V, (n, Hkv, hd) each;
    capacity is the cache's keys per sequence.  -> (B, Hq, hd) in q's
    dtype; a row with kv_len == 0 is 0."""
    B, Hq, hd = q.shape
    out = torch.zeros((B, Hq, hd))
    scale_log2 = (torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
                  * torch.tensor(LOG2E, dtype=torch.float32))
    for b in range(B):
        kv_len = min(int(kv_lens[b]), capacity)
        if kv_len == 0:
            continue
        k, v = (t.float() for t in keys(b, kv_len))
        Hkv = k.shape[1]
        group = Hq // Hkv
        on_mma = q.dtype == torch.bfloat16
        tile = 64 if q.dtype == torch.bfloat16 else 32
        n_slices = WARPS if on_mma else 1   # a 16-key slice per warp
        qb = q[b].float().reshape(Hkv, group, hd)
        parts = [_split(qb, k[s0:min(s0 + SPLIT_KEYS, kv_len)],
                        v[s0:min(s0 + SPLIT_KEYS, kv_len)],
                        min(SPLIT_KEYS, kv_len - s0), scale_log2, tile,
                        n_slices, on_mma)
                 for s0 in range(0, kv_len, SPLIT_KEYS)]
        _, l, acc = _merge(parts)
        out[b] = torch.where(l[..., None] != 0, acc / l[..., None],
                             torch.zeros(())).reshape(Hq, hd)
    return out.to(q.dtype)


def dense_keys(k, v):
    return lambda b, n: (k[b, :n], v[b, :n])


def paged_keys(k_pages, v_pages, tables):
    ps = k_pages.shape[1]

    def keys(b, n):
        pos = torch.arange(n)
        pages = tables[b].long()[pos // ps]
        return k_pages[pages, pos % ps], v_pages[pages, pos % ps]
    return keys


def over_gate(got, want, dtype):
    """Elements of ``got`` outside the gate around ``want``."""
    g, w = got.float(), want.float()
    if dtype == torch.bfloat16:
        tol = (TOL_BF16[0] + TOL_BF16[1] * w.abs()).clamp(max=TOL_BF16_CAP)
    else:
        tol = torch.full_like(w, TOL_F32)
    return int(((g - w).abs() > tol).sum())


def _inputs(seed, B, Hq, Hkv, hd, S, dtype, ps=16):
    """q and a dense cache (B, S, Hkv, hd) from a numpy seed, ragged
    kv_lens (row 0 empty, row 1 full), and the same keys laid into
    permuted pages (n_pages, ps, Hkv, hd) with their block tables."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(dtype)
               for shape in ((B, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
    lens = rng.integers(1, S + 1, B)
    lens[0], lens[1] = 0, S
    n = S // ps
    tables = rng.permutation(B * n + 2)[: B * n].reshape(B, n)
    pools = []
    for cache in (k, v):
        pool = torch.zeros((B * n + 2, ps, Hkv, hd), dtype=dtype)
        pool[torch.from_numpy(tables.reshape(-1))] = cache.reshape(
            B * n, ps, Hkv, hd)
        pools.append(pool)
    return (q, k, v, torch.from_numpy(lens.astype(np.int32)), *pools,
            torch.from_numpy(tables.astype(np.int32)))


def test_wrapper_split_keys_match_the_kernel():
    assert native.DECODE_SPLIT_KEYS == SPLIT_KEYS
    assert SPLIT_KEYS % 64 == 0 and SPLIT_KEYS in (128, 256, 512)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_body_model_within_gate(group, dtype):
    """Three splits (the last one short), ragged lengths: within the gate of
    both plain versions and both Pallas kernels in interpret mode."""
    dt = getattr(torch, dtype)
    Hq, Hkv, hd = GROUPS[group]
    B, S = 3, 2 * SPLIT_KEYS + 64
    q, k, v, lens, kp, vp, tables = _inputs(group * 7 + len(dtype), B, Hq,
                                            Hkv, hd, S, dt)
    got = body_model(q, dense_keys(k, v), lens, S)
    assert got.dtype == dt and got.shape == q.shape
    assert bool((got[0] == 0).all()), "a row with no valid key must store 0"
    live = lens > 0
    plains = [decode_attention_plain(q, k, v, lens),
              paged_decode_attention_plain(q, kp, vp, tables, lens)]
    jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
    jq, jk, jv, jkp, jvp = (jnp.asarray(t.float().numpy(), jdt)
                            for t in (q, k, v, kp, vp))
    jl, jt = jnp.asarray(lens.numpy()), jnp.asarray(tables.numpy())
    pallas = [pallas_decode(jq, jk, jv, jl, block_k=64),
              pallas_paged_decode(jq, jkp, jvp, jt, jl)]
    for want in plains + [torch.from_numpy(np.asarray(p, np.float32))
                          for p in pallas]:
        assert over_gate(got[live], want[live], dt) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [4, 48])
def test_dense_and_paged_layouts_give_the_same_bits(group, dtype):
    dt = getattr(torch, dtype)
    Hq, Hkv, hd = GROUPS[group]
    S = SPLIT_KEYS + 96
    q, k, v, lens, kp, vp, tables = _inputs(group + 1, 3, Hq, Hkv, hd, S, dt)
    dense = body_model(q, dense_keys(k, v), lens, S)
    paged = body_model(q, paged_keys(kp, vp, tables), lens, S)
    assert torch.equal(dense, paged)


@pytest.mark.parametrize("group", [1, 12])
def test_keys_and_splits_past_kv_len_change_nothing(group):
    """NaN in every cache position at or past kv_len, and a cache two splits
    longer (splits that start past every kv_len): the same bits."""
    Hq, Hkv, hd = GROUPS[group]
    S = SPLIT_KEYS + 96
    q, k, v, lens, *_ = _inputs(group + 2, 4, Hq, Hkv, hd, S, torch.bfloat16)
    want = body_model(q, dense_keys(k, v), lens, S)
    longer = S + 2 * SPLIT_KEYS
    k2, v2 = (torch.full((4, longer, Hkv, hd), float("nan"),
                         dtype=torch.bfloat16) for _ in range(2))
    for b in range(4):
        n = int(lens[b])
        k2[b, :n], v2[b, :n] = k[b, :n], v[b, :n]
    got = body_model(q, dense_keys(k2, v2), lens, longer)
    assert torch.equal(got, want)
    assert bool((got[0] == 0).all())


@pytest.mark.parametrize("group", [1, 48])
@pytest.mark.parametrize("where", ["first split", "last split"])
def test_nan_key_reaches_only_its_rows(group, where):
    """A NaN key (K and V, every kv head) of a valid position of sequence 1,
    which spans three splits: every row of sequence 1 is NaN after the
    merge, every other row keeps its bits."""
    Hq, Hkv, hd = GROUPS[group]
    S = 2 * SPLIT_KEYS + 64
    q, k, v, lens, *_ = _inputs(group + 3, 3, Hq, Hkv, hd, S, torch.bfloat16)
    clean = body_model(q, dense_keys(k, v), lens, S)
    pos = 5 if where == "first split" else S - 1
    k, v = k.clone(), v.clone()
    k[1, pos] = float("nan")
    v[1, pos] = float("nan")
    got = body_model(q, dense_keys(k, v), lens, S)
    assert bool(torch.isnan(got[1]).all())
    assert torch.equal(got[[0, 2]], clean[[0, 2]])
