"""The arithmetic of the port's bf16 chunked-prefill attention body
(``csrc/prefill_wgmma.cuh``, shared by ``chunked_prefill_attention`` and the
two paged prefill kernels), modelled in plain PyTorch on the CPU.

The body runs both products on the tensor cores: S = Q K^T from bf16 Q and K
with f32 accumulators, scaled by 1/sqrt(hd) (times log2 e) in f32 after the
product; an f32 online softmax over 64-key tiles in base 2; and O += P V with
P split into P_hi = bf16(P) and P_lo = bf16(P - P_hi), two bf16 products into
one f32 accumulator.  The model repeats that arithmetic, and these tests hold
it within ``chip_smoke.py``'s bf16 gate (|d| <= 1e-5 + 2**-7 |want|, at most
2e-2) of ``chunked_prefill_attention_plain`` and of the JAX package's
``chunked_prefill_attention`` in interpret mode, and show that a single bf16
P misses that gate: the split is what the gate needs, not a nicety.

The CUDA kernel itself needs nvcc and a card; ``chip_smoke.py`` holds it
against the plain version on the GPU under the same gate.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.chunked_prefill_attention import (
    chunked_prefill_attention as pallas_chunked_prefill,
)
from repro_torch.kernels.chunked_prefill_attention import (
    chunked_prefill_attention_plain,
)

TOL_BF16 = (1e-5, 2.0 ** -7)     # chip_smoke.py's bf16 gate (atol, rtol)
TOL_BF16_CAP = 2e-2
TILE_KEYS = 64                   # keys per tile of the body
LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def body_model(q, k, v, kv_lens, q_offset, split_p=True):
    """What the tensor-core body computes, in f32 on the CPU: q (B, Sq, Hq,
    hd), k and v (B, Skv, Hkv, hd) in bf16 -> (B, Sq, Hq, hd) bf16.  A row
    with no valid key is 0, as the kernel stores it."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    # the wrapper passes 1/sqrt(hd) as a C float; the launch multiplies it by
    # log2 e in f32
    scale_log2 = (torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
                  * torch.tensor(LOG2E, dtype=torch.float32))
    qf = q.float().reshape(B, Sq, Hkv, g, hd)
    kf, vf = k.float(), v.float()
    q_pos = q_offset.long()[:, None] + torch.arange(Sq)[None, :]    # (B, Sq)
    m = torch.full((B, Hkv, g, Sq), -1e30)
    l = torch.zeros((B, Hkv, g, Sq))
    o = torch.zeros((B, Hkv, g, Sq, hd))
    for t0 in range(0, Skv, TILE_KEYS):
        kt, vt = kf[:, t0:t0 + TILE_KEYS], vf[:, t0:t0 + TILE_KEYS]
        k_pos = torch.arange(t0, t0 + kt.shape[1])
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kt) * scale_log2
        mask = ((k_pos[None, None, :] <= q_pos[:, :, None])
                & (k_pos[None, None, :] < kv_lens.long()[:, None, None]))
        s = s.masked_fill(~mask[:, None, None], -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        if split_p:
            hi = _bf16(p)
            pv = (torch.einsum("bhgqk,bkhd->bhgqd", hi, vt)
                  + torch.einsum("bhgqk,bkhd->bhgqd", _bf16(p - hi), vt))
        else:
            pv = torch.einsum("bhgqk,bkhd->bhgqd", _bf16(p), vt)
        o = o * alpha[..., None] + pv
        m = m_new
    out = torch.where(l[..., None] != 0, o / l[..., None], torch.zeros(()))
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd).to(q.dtype)


def over_gate(got, want):
    """Number of elements of ``got`` outside the bf16 gate around ``want``."""
    g, w = got.float(), want.float()
    tol = (TOL_BF16[0] + TOL_BF16[1] * w.abs()).clamp(max=TOL_BF16_CAP)
    return int(((g - w).abs() > tol).sum())


def _inputs(seed, B, Sq, Skv, Hq, Hkv, hd):
    """bf16 normals from a numpy seed; ragged lengths: sequence 0 has no key
    at all, the last one a full chunk at the longest prefix."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(torch.bfloat16)
               for shape in ((B, Sq, Hq, hd), (B, Skv, Hkv, hd),
                             (B, Skv, Hkv, hd)))
    q_off = rng.integers(0, Skv - Sq + 1, B)
    chunk = rng.integers(1, Sq + 1, B)
    q_off[-1], chunk[-1] = Skv - Sq, Sq
    q_off[0], chunk[0] = 0, 0
    q_offset = torch.from_numpy(q_off.astype(np.int32))
    kv_lens = torch.from_numpy((q_off + chunk).astype(np.int32))
    return q, k, v, kv_lens, q_offset


@pytest.mark.parametrize("Sq", [1, 16, 64])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("Hq,Hkv", [(2, 2), (4, 2), (4, 1)])  # MHA, GQA 2, 4
def test_body_model_within_gate(Hq, Hkv, hd, Sq):
    B, Skv = 3, 128
    q, k, v, kv_lens, q_offset = _inputs(Sq * 1000 + hd + Hq * 10 + Hkv, B,
                                         Sq, Skv, Hq, Hkv, hd)
    got = body_model(q, k, v, kv_lens, q_offset)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert bool((got[0] == 0).all()), "a row with no valid key must store 0"
    live = kv_lens > 0
    plain = chunked_prefill_attention_plain(q, k, v, kv_lens, q_offset)
    assert over_gate(got[live], plain[live]) == 0
    pallas = pallas_chunked_prefill(
        jnp.asarray(q.float().numpy(), jnp.bfloat16),
        jnp.asarray(k.float().numpy(), jnp.bfloat16),
        jnp.asarray(v.float().numpy(), jnp.bfloat16),
        jnp.asarray(kv_lens.numpy()), jnp.asarray(q_offset.numpy()),
        block_q=min(Sq, 64), block_k=64)
    pallas = torch.from_numpy(np.asarray(pallas, np.float32))
    assert over_gate(got[live], pallas[live]) == 0


@pytest.mark.parametrize("hd", [64, 128])
def test_single_bf16_p_misses_the_gate(hd):
    """Causal Sq=64 over 512 keys: a single bf16 P puts some outputs outside
    the gate (those near 0, where the 1e-5 floor binds); the hi + lo split
    puts none there."""
    B, Sq, Skv, H = 1, 64, 512, 8
    rng = np.random.default_rng(hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(torch.bfloat16)
               for shape in ((B, Sq, H, hd), (B, Skv, H, hd), (B, Skv, H, hd)))
    q_offset = torch.tensor([Skv - Sq], dtype=torch.int32)
    kv_lens = torch.tensor([Skv], dtype=torch.int32)
    plain = chunked_prefill_attention_plain(q, k, v, kv_lens, q_offset)
    split = body_model(q, k, v, kv_lens, q_offset)
    single = body_model(q, k, v, kv_lens, q_offset, split_p=False)
    assert over_gate(split, plain) == 0
    assert over_gate(single, plain) > plain.numel() // 100
