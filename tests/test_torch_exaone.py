"""Layers of mixed kinds in the engine round (the K-EXAONE form of
``bench/configs/k-exaone-8l.json``) on the CPU at a tiny size, against the
benchmark's plain reference (``bench/reference/exaone_moe.py``, loaded by
path), and the windowed attention kernels.

(a) ``chunked_step_paged`` in the split and the fused layout: prompts
    prefilled in uneven chunks, then decoded through the cache, each
    sampled position's logits against the reference's whole forward pass;
    float32 on both sides.
(b) The same comparison fails when the program leaves out one piece of the
    block: QK-norm, NoPE on the global layers (RoPE there), the window,
    post-norm (pre-norm), sigmoid routing, the selection bias, the routed
    scale, the shared expert.
(c) The expert share: the routed outputs of the two held halves of the
    experts, with the shared expert counted once, add up to the uncut
    reference's layer.
(d) The windowed plain versions (``kernels/ref.py``) against a masked
    softmax written out key by key.
(e) A uniform window (tiny mixtral-8x7b) through ``chunked_step_paged``
    equals the whole-prompt ``prefill`` and the ring ``decode``; the dense
    per-slot layout, ``prefill`` and ``decode`` refuse mixed layers.
(f) On a card only (skipped without one): the windowed CUDA decode and
    prefill kernels against their plain versions.
"""
import copy
import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import tiny_config
from repro_torch.kernels import ref
from repro_torch.models import layers as L
from repro_torch.models.transformer import TransformerLM

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:          # the benchmark's modules import bench.*
    sys.path.insert(0, str(ROOT))

from bench import cell as cells, weights  # noqa: E402

# float32 on both sides: the round sums in other orders than the reference
# (attention chunk by chunk through pages, the experts tile by tile, the
# choices combined after), about 1e-6 on logits of order 1 here; every
# fault of (b) moves some logit by more than 1e-2
TOL = 1e-4
PAGE = 4
SEED = 2**31 + 29


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_exaone(n_held=4, first_held=0):
    """The configuration file cut to D 64, 4/2 heads of 16, window 4, 8
    layers LLLG LLLG with the dense layer 0, 8 experts top-2 of which
    ``n_held`` are held, one shared expert; float32."""
    c = copy.deepcopy(cells.load_json(ROOT / "bench/configs/k-exaone-8l.json"))
    c.update(hidden_size=64, intermediate_size=96, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, vocab_size=512,
             moe_intermediate_size=32, num_experts=n_held,
             first_held_expert=first_held, num_experts_per_tok=2,
             published={"num_hidden_layers": 48, "num_experts": 8},
             sliding_windows=[4 if w else 0 for w in c["sliding_windows"]],
             torch_dtype="float32")
    assert c["num_hidden_layers"] == 8
    return c


def _model(config):
    return cells.model_module(config, ROOT)


def _reference():
    return cells.reference_module({"reference": "exaone_moe"}, ROOT)


@pytest.fixture(scope="module")
def exaone():
    """(config, ModelConfig, stacks, params) of the tiny form."""
    config = tiny_exaone()
    model = _model(config)
    mcfg = model.program_config(config)
    stacks = weights.make_stacks(model.draws(config, mcfg), SEED, "cpu")
    return config, mcfg, stacks, model.as_params(mcfg, stacks)


PROMPTS = [[(7 * i + 3) % 509 + 1 for i in range(23)],
           [(11 * i + 5) % 503 + 1 for i in range(17)],
           [(13 * i + 1) % 499 + 1 for i in range(9)]]
CHUNKS = [5, 7, 3, 8]
DECODE = 6


def serve_logits(mcfg, params, layout):
    """Every prompt prefilled in chunks of ``CHUNKS`` in turn (rounds mix
    slots at different offsets), then ``DECODE`` rounds of one token each,
    fed the ids ``(last + 1) % V``: (the sequences, each slot's logits at
    its last prompt position and at each decoded one, the MoE counter)."""
    impl = TransformerLM(mcfg)
    B, L_, hd = len(PROMPTS), mcfg.n_layers, mcfg.resolved_head_dim
    n_pages, max_pages = 64, 16
    shape = (L_, n_pages, PAGE, mcfg.n_kv_heads, hd)
    if layout == "fused":
        pool = {"kv": torch.zeros(shape[:3] + (2 * mcfg.n_kv_heads, hd))}
    else:
        pool = {n: torch.zeros(shape) for n in ("k", "v")}
    tables = torch.arange(B * max_pages, dtype=torch.int32).view(B, max_pages)
    lens = torch.zeros(B, dtype=torch.int32)
    seqs = [list(p) for p in PROMPTS]
    done = [0] * B
    got = [[] for _ in range(B)]
    counts = torch.zeros(3, dtype=torch.long)
    r = 0
    while any(d < len(p) for d, p in zip(done, PROMPTS)):
        lists = []
        for b, p in enumerate(PROMPTS):
            c = CHUNKS[(r + b) % len(CHUNKS)]
            lists.append(p[done[b]:done[b] + c])
        r += 1
        logits = _round(impl, pool, lens, tables, lists, counts,
                        mcfg, params)
        for b, t in enumerate(lists):
            done[b] += len(t)
            lens[b] += len(t)
            if t and done[b] == len(PROMPTS[b]):
                got[b].append(logits[b])
    for _ in range(DECODE):
        lists = [[(s[-1] + 1) % mcfg.vocab_size] for s in seqs]
        for s, t in zip(seqs, lists):
            s.extend(t)
        logits = _round(impl, pool, lens, tables, lists, counts,
                        mcfg, params)
        lens += 1
        for b in range(B):
            got[b].append(logits[b])
    return seqs, [torch.stack(g) for g in got], counts


def _round(impl, pool, lens, tables, lists, counts, mcfg, params):
    C = max(1, max(len(t) for t in lists))
    tokens = torch.zeros((len(lists), C), dtype=torch.long)
    chunk = torch.zeros(len(lists), dtype=torch.int32)
    for b, t in enumerate(lists):
        tokens[b, :len(t)] = torch.tensor(t, dtype=torch.long)
        chunk[b] = len(t)
    return impl.chunked_step_paged(params, tokens, pool, lens.clone(), chunk,
                                   tables, moe_counts=counts)


def reference_logits(config, stacks, seqs):
    """The reference's logits at each sampled position of each sequence:
    the last prompt position, then each decoded one."""
    ref_mod = _reference()
    return [ref_mod.logits(config, stacks, s, len(p) - 1)
            for s, p in zip(seqs, PROMPTS)]


def worst_gap(config, stacks, seqs, got):
    return max((g - w).abs().max().item() for g, w in
               zip(got, reference_logits(config, stacks, seqs)))


@pytest.mark.parametrize("layout", ["split", "fused"])
def test_paged_round_equals_the_reference(exaone, layout):
    config, mcfg, stacks, params = exaone
    seqs, got, counts = serve_logits(mcfg, params, layout)
    assert [len(g) for g in got] == [DECODE + 1] * len(PROMPTS)
    assert worst_gap(config, stacks, seqs, got) < TOL
    # every real token's two choices in each of the 7 sparse layers: held
    # (computed) or absent (dropped), none lost
    tokens = sum(len(p) for p in PROMPTS) + DECODE * len(PROMPTS)
    assert int(counts[1] + counts[2]) == tokens * 2 * 7
    assert 0 < int(counts[2]) < tokens * 2 * 7


def _no_qk_norm(mcfg, params):
    for lp in params["layers"]:
        del lp["attn"]["q_norm"], lp["attn"]["k_norm"]
    return mcfg


def _rope_everywhere(mcfg, params):
    return mcfg.with_(layer_rope=(True,) * mcfg.n_layers)


def _no_window(mcfg, params):
    return mcfg.with_(layer_windows=(0,) * mcfg.n_layers)


def _pre_norm(mcfg, params):
    for lp in params["layers"]:
        lp["attn_norm"] = lp.pop("post_attn_norm")
        lp["ffn_norm"] = lp.pop("post_ffn_norm")
    return mcfg.with_(post_norm=False)


def _moe(**kw):
    def fault(mcfg, params):
        return mcfg.with_(moe=dataclasses.replace(mcfg.moe, **kw))
    return fault


def _no_selection_bias(mcfg, params):
    for lp in params["layers"]:
        if "moe" in lp:
            lp["moe"]["router_bias"] = torch.zeros_like(lp["moe"]["router_bias"])
    return mcfg


def _no_shared(mcfg, params):
    for lp in params["layers"]:
        lp.get("moe", {}).pop("shared", None)
    return mcfg


FAULTS = {"no_qk_norm": _no_qk_norm, "rope_on_global": _rope_everywhere,
          "window_ignored": _no_window, "pre_norm": _pre_norm,
          "softmax_routing": _moe(scoring="softmax"),
          "no_selection_bias": _no_selection_bias,
          "no_routed_scale": _moe(routed_scale=1.0),
          "no_shared_expert": _no_shared}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_comparison_fails_without_a_piece_of_the_block(exaone, fault):
    config, mcfg, stacks, params = exaone
    params = {**params, "layers": [
        {k: (dict(v) if isinstance(v, dict) else v) for k, v in lp.items()}
        for lp in params["layers"]]}
    bad = FAULTS[fault](mcfg, params)
    seqs, got, _ = serve_logits(bad, params, "split")
    assert worst_gap(config, stacks, seqs, got) > 1e-2


def test_two_halves_of_the_experts_add_up_to_the_uncut_layer():
    """A sparse layer of the uncut form (all 8 experts held) in the
    reference; the program's routed outputs with experts 0-3 held and with
    4-7 held, plus the shared expert once."""
    whole = tiny_exaone(n_held=8)
    model = _model(whole)
    mcfg = model.program_config(whole)
    stacks = weights.make_stacks(model.draws(whole, mcfg), SEED + 1, "cpu")
    x = torch.randn((3, 5, 64), generator=torch.Generator().manual_seed(3))
    lanes = torch.ones((3, 5), dtype=torch.bool)
    i = 2                                         # a sparse layer
    ref_mod = _reference()
    want = ref_mod.experts(ref_mod.Linear(False), x.reshape(15, 64), whole,
                           stacks, i).reshape(3, 5, 64)
    moe = {"router": stacks["router"][i], "router_bias": stacks["router_bias"][i]}
    total = L.ffn({"w_gate": stacks["s_gate"][i], "w_up": stacks["s_up"][i],
                   "w_down": stacks["s_down"][i]}, x)
    absent = 0
    for first in (0, 4):
        half = mcfg.with_(moe=dataclasses.replace(mcfg.moe, first_held=first,
                                                  n_held=4))
        p = dict(moe, **{k: stacks[e][i][first:first + 4] for k, e in
                         (("w_gate", "e_gate"), ("w_up", "e_up"),
                          ("w_down", "e_down"))})
        counts = torch.zeros(3, dtype=torch.long)
        total = total + L.moe_round(p, x, half, lanes, counts)
        absent += int(counts[2])
        assert int(counts[1] + counts[2]) == 15 * 2
    assert absent == 15 * 2               # each choice absent from one half
    torch.testing.assert_close(total, want, atol=1e-5, rtol=1e-5)


def naive_window_attention(q, k, v, q_pos, kv_len, window):
    """One sequence: q (Sq, Hq, hd), k/v (S, Hkv, hd); query i at q_pos[i]
    over keys j <= q_pos[i], j < kv_len, j > q_pos[i] - window, each
    softmax written out key by key in float64."""
    Sq, Hq, hd = q.shape
    g = Hq // k.shape[1]
    out = torch.zeros((Sq, Hq, hd), dtype=torch.float64)
    for i in range(Sq):
        keys = [j for j in range(kv_len)
                if j <= q_pos[i] and (not window or j > q_pos[i] - window)]
        for h in range(Hq):
            s = torch.stack([(q[i, h].double() * k[j, h // g].double()).sum()
                             / math.sqrt(hd) for j in keys])
            p = torch.exp(s - s.max())
            p = p / p.sum()
            out[i, h] = sum(p[n] * v[j, h // g].double()
                            for n, j in enumerate(keys))
    return out


@pytest.mark.parametrize("window", [1, 4, 9])
def test_windowed_plain_versions_mask_below_the_window(window):
    gen = torch.Generator().manual_seed(window)
    B, Hq, Hkv, hd, ps, n_pages, max_pages = 2, 4, 2, 8, 4, 12, 5
    k = torch.randn((n_pages, ps, Hkv, hd), generator=gen)
    v = torch.randn((n_pages, ps, Hkv, hd), generator=gen)
    tables = torch.tensor([[3, 0, 7, 1, 9], [2, 5, 4, 11, 6]],
                          dtype=torch.int32)
    q_off = torch.tensor([6, 0], dtype=torch.int32)
    Sq = 5
    kv_lens = q_off + Sq
    q = torch.randn((B, Sq, Hq, hd), generator=gen)
    kd, vd = ref.gather_pages(k, tables), ref.gather_pages(v, tables)
    pre = ref.paged_prefill_attention_ref(q, k, v, tables, kv_lens, q_off,
                                          window)
    pre_f = ref.paged_prefill_attention_fused_ref(
        q, ref.fuse_pages(k, v), tables, kv_lens, q_off, window)
    dec = ref.paged_decode_attention_ref(q[:, 0], k, v, tables, kv_lens,
                                         window)
    dec_f = ref.paged_decode_attention_fused_ref(
        q[:, 0], ref.fuse_pages(k, v), tables, kv_lens, window)
    for b in range(B):
        pos = [int(q_off[b]) + i for i in range(Sq)]
        want = naive_window_attention(q[b], kd[b], vd[b], pos, int(kv_lens[b]),
                                      window).float()
        torch.testing.assert_close(pre[b], want, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(pre_f[b], want, atol=1e-5, rtol=1e-5)
        want = naive_window_attention(q[b, :1], kd[b], vd[b],
                                      [int(kv_lens[b]) - 1], int(kv_lens[b]),
                                      window).float()[0]
        torch.testing.assert_close(dec[b], want, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(dec_f[b], want, atol=1e-5, rtol=1e-5)


def test_uniform_window_round_equals_prefill_and_ring_decode():
    """Tiny mixtral-8x7b (window 32, experts dropless at its tiny capacity
    factor 8.0): a 40-token prompt through ``chunked_step_paged`` in
    chunks, then 6 decodes, against the whole-prompt ``prefill`` and the
    ring ``decode`` on the same weights."""
    cfg = tiny_config("mixtral-8x7b").with_(param_dtype="float32")
    assert cfg.sliding_window == 32
    impl = TransformerLM(cfg)
    params = impl.init(torch.Generator().manual_seed(5), "cpu")
    prompt = [(17 * i + 2) % 500 + 1 for i in range(40)]
    steps = [(5 * i + 1) % 500 + 1 for i in range(6)]
    shape = (cfg.n_layers, 16, 8, cfg.n_kv_heads, cfg.resolved_head_dim)
    pool = {n: torch.zeros(shape) for n in ("k", "v")}
    tables = torch.arange(8, dtype=torch.int32)[None]
    lens = torch.zeros(1, dtype=torch.int32)
    got = []
    for piece in [prompt[:13], prompt[13:29], prompt[29:]] + [[t] for t in steps]:
        out = impl.chunked_step_paged(
            params, torch.tensor([piece]), pool, lens.clone(),
            torch.tensor([len(piece)], dtype=torch.int32), tables)
        lens += len(piece)
        got.append(out[0])
    want = []
    logits, cache = impl.prefill(params, {"tokens": torch.tensor([prompt])})
    want.append(logits[0])
    n = torch.tensor([len(prompt)], dtype=torch.int32)
    for t in steps:
        logits, cache = impl.decode(params, torch.tensor([[t]]), cache, n)
        n += 1
        want.append(logits[0])
    torch.testing.assert_close(torch.stack(got[2:]), torch.stack(want),
                               atol=1e-4, rtol=1e-4)


def test_mixed_layers_are_refused_outside_the_paged_round(exaone):
    _, mcfg, _, params = exaone
    impl = TransformerLM(mcfg)
    tokens = torch.ones((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="chunked_step_paged"):
        impl.prefill(params, {"tokens": tokens})
    with pytest.raises(NotImplementedError, match="chunked_step_paged"):
        impl.train_hidden(params, {"tokens": tokens})
    shape = (mcfg.n_layers, 1, 9, mcfg.n_kv_heads, mcfg.resolved_head_dim)
    cache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    with pytest.raises(NotImplementedError, match="chunked_step_paged"):
        impl.decode(params, tokens[:, :1], cache, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="paged layouts take windows"):
        impl.chunked_step(params, tokens, cache, torch.zeros(1, dtype=torch.int32),
                          torch.ones(1, dtype=torch.int32))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the windowed kernels run on the card")


# a kernel's output against its plain version: within one bf16 step of the
# f32 answer (the kernel rounds its f32 sums once, as the plain version's
# cast does, from other orders of summation), 1e-5 in f32
BF16_STEP = (1e-5, 2.0 ** -7)


def _close(got, want):
    atol, rtol = BF16_STEP if got.dtype == torch.bfloat16 else (1e-5, 0.0)
    err = (got.float() - want.float()).abs()
    tol = atol + rtol * want.float().abs()
    assert bool((err <= tol).all()), f"max |d| {err.max().item():.3e}"


# (B, Hq, Hkv, hd, window, max context): exaone's heads at its window; a
# window past one decode split (512 keys) and past the context
KERNEL_CASES = [(16, 64, 8, 128, 128, 1200), (4, 32, 8, 128, 700, 2100),
                (3, 16, 16, 64, 4096, 900), (5, 8, 8, 64, 1, 300)]


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", range(len(KERNEL_CASES)))
def test_windowed_kernels_equal_their_plain_versions(card, case, dtype):
    from repro_torch.kernels import native
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention, paged_decode_attention_fused)
    from repro_torch.kernels.paged_prefill_attention import (
        paged_prefill_attention, paged_prefill_attention_fused)

    native.build_all()
    B, Hq, Hkv, hd, W, ctx = KERNEL_CASES[case]
    dt = getattr(torch, dtype)
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(case)
    ps = 16
    max_pages = ctx // ps + 2
    n_pages = B * max_pages + 1
    k = torch.randn((n_pages, ps, Hkv, hd), generator=gen, device=dev).to(dt)
    v = torch.randn((n_pages, ps, Hkv, hd), generator=gen, device=dev).to(dt)
    tables = torch.randperm(n_pages - 1, generator=gen, device=dev)[
        :B * max_pages].view(B, max_pages).int()
    kv = ref.fuse_pages(k, v)
    lens = torch.randint(1, ctx, (B,), generator=gen, device=dev).int()
    lens[0] = ctx                          # one row at the longest context
    q = torch.randn((B, Hq, hd), generator=gen, device=dev).to(dt)
    for window in (0, W):
        want = ref.paged_decode_attention_ref(q, k, v, tables, lens, window)
        _close(paged_decode_attention(q, k, v, tables, lens, window), want)
        _close(paged_decode_attention_fused(q, kv, tables, lens, window), want)
    for Sq in (1, 16, 128):
        off = (lens - Sq).clamp(min=0)
        qs = torch.randn((B, Sq, Hq, hd), generator=gen, device=dev).to(dt)
        kv_lens = off + Sq
        for window in (0, W):
            want = ref.paged_prefill_attention_ref(qs, k, v, tables, kv_lens,
                                                   off, window)
            got = paged_prefill_attention(qs, k, v, tables, kv_lens, off,
                                          window)
            _close(got, want)
            fused = paged_prefill_attention_fused(qs, kv, tables, kv_lens,
                                                  off, window)
            assert torch.equal(fused, got)
