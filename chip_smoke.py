#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each of which raises (exit code != 0) on failure:

1. device: the card's name and power limit (``nvidia-smi``).
2. build: compile every CUDA kernel of the serving path from ``csrc/``
   (one ``nvcc`` per source, in parallel) and print ptxas's report.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes (full-width qwen1.5-0.5b: B=16, Hq=Hkv=16, hd=64,
   page 16, ragged kv_lens up to 512 through permuted block tables, every
   chunk bucket) and one GQA shape (32/8 heads, as llama3.2-1b) at head
   dims 64 and 128; on rows with a valid key, |d| <= 1e-5 + 2**-7 |plain|
   (one bf16 rounding step, and never over 2e-2) in bf16 and <= 1e-5 in f32.
   Times the kernel, the plain version and ``scaled_dot_product_attention``
   over the gathered dense K/V (``library_ms``, a yardstick the port never
   calls) with CUDA events, L2 flushed before each launch; computes the
   least time the card could take (``bound_ms``).
4. reference: one prefill round and one decode round of the full-width model
   through the kernels on the card against the same rounds on the CPU
   through the plain versions (same bf16 weights; bf16 tolerance).
5. serve: what ``python -m repro_torch.launch.serve --full`` runs -- 32
   ShareGPT-like requests through the pipelined engine with paged KV --
   with the kernels' launch counters zeroed after warm-up; every request
   must finish with its full token count and both kernels must have run
   (decode 24 times per pure-decode round).

The second-to-last line is a JSON object listing every kernel with its
numbers; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core peak
# kernel and plain version both accumulate in f32 and round the output once,
# so in bf16 they may differ by one rounding step: one bf16 ulp is at most
# 2**-7 |x|.  Never more than 2e-2 absolute.
TOL_F32 = (1e-5, 0.0)          # (atol, rtol)
TOL_BF16 = (1e-5, 2.0 ** -7)
TOL_BF16_CAP = 2e-2
ITERS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


# -- inputs --------------------------------------------------------------------
def paged_inputs(gen, *, B, Hq, Hkv, hd, ps, max_pages, n_pages, dtype, dev):
    """Random q-independent K/V pools and permuted block tables."""
    import torch
    k = torch.randn((n_pages, ps, Hkv, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((n_pages, ps, Hkv, hd), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev)
    tables = perm[: B * max_pages].reshape(B, max_pages).to(torch.int32)
    return k, v, tables.contiguous()


def chunk_lens_for(gen, B, Sq, max_ctx, dev):
    """(q_offset, kv_lens) of a mixed round: row 0 idle, row 1 a decode,
    row 2 a full chunk at the longest prefix, the rest ragged."""
    import torch
    chunk = torch.randint(1, Sq + 1, (B,), generator=gen, device=dev)
    prefix = torch.randint(0, max_ctx - Sq + 1, (B,), generator=gen, device=dev)
    chunk[1], chunk[2], prefix[2] = 1, Sq, max_ctx - Sq
    chunk[0], prefix[0] = 0, 0
    return prefix.to(torch.int32), (prefix + chunk).to(torch.int32)


# -- timing --------------------------------------------------------------------
class Timer:
    """Median of ITERS single launches, each timed with CUDA events after an
    L2 flush (a real serving round finds this layer's pages cold)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(ITERS):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want, live):
    """Max |got - want| over rows with a valid key; raises unless every
    element is within atol + rtol |want| (and TOL_BF16_CAP)."""
    import torch
    atol, rtol = TOL_BF16 if got.dtype == torch.bfloat16 else TOL_F32
    g, w = got[live].float(), want[live].float()
    err = (g - w).abs()
    tol = (atol + rtol * w.abs()).clamp(max=TOL_BF16_CAP)
    if not bool((err <= tol).all()):
        i = int((err - tol).argmax())
        raise AssertionError(
            f"kernel disagrees with its plain version: |d| "
            f"{err.flatten()[i].item():.3e} at |want| "
            f"{w.abs().flatten()[i].item():.3e} (tol {atol} + {rtol} |want|); "
            f"max |d| {err.max().item():.3e}")
    return err.max().item()


# -- phase 3: kernels vs plain versions ----------------------------------------
def decode_case(torch, timer, gen, *, B, Hq, Hkv, hd, ps, max_pages, n_pages,
                dtype, timed):
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention, paged_decode_attention_plain)
    import torch.nn.functional as F

    dev = "cuda"
    k, v, tables = paged_inputs(gen, B=B, Hq=Hq, Hkv=Hkv, hd=hd, ps=ps,
                                max_pages=max_pages, n_pages=n_pages,
                                dtype=dtype, dev=dev)
    q = torch.randn((B, Hq, hd), generator=gen, device=dev).to(dtype)
    max_ctx = (max_pages - 1) * ps
    kv_lens = torch.randint(1, max_ctx + 1, (B,), generator=gen,
                            device=dev).to(torch.int32)
    kv_lens[0], kv_lens[1] = 0, max_ctx
    args = (q, k, v, tables, kv_lens)
    got = paged_decode_attention(*args)
    want = paged_decode_attention_plain(*args)
    torch.cuda.synchronize()
    live = kv_lens > 0
    if not bool((got[~live] == 0).all()):
        raise AssertionError("decode kernel: a row with no valid key is not 0")
    err = max_err(got, want, live)
    if not timed:
        return {"max_abs_err": err}
    # library yardstick: SDPA over the gathered dense K/V
    kd = ref.gather_pages(k, tables).transpose(1, 2)           # (B, Hkv, S, hd)
    vd = ref.gather_pages(v, tables).transpose(1, 2)
    S = kd.shape[2]
    mask = (torch.arange(S, device=dev)[None, :] < kv_lens[:, None].long())
    mask = mask[:, None, None, :]
    q4 = q[:, :, None, :]
    ms = timer(lambda: paged_decode_attention(*args))
    plain_ms = timer(lambda: paged_decode_attention_plain(*args))
    lib_ms = timer(lambda: F.scaled_dot_product_attention(
        q4, kd, vd, attn_mask=mask))
    keys = int(kv_lens.sum())
    esz = q.element_size()
    n_pages_live = int(((kv_lens + ps - 1) // ps).sum())
    n_bytes = (2 * q.numel() * esz + 2 * keys * Hkv * hd * esz
               + 4 * (B + n_pages_live))
    n_flops = 4 * keys * Hq * hd
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "shape": f"B={B} Hq={Hq} Hkv={Hkv} hd={hd} ps={ps} "
                     f"kv_lens<={max_ctx} (sum {keys})"}


def prefill_case(torch, timer, gen, *, B, Sq, Hq, Hkv, hd, ps, max_pages,
                 n_pages, dtype, timed):
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_prefill_attention import (
        paged_prefill_attention, paged_prefill_attention_plain)
    import torch.nn.functional as F

    dev = "cuda"
    k, v, tables = paged_inputs(gen, B=B, Hq=Hq, Hkv=Hkv, hd=hd, ps=ps,
                                max_pages=max_pages, n_pages=n_pages,
                                dtype=dtype, dev=dev)
    q = torch.randn((B, Sq, Hq, hd), generator=gen, device=dev).to(dtype)
    max_ctx = (max_pages - 1) * ps
    q_offset, kv_lens = chunk_lens_for(gen, B, Sq, max_ctx, dev)
    args = (q, k, v, tables, kv_lens, q_offset)
    got = paged_prefill_attention(*args)
    want = paged_prefill_attention_plain(*args)
    torch.cuda.synchronize()
    live = kv_lens > 0                     # key 0 is visible to every row
    if not bool((got[~live] == 0).all()):
        raise AssertionError("prefill kernel: a row with no valid key is not 0")
    err = max_err(got, want, live)
    if not timed:
        return {"max_abs_err": err}
    kd = ref.gather_pages(k, tables).transpose(1, 2)           # (B, Hkv, S, hd)
    vd = ref.gather_pages(v, tables).transpose(1, 2)
    S = kd.shape[2]
    pos_q = q_offset[:, None].long() + torch.arange(Sq, device=dev)[None, :]
    pos_k = torch.arange(S, device=dev)
    mask = ((pos_k[None, None, :] <= pos_q[:, :, None])
            & (pos_k[None, None, :] < kv_lens[:, None, None].long()))
    mask = mask[:, None]                                       # (B, 1, Sq, S)
    qt = q.transpose(1, 2)
    ms = timer(lambda: paged_prefill_attention(*args))
    plain_ms = timer(lambda: paged_prefill_attention_plain(*args))
    lib_ms = timer(lambda: F.scaled_dot_product_attention(
        qt, kd, vd, attn_mask=mask))
    # the work these inputs need: each row's visible keys, each live key's
    # K/V bytes once
    vis = torch.minimum(kv_lens[:, None].long(), pos_q + 1).clamp(min=0)
    vis = vis * (kv_lens[:, None] > 0)
    keys = int(kv_lens.sum())
    esz = q.element_size()
    n_pages_live = int(((kv_lens + ps - 1) // ps).sum())
    n_bytes = (2 * q.numel() * esz + 2 * keys * Hkv * hd * esz
               + 4 * (2 * B + n_pages_live))
    n_flops = 4 * int(vis.sum()) * Hq * hd
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "shape": f"B={B} Sq={Sq} Hq={Hq} Hkv={Hkv} hd={hd} ps={ps} "
                     f"kv_lens<={max_ctx}"}


def kernel_phase(torch):
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer(torch)
    # main path: full-width qwen1.5-0.5b at serve defaults -- n_slots 16,
    # max_context 512 (33 pages per table), the serve pool of 2049 pages
    qwen = dict(B=16, Hq=16, Hkv=16, hd=64, ps=16, max_pages=33, n_pages=2049)
    gqa = dict(qwen, Hq=32, Hkv=8)                  # llama3.2-1b heads
    gqa128 = dict(gqa, hd=128)                      # the other head dim built
    bf16, f32 = torch.bfloat16, torch.float32
    results = {}
    dec = decode_case(torch, timer, gen, dtype=bf16, timed=True, **qwen)
    log(f"  decode  qwen bf16 {dec['shape']}: err {dec['max_abs_err']:.3e} "
        f"kernel {dec['ms']:.4f} ms plain {dec['plain_ms']:.4f} ms "
        f"sdpa {dec['library_ms']:.4f} ms bound {dec['bound_ms']:.4f} ms "
        f"({dec['bound_by']})")
    results["paged_decode_attention"] = dec
    for dtype, shape, name in ((bf16, gqa, "gqa bf16"),
                               (bf16, gqa128, "gqa hd=128 bf16"),
                               (f32, qwen, "qwen f32")):
        r = decode_case(torch, timer, gen, dtype=dtype, timed=False, **shape)
        log(f"  decode  {name}: err {r['max_abs_err']:.3e}")
    buckets = {}
    for Sq in (16, 32, 64, 128, 256):
        r = prefill_case(torch, timer, gen, Sq=Sq, dtype=bf16, timed=True, **qwen)
        buckets[Sq] = r
        log(f"  prefill qwen bf16 {r['shape']}: err {r['max_abs_err']:.3e} "
            f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
            f"sdpa {r['library_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    for dtype, shape, Sq, name in ((bf16, gqa, 64, "gqa bf16 Sq=64"),
                                   (bf16, gqa128, 64, "gqa hd=128 bf16 Sq=64"),
                                   (f32, qwen, 128, "qwen f32 Sq=128")):
        r = prefill_case(torch, timer, gen, Sq=Sq, dtype=dtype, timed=False,
                         **shape)
        log(f"  prefill {name}: err {r['max_abs_err']:.3e}")
    # the kernels line reports Sq=128 (the token budget) and the worst error
    # over every bucket
    pre = dict(buckets[128])
    pre["max_abs_err"] = max(b["max_abs_err"] for b in buckets.values())
    results["paged_prefill_attention"] = pre
    return results


# -- phase 4: full-width model, kernels on the card vs plain on the CPU --------
def reference_phase(torch, model_cfg, params):
    from repro_torch.models.model import build_model

    impl = build_model(model_cfg).impl
    ps, n_phys, B = 16, 16, 2
    hd = model_cfg.resolved_head_dim
    shape = (model_cfg.n_layers, n_phys, ps, model_cfg.n_kv_heads, hd)
    cpu_params = {
        "embed": params["embed"].cpu(), "final_norm": params["final_norm"].cpu(),
        "layers": [{k: ({kk: vv.cpu() for kk, vv in v.items()}
                        if isinstance(v, dict) else v.cpu())
                    for k, v in lp.items()} for lp in params["layers"]],
    }
    gen = torch.Generator().manual_seed(3)
    prompt = torch.randint(1, model_cfg.vocab_size, (B, 40), generator=gen,
                           dtype=torch.int32)
    tables = torch.full((B, 8), n_phys - 1, dtype=torch.int32)
    tables[0, :3] = torch.tensor([5, 2, 9])
    tables[1, :3] = torch.tensor([0, 11, 7])
    rounds = []
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        cache = {n: torch.zeros(shape, dtype=torch.bfloat16, device=dev)
                 for n in ("k", "v")}
        lens = torch.zeros((B,), dtype=torch.int32, device=dev)
        tokens = torch.zeros((B, 64), dtype=torch.int32)
        tokens[:, :40] = prompt
        chunk = torch.tensor([40, 33], dtype=torch.int32)
        tokens[1, 33:] = 0
        logits1 = impl.chunked_step_paged(
            p, tokens.to(dev), cache, lens, chunk.to(dev), tables.to(dev))
        nxt = logits1.argmax(-1).to(torch.int32)
        lens = lens + chunk.to(dev)
        logits2 = impl.chunked_step_paged(
            p, nxt[:, None], cache, lens, torch.ones(B, dtype=torch.int32,
                                                     device=dev),
            tables.to(dev))
        rounds.append((logits1.float().cpu(), logits2.float().cpu(),
                       nxt.cpu()))
    (g1, g2, gn), (w1, w2, wn) = rounds
    for name, g, w in (("prefill round", g1, w1), ("decode round", g2, w2)):
        if g.shape != (B, model_cfg.vocab_size) or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: logits not finite or of shape "
                                 f"{tuple(g.shape)}")
        err = (g - w).abs()
        if not bool((err <= 0.25 + 0.05 * w.abs()).all()):
            raise AssertionError(f"{name}: card vs CPU logits max |d| "
                                 f"{err.max().item():.3e}")
        log(f"  {name}: logits max |card - cpu| {err.max().item():.3e} "
            f"(tol 0.25 + 0.05|cpu|)")
    if not torch.equal(gn, wn):
        log(f"  note: greedy first tokens differ card {gn.tolist()} vs cpu "
            f"{wn.tolist()} (bf16 near-tie)")


# -- phase 5: the serving main path --------------------------------------------
def serve_phase(torch):
    from repro_torch.engine.engine import serve
    from repro_torch.kernels.paged_decode_attention import paged_decode_attention
    from repro_torch.kernels.paged_prefill_attention import paged_prefill_attention
    from repro_torch.launch import serve as serve_cli

    args = serve_cli.build_parser().parse_args(["--full"])
    t0 = time.perf_counter()
    engine, sched, kv_pool, reqs = serve_cli.build(args)   # binds + warms up
    log(f"  engine built and warmed up in {time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine.bucket_rounds.clear()
    engine.enqueue_ms.clear()
    paged_decode_attention.launches = 0
    paged_prefill_attention.launches = 0
    res = serve(reqs, sched, engine, kv_pool=kv_pool)
    torch.cuda.synchronize()
    launches = {"paged_decode_attention": paged_decode_attention.launches,
                "paged_prefill_attention": paged_prefill_attention.launches}
    peak = torch.cuda.max_memory_allocated()

    cfg = engine.model_cfg
    bad = [r.req_id for r in reqs
           if len(res.outputs.get(r.req_id, [])) != r.max_new_tokens]
    if res.report.n_finished != len(reqs) or bad:
        raise AssertionError(f"{res.report.n_finished}/{len(reqs)} finished; "
                             f"short outputs: {bad}")
    toks = [t for r in reqs for t in res.outputs[r.req_id]]
    if not all(0 <= t < cfg.vocab_size for t in toks):
        raise AssertionError("a sampled token is outside the vocabulary")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched on the main path: "
                             f"{launches}")
    decode_rounds = engine.bucket_rounds.get(1, 0)
    mixed_rounds = sum(n for c, n in engine.bucket_rounds.items() if c > 1)
    if launches["paged_decode_attention"] != cfg.n_layers * decode_rounds:
        raise AssertionError(f"decode launches {launches} != {cfg.n_layers} x "
                             f"{decode_rounds} pure-decode rounds")
    if launches["paged_prefill_attention"] != cfg.n_layers * mixed_rounds:
        raise AssertionError(f"prefill launches {launches} != {cfg.n_layers} "
                             f"x {mixed_rounds} rounds with C > 1")
    rep = res.report
    out_tok_s = len(toks) / res.wall_s
    bubble = statistics.mean(res.host_bubble_ms) if res.host_bubble_ms else 0.0
    enqueue = statistics.mean(engine.enqueue_ms)
    log(f"  served {rep.n_finished}/{rep.n_total} requests, {len(toks)} output "
        f"tokens in {res.wall_s:.3f} s over {res.rounds} rounds "
        f"(by chunk bucket: {dict(sorted(engine.bucket_rounds.items()))})")
    log(f"  output tok/s {out_tok_s:.1f}  mean TTFT {rep.ttft['mean'] * 1e3:.2f} ms"
        f"  P99 E2E {rep.e2e['p99'] * 1e3:.2f} ms  mean bubble_ms {bubble:.3f}"
        f"  mean enqueue_ms {enqueue:.3f}"
        f"  peak memory {peak / 2**30:.3f} GiB")
    log(f"  kernel launches on the main path: {launches}")
    return engine, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    log("== device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
        f"count {torch.cuda.device_count()}")

    log("== build")
    from repro_torch.kernels import native
    build_s = native.build_all()
    log(f"  built {len(native.build_logs)} of {len(native.KERNELS)} kernel "
        f"libraries in {build_s:.2f} s")
    for name, text in native.build_logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "error", "warning")):
                log(f"  [{name}] {line.strip()}")

    log("== kernels vs plain versions")
    kern = kernel_phase(torch)
    torch.cuda.empty_cache()

    log("== serve (python -m repro_torch.launch.serve --full)")
    engine, launches = serve_phase(torch)

    log("== full-width model: kernels on the card vs plain on the CPU")
    reference_phase(torch, engine.model_cfg, engine.params)

    sources = {
        "paged_decode_attention": ("src/repro/kernels/paged_decode_attention.py:249"),
        "paged_prefill_attention": ("src/repro/kernels/paged_prefill_attention.py:213"),
    }
    kernels = []
    for name, rep in kern.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": sources[name],
            "launches": launches[name],
            **{k: rep[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms")},
        })
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
