#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each of which raises (exit code != 0) on failure:

1. device: the card's name and power limit (``nvidia-smi``).
2. build: compile every CUDA kernel from ``csrc/`` (thirteen libraries, one
   ``nvcc`` per source, in parallel) and print ptxas's report of each:
   every kernel's (mangled) name, registers, spills and static shared
   memory, the tensor-core kernels (``*_wgmma_kernel``,
   ``swiglu_wg::gemm_kernel``) among them.
3. kernels: each attention kernel against its plain PyTorch version on the card, at
   the main path's shapes (full-width qwen1.5-0.5b: B=16, Hq=Hkv=16, hd=64,
   page 16, ragged kv_lens up to 512 through permuted block tables, every
   chunk bucket) and one GQA shape (32/8 heads, as llama3.2-1b) at head
   dims 64 and 128, and the decode kernel also at groups 12 (96/8 heads,
   as mistral-large-123b) and 48 (48/1, as granite-34b), hd 128, and at B=4
   over up to 2,048 keys (GQA 32/8 and group 48: several splits merged);
   both kernels also at group 7 (56/8, as arctic-480b), hd 128, bf16 and
   f32 (the decode kernel over 2,048 keys too); on rows with a valid key, |d| <= 1e-5 + 2**-7 |plain| (one bf16
   rounding step, and never over 2e-2) in bf16 and <= 1e-5 in f32; a row
   with no valid key stores 0; at every decode case a NaN key (K and V) in the first
   split of one sequence reaches that sequence's output and changes no
   other.  In bf16 the prefill kernels run both products on the tensor
   cores (wgmma, P split into two bf16 halves), in f32 on CUDA cores; the
   decode kernels run the split-K body (keys split over CTAs, merged in the
   same launch), bf16 on mma.sync (P split likewise), f32 on CUDA
   cores.  Times the kernel, the plain version and
   ``scaled_dot_product_attention`` over the gathered dense K/V
   (``library_ms``, a yardstick the port never calls) with CUDA events, L2
   flushed before each launch; the decode kernel and SDPA also on the
   device alone (the card spins while the host enqueues the call), and the
   decode wrapper's host time per call; computes the least time the card
   could take (``bound_ms``).
4. swap kernels: the four KV swap kernels against their plain versions on
   the serve pool ``(24, 2049, 16, 16, 64)`` in bf16 and f32, id buckets 8
   and 32 of permuted ids padded with the sink page (one all-zero page and
   one all-zero head among them): gather, scatter, INT8 codes, scales and
   dequantized pages BITWISE equal, every page outside the ids and the
   sink unchanged; a full-width round trip (gather, copy to pinned host
   memory and back, scatter into other pages) returns the same bytes in
   bf16 and, through the INT8 pair, stays within half a quantization step
   (plus one bf16 rounding) per element.  Times each kernel, its plain
   version and ``index_select`` / ``index_copy_`` (``library_ms``; none
   for the INT8 pair), each kernel and library call also on the device
   alone, each wrapper's host time per call, and the host copies of one
   staged tensor; the bound counts each distinct page once (the real ones
   and one sink).  Then four small f32 pools at the edges of the
   redesigned kernels (512 KiB pages; a head of 128 KiB; 300 heads; 36-code
   pages, off a 16-byte boundary; 260 heads of 128 KiB, the INT8 gather's
   two-pass kernel over two blocks of heads) with
   ids holding a run of equal real ids and a tail of sink ids: the same
   bitwise checks, the repeated page left out of the comparison with the
   plain scatters as the sink is, and both scatters' repeated pages
   holding the last staged row of their run (the INT8 scatter its
   dequantization; its staged rows are fresh values quantized, so that
   the rows of a run differ).
5. serve: what ``python -m repro_torch.launch.serve --full`` runs -- 32
   ShareGPT-like requests through the pipelined engine with paged KV --
   with the kernels' launch counters zeroed after warm-up; every request
   must finish with its full token count and both kernels must have run
   (decode 24 times per pure-decode round).  The serve records its spans
   (``repro_torch.tracing``) and prints their summary: device ms per
   round by bucket, from CUDA events read at drain, among it.
6. serve, swap: the same with ``--preemption-mode swap --kv-blocks 48
   --interval 0`` (every request arrives at once, so the pressure bites
   however fast the rounds run): swap preemptions happen and are all restored, the gather runs twice
   (K and V) per swap-out and the scatter twice per restore, nothing stays
   staged and the pool's invariants hold.
7. serve, INT8 host tier: the same through ``host_kv_dtype="int8"``: the
   INT8 pair runs as the fp pair did, and the fp pair not at all.
8. serve, disagg: ``--disagg`` (1 prefill + 1 decode replica sharing one
   weight set): every request hands off exactly once, the decode pool
   prefills 0 tokens, the router's invariants hold, and the swap pair runs
   twice per export and per import.  Greedy tokens of phases 6-8 are
   compared with phase 5's and printed, not gated (bf16 GEMMs of other
   batch shapes may round differently).
9. reference: one prefill round and one decode round of the full-width model
   through the kernels on the card against the same rounds on the CPU
   through the plain versions (same bf16 weights; bf16 tolerance).
10. fused kernels: the two fused-layout attention kernels against their
   plain versions at phase 3's shapes (groups 7, 12 and 48 too) and
   tolerances, on ``fuse_pages(k, v)`` of phase 3's kind of inputs, with
   phase 3's NaN check; each must also equal the split kernel on ``(k, v)``
   BITWISE.  Timed like phase 3, and against the split kernel on the same
   inputs in turns (fused, split, split, fused).
11. fused swap kernels: phase 4's bitwise cases on the fused serve pool
   ``(24, 2049, 16, 32, 64)``, bucket 32, bf16, timed as phase 4 times
   them (64 KiB pages).
12. serve, fused: ``--full --kv-layout fused`` (static budget, recompute):
   every request finishes, the fused prefill kernel runs 24 times per round
   with C > 1 and the fused decode kernel 24 times per pure-decode round,
   the split attention kernels never.  Then ``--preemption-mode swap
   --kv-blocks 48 --interval 0`` on the fused pool: swap-outs happen, all are restored,
   one gather per swap-out and one scatter per restore (the fused payload
   is one tensor).  Greedy tokens against phase 5's are printed, not gated.
13. LPRS: ``profile_engine`` + ``train_predictor`` (what ``--lprs`` runs) on
   the fused full-width engine; prints the profile's round-latency
   percentiles, the predictor's ``evaluate()`` on it and ``predict()``'s
   time per call on the CPU and on the card; then serves aging + LPRS + APC
   (``--lprs --apc --target-ms`` p60 of the profile) on the same engine:
   every request finishes and the predictor was called.  The number of
   LPRS chunk searches, the mean and p99 chunk sizes and the share of
   rounds over the target are printed against phase 12's static run, not
   gated.
14. dense kernels: ``chunked_prefill_attention`` on the dense serve cache
   ``(16, 513, 16, 64)`` as the engine passes it (the ``[:, :-1]`` view,
   not contiguous), ragged kv_lens <= 512, every bucket Sq in {1, 16, 32,
   64, 128, 256}, and GQA 32/8 at hd 64 and 128; ``decode_attention`` at
   B=16, S=512, 16/16, hd 64, GQA, groups 12 (96/8) and 48 (48/1) at hd
   128, B=4, S=2,048 (32/8 and 48/1: several splits merged), and B=4,
   S=32,768, 32/8, hd 128 (qwen3-8b's attention widths); both kernels
   also at group 7 (56/8, arctic-480b), hd 128, bf16 and f32.  Phase 3's
   tolerances against the plain versions; on the sink views each output
   BITWISE equal to the paged kernel's on the same keys laid into
   pages (each pair shares one body: the prefill one tensor-core body and
   one shared-memory layout, the decode one split-K body whose split
   points depend only on the key index); a NaN key reaches its row's
   output and no other (every decode case).  Timed like phase 3
   (``library_ms``: SDPA over the same cache with the same mask).  Then
   the same NaN check through the four paged kernels.
15. fused SwiGLU: ``fused_swiglu`` on full-width qwen1.5-0.5b's layer-0
   FFN weights (D=1024, F=2816) at M in {16, 256, 2048}, bf16 and f32, and
   at qwen3-8b's widths (D=4096, F=12,288, seeded) at M=256 in bf16 (two
   wgmma GEMMs, the bf16 hidden activations between them; f32 on CUDA
   cores): f32
   within 1e-4 of ``fused_swiglu_plain``; bf16: the kernel's hidden values
   (read back through a selecting down projection) each within one bf16
   step of the float64 hidden, its output within one output rounding step
   of the plain down product of those values and of ``fused_swiglu_plain``
   plus the move of the hidden values that differ, and within 5 x 2e-2 of
   ``fused_swiglu_ref``; hidden-rounding counts printed.  Timed against the
   plain version and ``library_ms`` (``torch.matmul`` and ``F.silu``, a
   yardstick).
16. standalone kernels: ``decode_attention`` and ``fused_swiglu`` (no serve
   path calls them, as in the reference) launch exactly their kernels and
   give the same bits twice; their counts are the JSON's.
17. serve, dense: ``--full --dense-kv``: every request finishes,
   ``chunked_prefill_attention`` runs exactly 24 times per round at every
   bucket (C = 1 included) and no other kernel runs.
18. serve, dense swap: ``--full --dense-kv --preemption-mode swap
   --kv-blocks 48 --interval 0``: swap-outs happen and are all restored by slot-row
   copies (no swap kernel), nothing stays staged, the pool's invariants
   hold.  Greedy tokens of 17-18 against phase 5's are printed, not gated.
19. NaN guard: ``--full --nan-guard`` on the split, fused and dense engines
   under ``serve(robustness=...)`` with a ``nan_logits`` fault at the
   second decode: exactly the victim is shed (``numerics``), every other
   request finishes, nothing stays poisoned and every KV cache value is
   finite at the end.
20. serve at granite-34b's published widths (d_model 6144, 48 query heads
   over 1 KV head: decode group 48, hd 128) with ``n_layers`` cut to 2
   (printed as reduced): the split layout, greedy, 8 requests through
   ``TorchEngine``; every request finishes, the decode kernel runs twice
   per pure-decode round and the prefill kernel twice per round with C > 1.
21. the compiled round: every phase above serves through CUDA graphs, one
   per chunk bucket, captured at warm-up and replayed each round (the
   launch counts include the replayed launches).  Here, on the split,
   fused and dense engines at full width (bf16, 1,024 tokens of context),
   a replay of each bucket's graph against the eager step of a second
   engine from the same seed, on one state and the same inputs, at every
   bucket and at C = 1 once more with three decode splits merged: the
   sampled ids, ``lens``, ``last_token`` and every cache tensor BITWISE
   equal; each graph engine holds one graph per bucket (printed with the
   warm-up and capture seconds and the graph pool's bytes).  At
   temperature 1.0, 8 replays of one idle round draw 8 different rows of
   ids.  Then phase 5's serve in 3 interleaved pairs (graph, eager, eager,
   graph, ...) on the split engine and one pair each on fused and dense:
   output tok/s, mean TTFT, P99 E2E, mean ``bubble_ms`` and the mean
   ``engine.replay`` span (``repro_torch.tracing``: the host ms to launch
   the replay or the eager step), the host ms per round in
   ``schedule()``, in the input copies and in ``dispatch``, and each
   round's span on the device (CUDA events around ``dispatch``), each
   with its range; greedy tokens of graph against eager printed, not
   gated.  Last, a split graph engine
   built, warmed up, serving phase 5's workload and dropped with ``del``
   while Python's cyclic collector is off must return
   ``torch.cuda.memory_allocated()`` to within 64 MiB of its level before
   the build (nothing of it held in a reference cycle).
22. the MoE and VLM families: arctic-480b's published widths (d_model
   7168, 56/8 heads: group 7, hd 128, 128 experts top-2 of d_ff 4864 plus
   a dense residual FFN, capacity factor 1.25, the scatter dispatch, vocab
   32,000) with ``n_layers`` cut to 2 (printed as reduced; 55.4 GB of
   seeded bf16 weights), served through the graphs as phase 20 serves
   (every request finishes; decode and prefill launches ``n_layers`` per
   round of their kind), each bucket's device ms per round printed
   against its bound (every layer's weights, every expert included, read
   once); the same requests on an eager engine sharing the weights,
   printing the real tokens' expert choices dropped at capacity and the
   experts they reach per bucket (with the bound of the weights that
   data needs); the replays BITWISE equal to that eager engine's step at
   every bucket (phase 21's check); then ``moe_round`` (the engine
   round's MoE) in both impls' capacity orders on layer 0's experts at T =
   16 (capacity 1) and T = 2,048 (capacity 40) against a per-token
   reference (host top-k and each impl's capacity walk): the output
   BITWISE equal to the combine of the grouped kernels' rows on the
   reference's kept pairs, each of those rows within one bf16 step plus
   the hidden move of the per-token SwiGLU.  Then
   llava-next-mistral-7b's text backbone at full width and depth (32
   layers, 14.5 GB), served and gated the same way.  Each engine is freed
   before the next; the phase's seconds are printed.
23. the whole-prompt entry points of ``TransformerLM`` (no kernel of their
   own: their attention is plain PyTorch, as it is ``jnp`` in the JAX
   package) on seeded bf16 weights.  qwen1.5-0.5b at full width and
   depth: ``Model.prefill`` of 4 prompts of 512 tokens against the same
   prompts through ``chunked_step_paged`` in 4 chunks of 128 (the paged
   prefill kernel, 24 launches a chunk), then 8 ``decode`` steps on the
   prefill cache padded to 520 rows against 8 C = 1 rounds (the paged
   decode kernel); the last-position logits within the reference's bf16
   bar (atol 0.25, rtol 0.05) and the greedy ids equal wherever the top-2
   margin exceeds it; ``train_hidden`` under flash against
   ``ATTN_IMPL = "naive"`` at B = 1, S = 8,192 within the same bar.
   mixtral-8x7b's widths (d_model 4096, 32/8 heads, hd 128, 8 experts
   top-2, window 4,096) at 2 of 32 layers, capacity factor 8.0 so that no
   expert choice drops: a prefill of 4,352 tokens gives a 4,096-slot ring
   holding positions 256-4,351 at pos % 4,096; 8 decode steps, each
   against a whole prefill of the extended prompt under the same bar.
   Then ``examples/torch_quickstart.py`` (llama3.2-1b at full width) and
   ``examples/torch_serve_lprs_apc.py`` (qwen1.5-0.5b) as processes of
   their own: each must exit 0, every request finished.  Prints the
   prefill ms for 4 x 512 tokens, decode ms a step, flash and naive ms at
   8,192, peak memory, each beside the card's name and power limit.
24. training (no kernel of its own: the loss, AdamW and the train step
   are plain ``jnp`` in the JAX package).  ``repro_torch.launch.train.
   train`` at llama3.2-1b's full width (16 layers, d_model 2048, vocab
   128,256, tied embeddings; seeded bf16 weights, f32 grads and moments),
   B = 8, S = 128, 8 steps, a checkpoint every 4 steps under the temporary
   directory: every loss finite and the last below the first; the median
   ms a step over steps 2-8, tokens/s and peak memory printed.  Then the
   step-8 checkpoint is deleted and a run with ``resume=True`` under the
   same steps must restore the params, moments and step BITWISE as the
   step-4 save held them, and reach the first run's losses at steps 4-7
   within the reference's rtol 2e-2 (printed: whether bitwise; the phase
   does not set ``torch.use_deterministic_algorithms``).  ``loss_and_grad``
   at 4 microbatches against 1 on one full-width batch: every leaf's max
   |g4 - g1| / max |g1| < 0.05 (tests/test_training.py's bar).  Tiny
   qwen1.5-0.5b in f32, 3 steps on the card and on the CPU from the same
   weights: losses within 1e-4 relative (TF32 off).
   ``examples/torch_train_tiny.py`` as a process must exit 0.  No kernel
   may launch.
25. the hybrid, xLSTM and Whisper families (no kernel of their own) on
   seeded bf16 weights: xlstm-1.3b at full width and depth (B = 2, S =
   512), whisper-large-v3 at full width and depth (B = 2, 64 tokens, 1,500
   seeded frames) and jamba-1.5-large-398b's widths cut to one group of 8
   layers and 4 of its 16 experts (capacity factor 2.0: no choice drops),
   B = 1, S = 512; printed as reduced.  ``Model.prefill``, then 8
   ``decode`` steps (K/V caches padded by 8 rows), each against the last
   logits of a whole ``Model.prefill`` of the extended prompt within the
   bf16 bar, greedy ids equal where the top-2 margin is clear (whisper,
   jamba).  xLSTM's stack amplifies rounding, so its whole-model
   difference is printed beside two valid prefills' (mLSTM chunks of 256
   and 128), and every one of its 48 blocks is gated instead: fed the same
   input both ways, 8 one-token steps from the state of a 512-token run
   within the bf16 bar of the block over 520 tokens.  One ``loss`` and its
   backward for xLSTM and whisper: finite, grad norm > 0.  Prefill ms,
   decode ms a step, loss + backward ms and peak memory printed beside the
   card's line; each model is freed before the next.  No kernel may
   launch.
26. the dry-run (``python -m repro_torch.launch.dryrun``; no kernel: a
   meta-device pass, the counterpart of the reference's lowering for 512
   devices).  (a) ``main(["--both", "--chunked-serve", "--quiet"])``: all
   33 (arch x shape) cells on the single-pod 16x16 and multi-pod 2x16x16
   virtual meshes plus the dense chunked-serve rounds, each row and its
   wall seconds printed; every cell ok, the meta trees' element counts
   equal repro's; its seconds printed against a 120 s target (a miss is
   printed, not hidden).  (b) llama3.2-1b's train step at full width, B =
   8, S = 128, counted by ``op_cost.OpCounter`` on meta and on the card:
   the same flops, bytes within 1%, every op counted differently printed;
   then the step timed with CUDA events must take at least 0.95 x its
   one-chip bound (the larger of its flops at 989 TFLOP/s and its bytes at
   3.35 TB/s), since a step under its bound means a wrong count.  One
   dense serve bucket of qwen1.5-0.5b (16 slots x C = 128, max_context
   512): the plain ``chunked_step`` counted on meta, its bound printed
   beside the round timed on the card (not gated).  (c) ``quantize_int8``
   / ``dequantize_int8`` on the card under tests/test_distributed.py's bars
   and ``compressed_psum`` over an NCCL group of one (a ``FileStore`` in a
   temporary directory, destroyed after): within 2e-2, residual <= 2e-2.
   (d) every arch's params and train state (params plus both moments in
   ``default_train_config``'s moment dtype) per device on both meshes
   under its own fsdp setting; every shard shape divides its dimension.
   No kernel may launch in (a).
27. the grouped expert kernels (``kernels.grouped_swiglu``) at
   ``arctic-1l.chat``'s shapes: one layer of arctic-480b, its 128 experts
   (26.8 GB) dropless at capacity factor 64, the dense residual d_model
   wide.  At t = 16, 256 and 2,048 lanes with the cell's real lanes (12,
   25, 128): the layout's counts against the host's; each kernel at row
   tiles 16 and 64 against its plain version (one bf16 step, or 2**-16 of
   the row's largest |value|; the down kernel fed the gate/up kernel's
   hidden values); each kernel's device time beside its bound (the touched
   experts' weights and the rows, or 6 D F operations a row), the batched
   GEMMs over the dropless (E, t, D) buffer and the whole layer both ways.
   ``moe_round`` replayed from a CUDA graph BITWISE equal to the eager call
   at every bucket, dropless and at capacity factor 1.25, the device
   counter moved alike.  The cell's engine served through its graphs
   (both kernels launch once per layer a round; ``L.expert_ffn`` is never
   called, warm-up included), a traced serve's span summary (experts read
   and rows per round by bucket), the replays BITWISE equal to an eager
   engine's step at every bucket.  Run between phases 22 and 23.
28. the windowed attention kernels and ``k-exaone-8l``'s layers, run
   after phase 27.  The paged decode and prefill kernels with a window of
   128 at the cell's heads (64 over 8, hd 128), split and fused, bf16 and
   f32, over up to 512 and 2,048 keys, against the windowed plain versions
   under phase 3's tolerances (fused bitwise equal to split); a NaN key
   inside a decode row's window reaches it, one below every window of a
   row changes no output.  Then the cell's form as its model module builds
   it (8 layers LLLG LLLG, every width as published) with 8 experts held,
   served through the graphs as phase 20 serves: 6 windowed and 2 causal
   launches a round by the counters (zeroed just before the serve) and by
   the kernels' names in ``torch.profiler``'s trace.
The second-to-last line is a JSON object listing every kernel with its
numbers; the last line is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --turns OTHER_CHECKOUT [FILTER]

times the kernels of phases 3 and 10 (paged decode at groups 1, 12 and 48,
and paged prefill at every bucket, split and fused), 14 (chunked prefill at
every bucket; dense decode at the serve shape, groups 12 and 48 and the 32k
cache), 15 (bf16 SwiGLU at every shape) and 4 and 11 (the four swap
kernels at phase 4's timed case on the split and the fused pool, with each
wrapper's host time per call) of another checkout (say the
parent commit, unpacked with ``git archive``) and of this one in turns,
other / this / this / other, each in a process of its own, through the
other checkout's own ``chip_smoke.py`` functions; the decode and swap
kernels both as phases 3 and 4 time them and on the device alone.  Each
case draws its inputs
from a seed of its own; a case a checkout refuses (a decode group it does
not take) is skipped on its side; FILTER keeps the cases whose name holds
it.  Then prints, per kernel and shape, both sides' times and this / other.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12        # f32 outside the tensor cores
# kernel and plain version both accumulate in f32 and round the output once,
# so in bf16 they may differ by one rounding step: one bf16 ulp is at most
# 2**-7 |x|.  Never more than 2e-2 absolute.
TOL_F32 = (1e-5, 0.0)          # (atol, rtol)
TOL_BF16 = (1e-5, 2.0 ** -7)
TOL_BF16_CAP = 2e-2
ITERS = 20
HOST_AHEAD_CYCLES = 500_000    # a spin of ~0.25 ms before a device timing


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
    L2 flush (a real serving round finds this layer's pages cold).  The clock
    runs from the end of the flush to the end of the call, so it holds
    whatever of the call's host time outlasts the flush: what a caller sees
    on an idle card.  ``device`` first lets the card spin for
    HOST_AHEAD_CYCLES, so that the host has enqueued the whole call before
    the clock starts: the device time alone."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        return self._median(fn, host_ahead=False)

    def device(self, fn) -> float:
        return self._median(fn, host_ahead=True)

    def graph(self, fn):
        """(fn()'s result from a CUDA graph replay, the replay's median ms):
        ``fn`` captured once, as an engine round captures its layers, so
        that no host enqueue time is counted."""
        torch = self.torch
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn()                                # settle the stream first
        torch.cuda.current_stream().wait_stream(stream)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=stream):
            out = fn()
        ms = self._median(g.replay, host_ahead=False)
        del g
        return out, ms

    def _median(self, fn, host_ahead) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(ITERS):
            self.flush.zero_()
            if host_ahead:
                torch.cuda._sleep(HOST_AHEAD_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def host_us(torch, fn, n=50) -> float:
    """Mean host time of one call (µs), ``n`` calls enqueued back to back:
    the wrapper's checks, allocations and launch, while the card runs
    behind."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def bound_ms(n_bytes: float, n_flops: float,
             flops_per_s: float = BF16_FLOPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / flops_per_s * 1e3
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
def time_kernel(timer, kernel, split, fused):
    """(ms, turns): the kernel's time; for a fused kernel, timed against the
    split kernel on the same inputs in turns -- fused, split, split, fused,
    since the card's clocks drift between timings -- and ms is the mean of
    its two turns."""
    if not fused:
        return timer(kernel), None
    turns = (timer(kernel), timer(split), timer(split), timer(kernel))
    return (turns[0] + turns[3]) / 2, turns

def decode_case(torch, timer, gen, *, B, Hq, Hkv, hd, ps, max_pages, n_pages,
                dtype, timed, fused=False, window=0):
    """The decode kernel against its plain version; ``fused``: the fused
    kernel on ``fuse_pages(k, v)``, which must also equal the split kernel
    on ``(k, v)`` bitwise.  ``window`` (untimed): the windowed
    instantiation against the windowed plain version, the NaN key inside
    the window, and a NaN key below it (``below_window_check``)."""
    import functools

    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention, paged_decode_attention_fused,
        paged_decode_attention_fused_plain, paged_decode_attention_plain)
    import torch.nn.functional as F

    assert not (timed and window), "the timed yardsticks are causal"
    split, split_plain, fused_kernel, fused_plain = (
        functools.partial(fn, window=window) for fn in (
            paged_decode_attention, paged_decode_attention_plain,
            paged_decode_attention_fused, paged_decode_attention_fused_plain))

    dev = "cuda"
    k, v, tables = paged_inputs(gen, B=B, Hq=Hq, Hkv=Hkv, hd=hd, ps=ps,
                                max_pages=max_pages, n_pages=n_pages,
                                dtype=dtype, dev=dev)
    q = torch.randn((B, Hq, hd), generator=gen, device=dev).to(dtype)
    max_ctx = (max_pages - 1) * ps
    kv_lens = torch.randint(1, max_ctx + 1, (B,), generator=gen,
                            device=dev).to(torch.int32)
    kv_lens[0], kv_lens[1] = 0, max_ctx
    split_args = (q, k, v, tables, kv_lens)
    if fused:
        args = (q, ref.fuse_pages(k, v), tables, kv_lens)
        kernel, plain = fused_kernel, fused_plain
    else:
        args, kernel, plain = split_args, split, split_plain
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    live = kv_lens > 0
    if not bool((got[~live] == 0).all()):
        raise AssertionError("decode kernel: a row with no valid key is not 0")
    err = max_err(got, want, live)
    if fused:
        require(same_bits(got, split(*split_args)),
                "fused decode kernel differs from the split kernel")
    # a NaN key in the first split of the longest sequence (row 1), within
    # its window where it has one
    pos = max_ctx - min(window, 100) if window else min(100, max_ctx - 1)
    page = (int(tables[1, pos // ps]), pos % ps)
    key_args = (1,) if fused else (1, 2)
    poison_check(torch, kernel, args, key_args, 1, page)
    if window:
        below_window_check(torch, kernel, args, key_args,
                           (int(tables[1, 0]), 0))
    if not timed:
        return {"max_abs_err": err}
    # library yardstick: SDPA over the gathered dense K/V
    kd = ref.gather_pages(k, tables).transpose(1, 2)           # (B, Hkv, S, hd)
    vd = ref.gather_pages(v, tables).transpose(1, 2)
    S = kd.shape[2]
    mask = (torch.arange(S, device=dev)[None, :] < kv_lens[:, None].long())
    mask = mask[:, None, None, :]
    q4 = q[:, :, None, :]
    ms, turns = time_kernel(timer, lambda: kernel(*args),
                            lambda: split(*split_args), fused)
    plain_ms = timer(lambda: plain(*args))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, kd, vd, attn_mask=mask, enable_gqa=Hq != Hkv)
    lib_ms = timer(sdpa)
    device = {"device_ms": timer.device(lambda: kernel(*args)),
              "library_device_ms": timer.device(sdpa),
              "host_us": host_us(torch, lambda: kernel(*args))}
    keys = int(kv_lens.sum())
    esz = q.element_size()
    n_pages_live = int(((kv_lens + ps - 1) // ps).sum())
    n_bytes = (2 * q.numel() * esz + 2 * keys * Hkv * hd * esz
               + 4 * (B + n_pages_live))
    n_flops = 4 * keys * Hq * hd
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "turns": turns, **device,
            "shape": f"B={B} Hq={Hq} Hkv={Hkv} hd={hd} ps={ps} "
                     f"kv_lens<={max_ctx} (sum {keys})"}


def prefill_case(torch, timer, gen, *, B, Sq, Hq, Hkv, hd, ps, max_pages,
                 n_pages, dtype, timed, fused=False, window=0):
    """The prefill kernel against its plain version; ``fused``: the fused
    kernel on ``fuse_pages(k, v)``, which must also equal the split kernel
    on ``(k, v)`` bitwise.  ``window`` (untimed): the windowed
    instantiation against the windowed plain version, and a NaN key below
    every window of row 2 (``below_window_check``)."""
    import functools

    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_prefill_attention import (
        paged_prefill_attention, paged_prefill_attention_fused,
        paged_prefill_attention_fused_plain, paged_prefill_attention_plain)
    import torch.nn.functional as F

    assert not (timed and window), "the timed yardsticks are causal"
    split, split_plain, fused_kernel, fused_plain = (
        functools.partial(fn, window=window) for fn in (
            paged_prefill_attention, paged_prefill_attention_plain,
            paged_prefill_attention_fused, paged_prefill_attention_fused_plain))

    dev = "cuda"
    k, v, tables = paged_inputs(gen, B=B, Hq=Hq, Hkv=Hkv, hd=hd, ps=ps,
                                max_pages=max_pages, n_pages=n_pages,
                                dtype=dtype, dev=dev)
    q = torch.randn((B, Sq, Hq, hd), generator=gen, device=dev).to(dtype)
    max_ctx = (max_pages - 1) * ps
    q_offset, kv_lens = chunk_lens_for(gen, B, Sq, max_ctx, dev)
    split_args = (q, k, v, tables, kv_lens, q_offset)
    if fused:
        args = (q, ref.fuse_pages(k, v), tables, kv_lens, q_offset)
        kernel, plain = fused_kernel, fused_plain
    else:
        args, kernel, plain = split_args, split, split_plain
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    live = kv_lens > 0            # each row sees its own key at least
    if not bool((got[~live] == 0).all()):
        raise AssertionError("prefill kernel: a row with no valid key is not 0")
    err = max_err(got, want, live)
    if fused:
        require(same_bits(got, split(*split_args)),
                "fused prefill kernel differs from the split kernel")
    if window:
        # row 2's chunk starts at max_ctx - Sq, so key 0 lies below every
        # one of its rows' windows while max_ctx - Sq >= window
        require(max_ctx - Sq >= window, "key 0 of row 2 is in a window")
        below_window_check(torch, kernel, args, (1,) if fused else (1, 2),
                           (int(tables[2, 0]), 0))
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
    ms, turns = time_kernel(timer, lambda: kernel(*args),
                            lambda: split(*split_args), fused)
    plain_ms = timer(lambda: plain(*args))
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
            "turns": turns,
            "shape": f"B={B} Sq={Sq} Hq={Hq} Hkv={Hkv} hd={hd} ps={ps} "
                     f"kv_lens<={max_ctx}"}


def split_note(r) -> str:
    if r["turns"] is None:
        return ""
    return ("; on the same inputs in turns, fused / split / split / fused "
            + " / ".join(f"{t:.4f}" for t in r["turns"]) + " ms")


def device_note(r) -> str:
    """The device-only times and the host time per call of a decode case."""
    return (f"; device only: kernel {r['device_ms']:.4f} ms, sdpa "
            f"{r['library_device_ms']:.4f} ms; kernel host time "
            f"{r['host_us']:.1f} us per call")


def kernel_phase(torch, fused=False):
    """Phase 3 (split kernels) or, with ``fused``, phase 10 (fused kernels):
    the same shapes, tolerances and timings."""
    gen = torch.Generator(device="cuda").manual_seed(10 if fused else 0)
    timer = Timer(torch)
    # main path: full-width qwen1.5-0.5b at serve defaults -- n_slots 16,
    # max_context 512 (33 pages per table), the serve pool of 2049 pages
    qwen = dict(B=16, Hq=16, Hkv=16, hd=64, ps=16, max_pages=33, n_pages=2049)
    gqa = dict(qwen, Hq=32, Hkv=8)                  # llama3.2-1b heads
    gqa128 = dict(gqa, hd=128)                      # the other head dim built
    group12 = dict(qwen, Hq=96, Hkv=8, hd=128)      # mistral-large-123b heads
    group48 = dict(qwen, Hq=48, Hkv=1, hd=128)      # granite-34b heads (MQA)
    group7 = dict(qwen, Hq=56, Hkv=8, hd=128)       # arctic-480b heads
    # up to 2,048 keys: up to four decode splits merged in one launch
    merge = dict(gqa128, B=4, max_pages=129)
    merge48 = dict(group48, B=4, max_pages=129)
    merge7 = dict(group7, B=4, max_pages=129)
    bf16, f32 = torch.bfloat16, torch.float32
    layout = "fused" if fused else "split"
    results = {}
    dec = decode_case(torch, timer, gen, dtype=bf16, timed=True, fused=fused,
                      **qwen)
    log(f"  decode  {layout} qwen bf16 {dec['shape']}: err "
        f"{dec['max_abs_err']:.3e} kernel {dec['ms']:.4f} ms plain "
        f"{dec['plain_ms']:.4f} ms sdpa {dec['library_ms']:.4f} ms bound "
        f"{dec['bound_ms']:.4f} ms ({dec['bound_by']})" + split_note(dec)
        + device_note(dec))
    results["paged_decode_attention" + ("_fused" if fused else "")] = dec
    worst = dec["max_abs_err"]
    for dtype, shape, name in ((bf16, gqa, "gqa bf16"),
                               (bf16, gqa128, "gqa hd=128 bf16"),
                               (f32, qwen, "qwen f32"),
                               (f32, group12, "group 12 f32"),
                               (f32, group48, "group 48 f32"),
                               (bf16, group7, "group 7 bf16"),
                               (f32, group7, "group 7 f32"),
                               (bf16, merge, "gqa hd=128 2048 keys bf16"),
                               (f32, merge, "gqa hd=128 2048 keys f32"),
                               (bf16, merge48, "group 48 2048 keys bf16"),
                               (bf16, merge7, "group 7 2048 keys bf16")):
        r = decode_case(torch, timer, gen, dtype=dtype, timed=False,
                        fused=fused, **shape)
        worst = max(worst, r["max_abs_err"])
        log(f"  decode  {layout} {name}: err {r['max_abs_err']:.3e}")
    for shape, name in ((group12, "group 12 bf16"),
                        (group48, "group 48 bf16")):
        r = decode_case(torch, timer, gen, dtype=bf16, timed=True,
                        fused=fused, **shape)
        worst = max(worst, r["max_abs_err"])
        log(f"  decode  {layout} {name} {r['shape']}: err "
            f"{r['max_abs_err']:.3e} kernel {r['ms']:.4f} ms plain "
            f"{r['plain_ms']:.4f} ms sdpa {r['library_ms']:.4f} ms bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})" + split_note(r)
            + device_note(r))
    log("  every decode output: a NaN key reaches its sequence's output and "
        "no other")
    dec["max_abs_err"] = worst
    buckets = {}
    for Sq in (16, 32, 64, 128, 256):
        r = prefill_case(torch, timer, gen, Sq=Sq, dtype=bf16, timed=True,
                         fused=fused, **qwen)
        buckets[Sq] = r
        log(f"  prefill {layout} qwen bf16 {r['shape']}: err "
            f"{r['max_abs_err']:.3e} kernel {r['ms']:.4f} ms plain "
            f"{r['plain_ms']:.4f} ms sdpa {r['library_ms']:.4f} ms bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})" + split_note(r))
    for dtype, shape, Sq, name in ((bf16, gqa, 64, "gqa bf16 Sq=64"),
                                   (bf16, gqa128, 64, "gqa hd=128 bf16 Sq=64"),
                                   (f32, qwen, 128, "qwen f32 Sq=128"),
                                   (bf16, group7, 16, "group 7 bf16 Sq=16"),
                                   (bf16, group7, 128, "group 7 bf16 Sq=128"),
                                   (f32, group7, 64, "group 7 f32 Sq=64")):
        r = prefill_case(torch, timer, gen, Sq=Sq, dtype=dtype, timed=False,
                         fused=fused, **shape)
        log(f"  prefill {layout} {name}: err {r['max_abs_err']:.3e}")
    if fused:
        log("  every fused output bitwise equal to the split kernel's on "
            "the un-fused pools")
    # the kernels line reports Sq=128 (the token budget) and the worst error
    # over every bucket
    pre = dict(buckets[128])
    pre["max_abs_err"] = max(b["max_abs_err"] for b in buckets.values())
    results["paged_prefill_attention" + ("_fused" if fused else "")] = pre
    return results


# -- phase 4: the KV swap kernels vs their plain versions -----------------------
SWAP_POOL = (24, 2049, 16, 16, 64)   # (L, n_phys, ps, Hkv, hd): the serve pool
# (bucket, real pages): a short victim, and the serve workload's longest
# (256 prompt + 48 output tokens = 19 pages, bucket 32)
SWAP_BUCKETS = ((8, 5), (32, 19))
SWAP_KERNELS = ("swap_gather_pages", "swap_scatter_pages",
                "swap_gather_pages_q8", "swap_scatter_pages_q8")


def same_bits(a, b) -> bool:
    """Bitwise equality of two tensors (floats compared as their bits)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        iv = {2: torch.int16, 4: torch.int32}[a.element_size()]
        a, b = a.view(iv), b.view(iv)
    return torch.equal(a, b)


def max_abs_diff(a, b) -> float:
    """max |a - b| in f32 (exact for bf16, f32 and int8), one layer at a
    time to bound the temporary."""
    return max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def swap_ids(torch, gen, bucket, n_real, n_phys):
    """``n_real`` distinct permuted page ids padded to ``bucket`` with the
    sink page (the last), as the engine pads them."""
    sink = n_phys - 1
    real = torch.randperm(sink, generator=gen, device="cuda")[:n_real]
    pad = torch.full((bucket - n_real,), sink, device="cuda")
    return torch.cat([real, pad]).to(torch.int32)


def check_scatter(torch, name, got, want, before, ids, repeated=()) -> float:
    """``got`` (kernel) equals ``want`` (plain) on every page but the sink
    and the ``repeated`` ones (a plain scatter of repeated ids may leave
    any of their rows on the card: the caller checks those pages, if at
    all), and every page outside ``ids`` and the sink is unchanged from
    ``before``.  Returns max |got - want| over the pages compared."""
    sink = before.shape[1] - 1
    if repeated:
        pick = torch.tensor([p for p in range(sink) if p not in repeated],
                            device="cuda")
        got_c, want_c = got.index_select(1, pick), want.index_select(1, pick)
    else:
        got_c, want_c = got[:, :sink], want[:, :sink]
    require(same_bits(got_c, want_c),
            f"{name}: kernel and plain version disagree on a non-sink page")
    keep = torch.ones(before.shape[1], dtype=torch.bool, device="cuda")
    keep[ids.long()] = False
    keep = keep.nonzero().flatten()
    require(same_bits(got.index_select(1, keep), before.index_select(1, keep)),
            f"{name}: a page outside the ids changed")
    return max_abs_diff(got_c, want_c)


def swap_case(torch, timer, gen, pages, bucket, n_real, timed):
    """Each swap kernel against its plain version on ``pages``; returns, per
    kernel, max |kernel - plain| over what was compared and, when
    ``timed``, its times and bound."""
    from repro_torch.kernels import swap as sw

    L, n_phys, ps, H, hd = pages.shape
    dtype = pages.dtype
    ids = swap_ids(torch, gen, bucket, n_real, n_phys)
    dst = swap_ids(torch, gen, bucket, n_real, n_phys)
    # an all-zero page and an all-zero head among the gathered ones: the
    # INT8 gather's scale-0 path
    pages[:, ids[0].item()] = 0
    pages[:, ids[1].item(), :, 3] = 0

    err = {}
    got = sw.swap_gather_pages(pages, ids)
    want = sw.swap_gather_pages_plain(pages, ids)
    require(same_bits(got, want),
            "swap_gather_pages disagrees with its plain version")
    err["swap_gather_pages"] = max_abs_diff(got, want)
    staged = torch.randn(got.shape, generator=gen, device="cuda").to(dtype)
    del got, want
    p_k = sw.swap_scatter_pages(pages.clone(), dst, staged)
    p_p = sw.swap_scatter_pages_plain(pages.clone(), dst, staged)
    err["swap_scatter_pages"] = check_scatter(
        torch, "swap_scatter_pages", p_k, p_p, pages, dst)
    del p_k, p_p
    qk, sk = sw.swap_gather_pages_q8(pages, ids)
    qp, sp = sw.swap_gather_pages_q8_plain(pages, ids)
    require(same_bits(qk, qp), "swap_gather_pages_q8: codes disagree")
    require(same_bits(sk, sp), "swap_gather_pages_q8: scales disagree")
    require(bool((sk[:, 0] == 0).all()) and bool((sk[:, 1, :, 3] == 0).all()),
            "swap_gather_pages_q8: an all-zero head has a scale != 0")
    err["swap_gather_pages_q8"] = max(max_abs_diff(qk, qp),
                                      max_abs_diff(sk, sp))
    del qk, sk
    p_k = sw.swap_scatter_pages_q8(pages.clone(), dst, qp, sp)
    p_p = sw.swap_scatter_pages_q8_plain(pages.clone(), dst, qp, sp)
    err["swap_scatter_pages_q8"] = check_scatter(
        torch, "swap_scatter_pages_q8", p_k, p_p, pages, dst)
    del p_k, p_p
    torch.cuda.synchronize()
    out = {name: {"max_abs_err": e} for name, e in err.items()}
    if not timed:
        return out

    # the yardsticks take int64 ids
    ids64, dst64 = ids.long(), dst.long()
    # the least traffic these ids need: each distinct page (the real ones
    # and one sink) read once by a gather, each distinct target page (one
    # sink write at most) written once by a scatter, whose staged rows for
    # the repeated sink ids need not be read; a gather writes its whole
    # staged output
    n_src = int(torch.unique(ids).numel())
    n_dst = int(torch.unique(dst).numel())
    page_elems = ps * H * hd
    page_bytes = page_elems * pages.element_size()
    scale_bytes = 4 * H                         # one f32 scale per head
    id_bytes = 4 * bucket
    p_k, p_p = pages.clone(), pages.clone()
    for name, fn, plain, lib, n_bytes, n_ops in (
        ("swap_gather_pages",
         lambda: sw.swap_gather_pages(pages, ids),
         lambda: sw.swap_gather_pages_plain(pages, ids),
         lambda: torch.index_select(pages, 1, ids64),
         L * (n_src + bucket) * page_bytes + id_bytes, 0),
        ("swap_scatter_pages",
         lambda: sw.swap_scatter_pages(p_k, dst, staged),
         lambda: sw.swap_scatter_pages_plain(p_p, dst, staged),
         lambda: p_p.index_copy_(1, dst64, staged),
         2 * L * n_dst * page_bytes + id_bytes, 0),
        # |x|, running max, divide, round, clip (2): 6 f32 operations for
        # each element of a distinct page
        ("swap_gather_pages_q8",
         lambda: sw.swap_gather_pages_q8(pages, ids),
         lambda: sw.swap_gather_pages_q8_plain(pages, ids),
         None,
         L * n_src * page_bytes + L * bucket * (page_elems + scale_bytes)
         + id_bytes, 6 * L * n_src * page_elems),
        # one f32 multiply each
        ("swap_scatter_pages_q8",
         lambda: sw.swap_scatter_pages_q8(p_k, dst, qp, sp),
         lambda: sw.swap_scatter_pages_q8_plain(p_p, dst, qp, sp),
         None,
         L * n_dst * (page_elems + scale_bytes + page_bytes) + id_bytes,
         L * n_dst * page_elems),
    ):
        b_ms, b_by = bound_ms(n_bytes, n_ops, F32_FLOPS_PER_S)
        out[name].update({
            "ms": timer(fn), "plain_ms": timer(plain),
            "library_ms": timer(lib) if lib is not None else None,
            "device_ms": timer.device(fn),
            "library_device_ms": (timer.device(lib) if lib is not None
                                  else None),
            "host_us": host_us(torch, fn),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"pages {tuple(pages.shape)} {str(dtype)[6:]} ids "
                     f"{bucket} ({n_real} real, sink-padded)"})
    # the timed pools: the INT8 scatter wrote last into both
    e = check_scatter(torch, "swap_scatter_pages_q8 (timed pools)", p_k, p_p,
                      pages, dst)
    out["swap_scatter_pages_q8"]["max_abs_err"] = max(
        out["swap_scatter_pages_q8"]["max_abs_err"], e)
    del p_k, p_p
    return out


# small f32 pools at the edges of the redesigned kernels: 512 KiB pages
# (more chunks than the scatter's ring holds, 16 head blocks of the INT8
# gather), a head whose rows (128 KiB) exceed a stage of the INT8 gather
# (its two-pass path), 300 heads (the INT8 scatter's scale slots wrap
# around H, and its 4096-code chunks start inside a head row of 12; the
# INT8 gather's persistent kernel over more heads than a two-pass block),
# 36-code pages (the INT8 scatter's codes off a 16-byte boundary), and 260
# heads of 128 KiB (the INT8 gather's two-pass kernel over two head
# blocks; 0.6 GB)
SWAP_EDGE_POOLS = ((2, 9, 16, 64, 128), (2, 9, 16, 2, 2048),
                   (2, 9, 16, 300, 12), (2, 9, 3, 3, 4),
                   (2, 9, 16, 260, 2048))


def swap_edge_case(torch, gen, shape):
    """Phase 4's bitwise checks on ``shape``, with ids that hold a run of
    three equal real ids and a tail of three sink ids.  The gathers write
    every row.  The scatters equal their plain versions on every page but
    the sink and the repeated one, and change no page outside the ids; both
    leave the sink and the repeated page holding the last staged row of
    their run, the INT8 scatter its dequantization (the TPU kernel's
    sequential grid: last write wins).  Returns max |kernel - plain| per
    kernel."""
    from repro_torch.kernels import swap as sw
    from repro_torch.kernels.ref import dequantize_pages

    sink = shape[1] - 1
    p = torch.randperm(sink, generator=gen, device="cuda").tolist()
    ids = torch.tensor([p[0], p[1], p[1], p[1], p[2], sink, sink, sink],
                       dtype=torch.int32, device="cuda")
    dst = torch.tensor([p[3], p[4], p[4], p[4], p[5], sink, sink, sink],
                       dtype=torch.int32, device="cuda")
    pages = torch.randn(shape, generator=gen, device="cuda")
    pages[:, p[0], :, 1] = 0                     # an all-zero head
    err = {}
    got = sw.swap_gather_pages(pages, ids)
    want = sw.swap_gather_pages_plain(pages, ids)
    require(same_bits(got, want),
            f"swap_gather_pages disagrees with its plain version at {shape}")
    err["swap_gather_pages"] = max_abs_diff(got, want)
    staged = torch.randn(got.shape, generator=gen, device="cuda")
    p_k = sw.swap_scatter_pages(pages.clone(), dst, staged)
    p_p = sw.swap_scatter_pages_plain(pages.clone(), dst, staged)
    err["swap_scatter_pages"] = check_scatter(
        torch, f"swap_scatter_pages at {shape}", p_k, p_p, pages, dst,
        repeated=(p[4],))
    require(same_bits(p_k[:, p[4]], staged[:, 3])
            and same_bits(p_k[:, sink], staged[:, 7]),
            f"swap_scatter_pages at {shape}: a repeated id's page does not "
            "hold the last staged row of its run")
    qp, sp = sw.swap_gather_pages_q8_plain(pages, ids)
    qk, sk = sw.swap_gather_pages_q8(pages, ids)
    require(same_bits(qk, qp) and same_bits(sk, sp),
            f"swap_gather_pages_q8 at {shape}: codes or scales disagree")
    require(bool((sk[:, 0, :, 1] == 0).all()),
            f"swap_gather_pages_q8 at {shape}: an all-zero head has a "
            "scale != 0")
    err["swap_gather_pages_q8"] = max(max_abs_diff(qk, qp),
                                      max_abs_diff(sk, sp))
    del qk, sk, qp, sp
    # the INT8 scatter's staged rows are quantized fresh values, so that the
    # rows of a run differ (the gather's codes repeat with its ids); row 0
    # has an all-zero head (scale 0)
    staged = torch.randn(got.shape, generator=gen, device="cuda")
    staged[:, 0, :, 1] = 0
    qp, sp = sw.swap_gather_pages_q8_plain(
        staged, torch.arange(len(dst), dtype=torch.int32, device="cuda"))
    p_k = sw.swap_scatter_pages_q8(pages.clone(), dst, qp, sp)
    p_p = sw.swap_scatter_pages_q8_plain(pages.clone(), dst, qp, sp)
    err["swap_scatter_pages_q8"] = check_scatter(
        torch, f"swap_scatter_pages_q8 at {shape}", p_k, p_p, pages, dst,
        repeated=(p[4],))
    deq = dequantize_pages(qp[:, [3, 7]], sp[:, [3, 7]], pages.dtype)
    require(same_bits(p_k[:, p[4]], deq[:, 0])
            and same_bits(p_k[:, sink], deq[:, 1]),
            f"swap_scatter_pages_q8 at {shape}: a repeated id's page does not "
            "hold the dequantized last staged row of its run")
    torch.cuda.synchronize()
    return err


def round_trip(torch, timer, gen, pages, bucket, n_real):
    """Gather, copy to pinned host memory and back, scatter into other
    pages: the same bytes in the pool's dtype; within half a quantization
    step (plus one rounding to the pool's dtype) through the INT8 pair.
    Returns the host-copy times of one staged tensor."""
    from repro_torch.kernels import swap as sw

    L, n_phys = pages.shape[:2]
    ids = swap_ids(torch, gen, bucket, n_real, n_phys)
    dst = swap_ids(torch, gen, bucket, n_real, n_phys)
    real, dst_real = ids[:n_real].long(), dst[:n_real].long()

    def via_host(t):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        torch.cuda.synchronize()
        return host, host.to("cuda", non_blocking=True)

    staged = sw.swap_gather_pages(pages, ids)
    host, back = via_host(staged)
    p_r = sw.swap_scatter_pages(pages.clone(), dst, back)
    require(same_bits(p_r.index_select(1, dst_real), pages.index_select(1, real)),
            "fp round trip changed the bytes")
    q, scales = sw.swap_gather_pages_q8(pages, ids)
    (hq, q_back), (hs, s_back) = via_host(q), via_host(scales)
    sw.swap_scatter_pages_q8(p_r, dst, q_back, s_back)
    x = pages.index_select(1, real).float()
    err = (p_r.index_select(1, dst_real).float() - x).abs()
    bound = scales[:, :n_real] * 0.5 + 1e-6
    if pages.dtype == torch.bfloat16:
        bound = bound + x.abs() * 2.0 ** -8
    require(bool((err <= bound).all()),
            f"INT8 round trip: max |d| {err.max().item():.3e} over the bound")
    del p_r
    times = {
        "d2h_fp_ms": timer(lambda: host.copy_(staged, non_blocking=True)),
        "h2d_fp_ms": timer(lambda: back.copy_(host, non_blocking=True)),
        "d2h_q8_ms": timer(lambda: (hq.copy_(q, non_blocking=True),
                                    hs.copy_(scales, non_blocking=True))),
        "h2d_q8_ms": timer(lambda: (q_back.copy_(hq, non_blocking=True),
                                    s_back.copy_(hs, non_blocking=True))),
        "fp_bytes": staged.numel() * staged.element_size(),
        "q8_bytes": q.numel() + scales.numel() * 4,
    }
    return times


def swap_kernel_phase(torch):
    gen = torch.Generator(device="cuda").manual_seed(1)
    timer = Timer(torch)
    results, worst = {}, {n: 0.0 for n in SWAP_KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        pages = torch.randn(SWAP_POOL, generator=gen, device="cuda").to(dtype)
        for bucket, n_real in SWAP_BUCKETS:
            # timed at the main path's shapes: bf16, the longest victim
            timed = dtype == torch.bfloat16 and bucket == 32
            r = swap_case(torch, timer, gen, pages, bucket, n_real, timed)
            log(f"  swap kernels {str(dtype)[6:]} bucket {bucket} "
                f"({n_real} real): bitwise equal to the plain versions, "
                "pages outside the ids unchanged; max |kernel - plain| "
                f"{max(v['max_abs_err'] for v in r.values()):.3e}")
            for name, v in r.items():
                worst[name] = max(worst[name], v["max_abs_err"])
            if timed:
                results = r
        if dtype == torch.bfloat16:
            t = round_trip(torch, timer, gen, pages, 32, 19)
            log(f"  round trip bf16 (bucket 32) exact, INT8 within the bound; "
                f"host copies of one staged tensor: fp {t['fp_bytes']} B "
                f"D2H {t['d2h_fp_ms']:.4f} ms H2D {t['h2d_fp_ms']:.4f} ms, "
                f"INT8 {t['q8_bytes']} B D2H {t['d2h_q8_ms']:.4f} ms "
                f"H2D {t['h2d_q8_ms']:.4f} ms")
        del pages
        torch.cuda.empty_cache()
    for shape in SWAP_EDGE_POOLS:
        e = swap_edge_case(torch, gen, shape)
        torch.cuda.empty_cache()
        log(f"  swap kernels float32 {shape}, ids with a run of 3 equal real "
            "ids and 3 sink ids: bitwise equal to the plain versions, pages "
            "outside the ids unchanged, the last of each run written; max "
            f"|kernel - plain| {max(e.values()):.3e}")
        for name, v in e.items():
            worst[name] = max(worst[name], v)
    # the kernels line reports the timed case and the worst error over
    # every case
    for name, r in results.items():
        r["max_abs_err"] = worst[name]
        log_swap_times(name, r)
    log(swap_yardsticks(torch, timer, SWAP_POOL, 20))
    return results


def swap_yardsticks(torch, timer, pool, n_pages) -> str:
    """The device-only timer's yardsticks at a swap case on a bf16 pool of
    shape ``pool``: a launch that does nothing, and ``copy_`` of ``n_pages``
    pages of every layer (the bytes a scatter of that many distinct pages
    must read and write)."""
    src = torch.empty((pool[0], n_pages) + tuple(pool[2:]),
                      dtype=torch.bfloat16, device="cuda")
    dst = torch.empty_like(src)
    empty = timer.device(lambda: torch.cuda._sleep(1))
    copy = timer.device(lambda: dst.copy_(src))
    return (f"  yardsticks on the device alone: an empty launch {empty:.4f} "
            f"ms; copy_ of {n_pages} pages a layer "
            f"({2 * src.numel() * src.element_size()} B moved) {copy:.4f} ms")


def log_swap_times(name, r) -> None:
    """One line of a timed swap case: the phase's timer, the device alone
    and the wrapper's host time per call."""
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    lib_dev = ("none" if r["library_device_ms"] is None
               else f"{r['library_device_ms']:.4f} ms")
    log(f"  {name} {r['shape']}: kernel {r['ms']:.4f} ms plain "
        f"{r['plain_ms']:.4f} ms library {lib} bound {r['bound_ms']:.4f} "
        f"ms ({r['bound_by']}) max |kernel - plain| {r['max_abs_err']:.3e}; "
        f"device only: kernel {r['device_ms']:.4f} ms, library {lib_dev}; "
        f"kernel host time {r['host_us']:.1f} us per call")


# -- phase 5: the serving main path --------------------------------------------
def replay_ms(tracer) -> float:
    """Mean host ms of the ``engine.replay`` spans: launching a round's
    graph replay, or its eager step, and its readback copy."""
    return statistics.mean((s.t1 - s.t0) / 1e6 for s in tracer.spans()
                           if s.name == "engine.replay")


def serve_phase(torch):
    from repro_torch.engine.engine import serve
    from repro_torch.kernels.paged_decode_attention import paged_decode_attention
    from repro_torch.kernels.paged_prefill_attention import paged_prefill_attention
    from repro_torch import tracing
    from repro_torch.launch import serve as serve_cli

    args = serve_cli.build_parser().parse_args(["--full"])
    t0 = time.perf_counter()
    engine, sched, kv_pool, reqs = serve_cli.build(args)   # binds + warms up
    log(f"  engine built and warmed up in {time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine.bucket_rounds.clear()
    paged_decode_attention.launches = 0
    paged_prefill_attention.launches = 0
    tracer = tracing.Tracer()
    res = serve(reqs, sched, engine, kv_pool=kv_pool, tracer=tracer)
    torch.cuda.synchronize()
    launches = {"paged_decode_attention": paged_decode_attention.launches,
                "paged_prefill_attention": paged_prefill_attention.launches}
    peak = torch.cuda.max_memory_allocated()

    cfg = engine.model_cfg
    toks = check_outputs(res, reqs, cfg.vocab_size)
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
    replay = replay_ms(tracer)
    log(f"  served {rep.n_finished}/{rep.n_total} requests, {len(toks)} output "
        f"tokens in {res.wall_s:.3f} s over {res.rounds} rounds "
        f"(by chunk bucket: {dict(sorted(engine.bucket_rounds.items()))})")
    log(f"  output tok/s {out_tok_s:.1f}  mean TTFT {rep.ttft['mean'] * 1e3:.2f} ms"
        f"  P99 E2E {rep.e2e['p99'] * 1e3:.2f} ms  mean bubble_ms {bubble:.3f}"
        f"  mean engine.replay span {replay:.3f} ms"
        f"  peak memory {peak / 2**30:.3f} GiB")
    log(f"  kernel launches on the main path: {launches}")
    for line in tracing.summary(tracer.spans()):
        log(f"  spans: {line}")
    return engine, launches, [res.outputs[r.req_id] for r in reqs]


# -- phases 6-8: swap, the INT8 host tier, disagg ------------------------------
SWAP_KV_BLOCKS = 48     # 16 slots of up to 19 pages each: the pressure bites
# the swap serves' requests all arrive at once, so the pressure bites
# however fast a round runs: at phase 5's 0.02 s the compiled round
# finishes requests before enough of them overlap to fill 48 blocks
SWAP_FLAGS = ["--preemption-mode", "swap", "--kv-blocks", str(SWAP_KV_BLOCKS),
              "--interval", "0"]


def check_outputs(res, reqs, vocab_size):
    """Every request finished with its full token count, every token in the
    vocabulary; returns all output tokens."""
    bad = [r.req_id for r in reqs
           if len(res.outputs.get(r.req_id, [])) != r.max_new_tokens]
    if res.report.n_finished != len(reqs) or bad:
        raise AssertionError(f"{res.report.n_finished}/{len(reqs)} finished; "
                             f"short outputs: {bad}")
    toks = [t for r in reqs for t in res.outputs[r.req_id]]
    if not all(0 <= t < vocab_size for t in toks):
        raise AssertionError("a sampled token is outside the vocabulary")
    return toks


def zero_launches() -> None:
    from repro_torch.engine import graphs
    graphs.add_launches(graphs.launch_counts(), -1)


def read_launches():
    """Every kernel's launches by name, and the paged attention kernels'
    windowed ones as ``"<name>.windowed"``."""
    from repro_torch.engine import graphs
    return graphs.launch_counts()


def note_tokens(reqs, outputs, baseline) -> None:
    same = sum(outputs[r.req_id] == b for r, b in zip(reqs, baseline))
    log(f"  greedy outputs equal to the recompute serve phase's: {same} of "
        f"{len(reqs)} requests (printed, not gated: bf16)")


def attention_names(layout):
    """(this layout's attention kernels, the other layout's)."""
    split = ("paged_decode_attention", "paged_prefill_attention")
    fused = tuple(n + "_fused" for n in split)
    return (fused, split) if layout == "fused" else (split, fused)


def swap_serve_phase(torch, host_kv_dtype, baseline, layout="split"):
    from repro_torch.engine.engine import serve
    from repro_torch.launch import serve as serve_cli

    args = serve_cli.build_parser().parse_args(
        ["--full", "--kv-layout", layout] + SWAP_FLAGS)
    engine, sched, kv_pool, reqs = serve_cli.build(
        args, host_kv_dtype=host_kv_dtype)               # binds + warms up
    torch.cuda.synchronize()
    zero_launches()
    res = serve(reqs, sched, engine, kv_pool=kv_pool)
    torch.cuda.synchronize()
    launches = read_launches()

    toks = check_outputs(res, reqs, engine.model_cfg.vocab_size)
    st = sched.stats
    # one gather / scatter per cache tensor: K and V split, one fused pool
    per = len(engine.cache)
    require(st.swap_preemptions > 0, "no swap preemption happened")
    require(st.swap_restores == st.swap_preemptions,
            f"{st.swap_restores} restores != {st.swap_preemptions} swap-outs")
    used, idle = SWAP_KERNELS[:2], SWAP_KERNELS[2:]
    if host_kv_dtype == "int8":
        used, idle = idle, used
    require(launches[used[0]] == per * st.swap_preemptions,
            f"{used[0]} launches {launches} != {per} x {st.swap_preemptions} "
            f"swap-outs ({tuple(engine.cache)})")
    require(launches[used[1]] == per * st.swap_restores,
            f"{used[1]} launches {launches} != {per} x {st.swap_restores} "
            "restores")
    require(launches[idle[0]] == launches[idle[1]] == 0,
            f"the other swap pair ran: {launches}")
    attn, other = attention_names(layout)
    require(min(launches[n] for n in attn) > 0,
            f"an attention kernel did not run: {launches}")
    require(max(launches[n] for n in other) == 0,
            f"the other layout's attention kernels ran: {launches}")
    require(not kv_pool.swapped_requests(), "a request is still staged")
    kv_pool.check_invariants()
    log(f"  served {res.report.n_finished}/{res.report.n_total} requests, "
        f"{len(toks)} tokens in {res.wall_s:.3f} s over {res.rounds} rounds; "
        f"{st.preemptions} preemptions, {st.swap_preemptions} swapped out "
        f"({st.swap_restores} restored), output tok/s "
        f"{len(toks) / res.wall_s:.1f}")
    log(f"  kernel launches: {launches}")
    note_tokens(reqs, res.outputs, baseline)
    return launches


def disagg_phase(torch, baseline):
    from repro_torch.disagg import serve_disagg
    from repro_torch.launch import serve as serve_cli

    args = serve_cli.build_parser().parse_args(["--full", "--disagg"])
    router, reqs = serve_cli.build_fleet(args)
    require(len(router.prefill) == len(router.decode) == 1,
            "expected 1 prefill and 1 decode replica")
    require(router.prefill[0].engine.params is router.decode[0].engine.params,
            "the replicas do not share one weight set")
    torch.cuda.synchronize()
    zero_launches()
    res = serve_disagg(reqs, router)
    torch.cuda.synchronize()
    launches = read_launches()
    router.check_invariants()

    toks = check_outputs(res, reqs, router.prefill[0].engine.model_cfg.vocab_size)
    require(res.handoffs == len(reqs) and res.colocated == 0
            and all(r.handoffs == 1 for r in reqs),
            f"handoffs {res.handoffs} colocated {res.colocated} of {len(reqs)}")
    decode_prefill = sum(rs.sched.stats.scheduled_prefill_tokens
                         for rs in router.decode)
    require(decode_prefill == 0,
            f"the decode pool prefilled {decode_prefill} tokens")
    swapped = sum(rs.sched.stats.swap_preemptions for rs in router.replicas)
    restores = sum(rs.sched.stats.swap_restores for rs in router.replicas)
    require(restores == res.handoffs + swapped,
            f"{restores} restores != {res.handoffs} imports + {swapped} swap-outs")
    require(launches["swap_gather_pages"] == 2 * (res.handoffs + swapped),
            f"gather launches {launches} != 2 x ({res.handoffs} exports + "
            f"{swapped} swap-outs)")
    require(launches["swap_scatter_pages"] == 2 * restores,
            f"scatter launches {launches} != 2 x {restores} imports")
    log(f"  served {res.report.n_finished}/{res.report.n_total} requests, "
        f"{len(toks)} tokens in {res.wall_s:.3f} s over {res.rounds} rounds "
        f"on {len(router.replicas)} replicas; {res.handoffs} handoffs "
        f"({res.bytes_moved / 2**20:.1f} MiB), decode-pool prefill tokens "
        f"{decode_prefill}, output tok/s {len(toks) / res.wall_s:.1f}")
    log(f"  kernel launches: {launches}")
    note_tokens(reqs, res.outputs, baseline)
    return launches


# -- phase 9: full-width model, kernels on the card vs plain on the CPU --------
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




# -- phase 11: the swap kernels on the fused pool --------------------------------
FUSED_SWAP_POOL = (24, 2049, 16, 32, 64)   # (L, n_phys, ps, 2*Hkv, hd)


def fused_swap_kernel_phase(torch):
    gen = torch.Generator(device="cuda").manual_seed(11)
    pages = torch.randn(FUSED_SWAP_POOL, generator=gen,
                        device="cuda").to(torch.bfloat16)
    timer = Timer(torch)
    r = swap_case(torch, timer, gen, pages, 32, 19, timed=True)
    log(f"  swap kernels on the fused pool {FUSED_SWAP_POOL} bf16 bucket 32 "
        "(19 real): bitwise equal to the plain versions, pages outside the "
        "ids unchanged; max |kernel - plain| "
        f"{max(v['max_abs_err'] for v in r.values()):.3e}")
    for name, v in r.items():
        log_swap_times(name, v)
    del pages
    log(swap_yardsticks(torch, timer, FUSED_SWAP_POOL, 20))
    torch.cuda.empty_cache()


# -- phases 12-13: the fused layout served, static budget and LPRS -------------
def record_chunks(sched):
    """Record the chunk size of every prefill chunk the scheduler commits.
    The caller deletes ``sched.schedule`` after the run: the wrapper holds
    the scheduler's bound method, a reference cycle that would keep the
    scheduler -- and through its hooks the engine -- alive until the cyclic
    collector runs."""
    chunks = []
    schedule = sched.schedule

    def recording(now):
        batch = schedule(now)
        chunks.extend(c for _, c in batch.prefill_chunks)
        return batch

    sched.schedule = recording
    return chunks


def fused_serve_phase(torch, baseline):
    from repro_torch.engine.engine import serve
    from repro_torch.launch import serve as serve_cli

    args = serve_cli.build_parser().parse_args(
        ["--full", "--kv-layout", "fused"])
    engine, sched, kv_pool, reqs = serve_cli.build(args)  # binds + warms up
    cfg = engine.model_cfg
    require(tuple(engine.cache) == ("kv",)
            and engine.cache["kv"].shape[3] == 2 * cfg.n_kv_heads,
            f"not a fused pool: {[tuple(t.shape) for t in engine.cache.values()]}")
    chunks = record_chunks(sched)
    torch.cuda.synchronize()
    engine.bucket_rounds.clear()
    zero_launches()
    try:
        res = serve(reqs, sched, engine, kv_pool=kv_pool, collect_samples=True)
        torch.cuda.synchronize()
    finally:
        del sched.schedule
    launches = read_launches()

    toks = check_outputs(res, reqs, cfg.vocab_size)
    decode_rounds = engine.bucket_rounds.get(1, 0)
    mixed_rounds = sum(n for c, n in engine.bucket_rounds.items() if c > 1)
    require(decode_rounds > 0 and mixed_rounds > 0,
            f"rounds by bucket {engine.bucket_rounds}")
    require(launches["paged_decode_attention_fused"]
            == cfg.n_layers * decode_rounds,
            f"fused decode launches {launches} != {cfg.n_layers} x "
            f"{decode_rounds} pure-decode rounds")
    require(launches["paged_prefill_attention_fused"]
            == cfg.n_layers * mixed_rounds,
            f"fused prefill launches {launches} != {cfg.n_layers} x "
            f"{mixed_rounds} rounds with C > 1")
    require(launches["paged_decode_attention"]
            == launches["paged_prefill_attention"] == 0,
            f"a split attention kernel ran on the fused path: {launches}")
    log(f"  served {res.report.n_finished}/{res.report.n_total} requests, "
        f"{len(toks)} output tokens in {res.wall_s:.3f} s over {res.rounds} "
        f"rounds (by chunk bucket: {dict(sorted(engine.bucket_rounds.items()))})"
        f"; output tok/s {len(toks) / res.wall_s:.1f}")
    log(f"  kernel launches on the fused path: {launches}")
    note_tokens(reqs, res.outputs, baseline)
    static = {"res": res, "chunks": chunks, "searches": 0,
              "tokens": len(toks)}
    return engine, kv_pool, launches, static


def time_predict_us(predict, x, n=200) -> float:
    for _ in range(20):
        predict(x)
    t0 = time.perf_counter()
    for _ in range(n):
        predict(x)
    return (time.perf_counter() - t0) / n * 1e6


def lprs_phase(torch, engine, kv_pool, static):
    import numpy as np
    from repro_torch.core.predictor import LatencyPredictor
    from repro_torch.engine.engine import serve
    from repro_torch.launch import serve as serve_cli

    cfg = engine.model_cfg
    t0 = time.perf_counter()
    feats, lats = serve_cli.profile_engine(cfg, engine, kv_pool=kv_pool)
    t1 = time.perf_counter()
    pred = serve_cli.train_predictor(feats, lats)
    t2 = time.perf_counter()
    require(pred.device.type == "cpu", f"predictor on {pred.device}")
    p10, p50, p60, p90 = (float(x) for x in np.percentile(lats, [10, 50, 60, 90]))
    log(f"  profile: {len(lats)} rounds in {t1 - t0:.2f} s, round latency "
        f"p10 {p10:.3f} p50 {p50:.3f} p90 {p90:.3f} ms; predictor trained "
        f"on the CPU in {t2 - t1:.2f} s")
    ev = pred.evaluate(feats, lats)
    log(f"  predictor on the profile: MAPE {ev['mape_pct']:.2f}% MAE "
        f"{ev['mae_ms']:.3f} ms p99 |err| {ev['p99_ms']:.3f} ms")
    # one chunk search's batch: candidates {1, 32, 64, 96, 128}
    x = feats[:5]
    on_card = LatencyPredictor.from_state(pred.state_dict(), device="cuda")
    a, b = pred.predict(x), on_card.predict(x)
    require(bool(np.allclose(a, b, rtol=1e-4, atol=1e-3)),
            f"predict() on the card {b} != on the CPU {a}")
    us_cpu = time_predict_us(pred.predict, x)
    us_cuda = time_predict_us(on_card.predict, x)
    log(f"  predict() of 5 candidates, idle card: {us_cpu:.1f} us per call "
        f"on the CPU, {us_cuda:.1f} us on cuda")

    args = serve_cli.build_parser().parse_args(
        ["--full", "--kv-layout", "fused", "--policy", "aging", "--lprs",
         "--apc", "--target-ms", repr(p60)])
    sched = serve_cli.build_scheduler(args, pred)
    require(sched.cfg.lprs.target_latency_ms == p60, "target not passed on")
    reqs = serve_cli.workload(args, cfg)
    chunks = record_chunks(sched)
    searches = [0]
    predict = pred.predict

    def counted(features):
        searches[0] += 1
        return predict(features)

    pred.predict = counted
    torch.cuda.synchronize()
    zero_launches()
    try:
        res = serve(reqs, sched, engine, kv_pool=kv_pool, collect_samples=True)
        torch.cuda.synchronize()
    finally:
        # the wrappers hold bound methods of their objects: reference cycles
        del sched.schedule, pred.predict
    launches = read_launches()
    toks = check_outputs(res, reqs, cfg.vocab_size)
    require(searches[0] > 0, "the LPRS predictor was never called")
    require(min(launches[n] for n in attention_names("fused")[0]) > 0,
            f"a fused attention kernel did not run: {launches}")
    lprs = {"res": res, "chunks": chunks, "searches": searches[0],
            "tokens": len(toks)}
    log(f"  target {p60:.3f} ms (p60 of the profile); kernel launches "
        f"{launches}")
    for label, run in (("static", static), ("lprs+apc", lprs)):
        r, ch = run["res"], np.asarray(run["chunks"], np.float64)
        over = float(np.mean(r.samples[1] > p60))
        log(f"  {label:9s} finished {r.report.n_finished}/{r.report.n_total}"
            f" in {r.wall_s:.3f} s over {r.rounds} rounds; chunk searches "
            f"{run['searches']}; chunk size mean {ch.mean():.1f} p99 "
            f"{np.percentile(ch, 99):.1f} over {len(ch)} chunks; rounds over "
            f"the target {over:.1%}; output tok/s "
            f"{run['tokens'] / r.wall_s:.1f}; P99 E2E "
            f"{r.report.e2e['p99'] * 1e3:.1f} ms; mean TTFT "
            f"{r.report.ttft['mean'] * 1e3:.1f} ms")


# -- phase 14: the dense attention kernels -------------------------------------
def dense_cache(torch, gen, *, B, S, Hkv, hd, dtype, sink=True):
    """Random K/V caches; with ``sink``, ``(B, S + 1, Hkv, hd)`` tensors
    returned as the engine's ``[:, :-1]`` views (not contiguous: batch stride
    ``(S + 1) * Hkv * hd``), else contiguous ``(B, S, Hkv, hd)``."""
    rows = S + 1 if sink else S
    k, v = (torch.randn((B, rows, Hkv, hd), generator=gen,
                        device="cuda").to(dtype) for _ in range(2))
    return (k[:, :-1], v[:, :-1]) if sink else (k, v)


def as_pages(torch, gen, k, v, ps):
    """The same keys laid into split page pools: sequence b's keys [p*ps,
    (p+1)*ps) on page ``tables[b, p]``, a permutation of the pool's pages;
    returns (k_pages, v_pages, tables)."""
    B, S = k.shape[:2]
    n = S // ps
    tables = torch.randperm(B * n, generator=gen, device="cuda").reshape(B, n)
    pools = []
    for cache in (k, v):
        pool = torch.empty((B * n + 1, ps) + tuple(cache.shape[2:]),
                           dtype=cache.dtype, device="cuda")
        pool[tables.flatten().long()] = cache.reshape(B * n, ps,
                                                      *cache.shape[2:])
        pools.append(pool)
    return (*pools, tables.to(torch.int32).contiguous())


def poison_check(torch, kernel, args, key_args, b, where):
    """NaN at one key of sequence ``b`` (K and V, every head) must reach that
    sequence's output and no other: the NaN guard's trap.  ``key_args`` are
    the indices in ``args`` of the K and V tensors, and ``where`` the key's
    index in them: (b, pos) in dense caches, (page, row) in page pools."""
    clean = kernel(*args)
    args = list(args)
    for i in key_args:
        args[i] = args[i].clone()
        args[i][where] = float("nan")
    got = kernel(*args)
    torch.cuda.synchronize()
    require(bool(torch.isnan(got[b]).any()),
            "a NaN key of a valid position did not reach the output")
    others = [i for i in range(got.shape[0]) if i != b]
    require(same_bits(got[others], clean[others]),
            "a NaN key changed another sequence's output")


def below_window_check(torch, kernel, args, key_args, where):
    """NaN at a key (K and V, every head; ``where`` as for
    ``poison_check``) below every window of its sequence must change no
    output at all: a windowed kernel neither reads nor weighs it (a NaN
    value read and weighted 0 would still give NaN)."""
    clean = kernel(*args)
    args = list(args)
    for i in key_args:
        args[i] = args[i].clone()
        args[i][where] = float("nan")
    got = kernel(*args)
    torch.cuda.synchronize()
    require(same_bits(got, clean),
            "a NaN key below the window changed the output")


def dense_prefill_case(torch, timer, gen, *, B, Sq, Hq, Hkv, hd, S, dtype,
                       timed, ps=16):
    """``chunked_prefill_attention`` on the engine's ``cache[:, :-1]`` view
    against its plain version, and bitwise against the paged prefill kernel
    on the same keys laid into pages."""
    from repro_torch.kernels.chunked_prefill_attention import (
        chunked_prefill_attention, chunked_prefill_attention_plain)
    from repro_torch.kernels.paged_prefill_attention import (
        paged_prefill_attention)
    import torch.nn.functional as F

    dev = "cuda"
    k, v = dense_cache(torch, gen, B=B, S=S, Hkv=Hkv, hd=hd, dtype=dtype)
    require(not k.is_contiguous(), "the sink view should not be contiguous")
    q = torch.randn((B, Sq, Hq, hd), generator=gen, device=dev).to(dtype)
    q_offset, kv_lens = chunk_lens_for(gen, B, Sq, S, dev)
    args = (q, k, v, kv_lens, q_offset)
    got = chunked_prefill_attention(*args)
    want = chunked_prefill_attention_plain(*args)
    torch.cuda.synchronize()
    live = kv_lens > 0
    require(bool((got[~live] == 0).all()),
            "chunked prefill kernel: a row with no valid key is not 0")
    err = max_err(got, want, live)
    kp, vp, tables = as_pages(torch, gen, k, v, ps)
    require(same_bits(got, paged_prefill_attention(q, kp, vp, tables, kv_lens,
                                                   q_offset)),
            "chunked prefill kernel differs from the paged prefill kernel")
    del kp, vp
    if not timed:
        return {"max_abs_err": err}
    poison_check(torch, chunked_prefill_attention, args, (1, 2), 2,
                 (2, int(q_offset[2]) - 1))
    pos_q = q_offset[:, None].long() + torch.arange(Sq, device=dev)[None, :]
    pos_k = torch.arange(S, device=dev)
    mask = ((pos_k[None, None, :] <= pos_q[:, :, None])
            & (pos_k[None, None, :] < kv_lens[:, None, None].long()))[:, None]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    ms = timer(lambda: chunked_prefill_attention(*args))
    plain_ms = timer(lambda: chunked_prefill_attention_plain(*args))
    lib_ms = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=Hq != Hkv))
    vis = torch.minimum(kv_lens[:, None].long(), pos_q + 1).clamp(min=0)
    esz = q.element_size()
    n_bytes = (2 * q.numel() * esz + 2 * int(kv_lens.sum()) * Hkv * hd * esz
               + 4 * 2 * B)
    n_flops = 4 * int(vis.sum()) * Hq * hd
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "shape": f"B={B} Sq={Sq} Hq={Hq} Hkv={Hkv} hd={hd} cache "
                     f"({B}, {S + 1}, {Hkv}, {hd})[:, :-1] kv_lens<={S}"}


def dense_decode_case(torch, timer, gen, *, B, Hq, Hkv, hd, S, dtype, timed,
                      sink=True, ps=16):
    """``decode_attention`` against its plain version and, on a sink view,
    bitwise against the paged decode kernel on the same keys in pages."""
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain)
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention)
    import torch.nn.functional as F

    dev = "cuda"
    k, v = dense_cache(torch, gen, B=B, S=S, Hkv=Hkv, hd=hd, dtype=dtype,
                       sink=sink)
    q = torch.randn((B, Hq, hd), generator=gen, device=dev).to(dtype)
    kv_lens = torch.randint(1, S + 1, (B,), generator=gen,
                            device=dev).to(torch.int32)
    kv_lens[0], kv_lens[1] = 0, S
    args = (q, k, v, kv_lens)
    got = decode_attention(*args)
    want = decode_attention_plain(*args)
    torch.cuda.synchronize()
    live = kv_lens > 0
    require(bool((got[~live] == 0).all()),
            "decode kernel: a row with no valid key is not 0")
    err = max_err(got, want, live)
    if sink:
        kp, vp, tables = as_pages(torch, gen, k, v, ps)
        require(same_bits(got, paged_decode_attention(q, kp, vp, tables,
                                                      kv_lens)),
                "decode kernel differs from the paged decode kernel")
        del kp, vp
    poison_check(torch, decode_attention, args, (1, 2), 1, (1, S - 1))
    if not timed:
        return {"max_abs_err": err}
    mask = (torch.arange(S, device=dev)[None, :]
            < kv_lens[:, None].long())[:, None, None, :]
    q4, kt, vt = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
    ms = timer(lambda: decode_attention(*args))
    plain_ms = timer(lambda: decode_attention_plain(*args))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, kt, vt, attn_mask=mask, enable_gqa=Hq != Hkv)
    lib_ms = timer(sdpa)
    keys = int(kv_lens.sum())
    esz = q.element_size()
    n_bytes = 2 * q.numel() * esz + 2 * keys * Hkv * hd * esz + 4 * B
    b_ms, b_by = bound_ms(n_bytes, 4 * keys * Hq * hd)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "device_ms": timer.device(lambda: decode_attention(*args)),
            "library_device_ms": timer.device(sdpa),
            "host_us": host_us(torch, lambda: decode_attention(*args)),
            "shape": f"B={B} Hq={Hq} Hkv={Hkv} hd={hd} S={S} kv_lens<={S} "
                     f"(sum {keys}){' sink view' if sink else ''}"}


def paged_poison_phase(torch):
    """The shared normalisation lets a NaN key through the paged kernels of
    both layouts too (the NaN guard serves them)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention, paged_decode_attention_fused)
    from repro_torch.kernels.paged_prefill_attention import (
        paged_prefill_attention, paged_prefill_attention_fused)

    gen = torch.Generator(device="cuda").manual_seed(14)
    B, S, H, hd, ps = 4, 512, 16, 64, 16
    k, v = dense_cache(torch, gen, B=B, S=S, Hkv=H, hd=hd,
                       dtype=torch.bfloat16, sink=False)
    q = torch.randn((B, 16, H, hd), generator=gen, device="cuda").to(k.dtype)
    q_offset, kv_lens = chunk_lens_for(gen, B, 16, S, "cuda")
    q0 = q[:, 0].contiguous()
    b, pos = 2, int(q_offset[2]) - 1            # a prefix key of row 2
    for poisoned in (False, True):
        if poisoned:
            k[b, pos] = float("nan")
            v[b, pos] = float("nan")
        kp, vp, tables = as_pages(torch, gen, k, v, ps)
        kvp = ref.fuse_pages(kp, vp)
        outs = [paged_prefill_attention(q, kp, vp, tables, kv_lens, q_offset),
                paged_prefill_attention_fused(q, kvp, tables, kv_lens, q_offset),
                paged_decode_attention(q0, kp, vp, tables, kv_lens),
                paged_decode_attention_fused(q0, kvp, tables, kv_lens)]
        torch.cuda.synchronize()
        if not poisoned:
            clean = outs
            continue
        for name, got, c in zip(("prefill split", "prefill fused",
                                 "decode split", "decode fused"), outs, clean):
            require(bool(torch.isnan(got[b]).all()),
                    f"paged {name}: a NaN key did not reach every output of "
                    "its sequence")
            others = [i for i in range(B) if i != b]
            require(same_bits(got[others], c[others]),
                    f"paged {name}: a NaN key changed another sequence")
    log("  a NaN key reaches its sequence's output (and no other) through "
        "the paged split and fused kernels")


def dense_kernel_phase(torch):
    """Phase 14: both dense attention kernels at the dense serve shapes and
    a GQA shape, each timed at the main-path shape; decode also at one
    long-cache shape."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    timer = Timer(torch)
    bf16, f32 = torch.bfloat16, torch.float32
    qwen = dict(B=16, Hq=16, Hkv=16, hd=64, S=512)      # the dense serve slots
    gqa = dict(qwen, Hq=32, Hkv=8)
    gqa128 = dict(gqa, hd=128)
    group12 = dict(qwen, Hq=96, Hkv=8, hd=128)          # mistral-large-123b
    group48 = dict(qwen, Hq=48, Hkv=1, hd=128)          # granite-34b (MQA)
    group7 = dict(qwen, Hq=56, Hkv=8, hd=128)           # arctic-480b
    merge = dict(gqa128, B=4, S=2048)       # up to four decode splits merged
    merge48 = dict(group48, B=4, S=2048)
    merge7 = dict(group7, B=4, S=2048)
    results = {}
    buckets = {}
    for Sq in (1, 16, 32, 64, 128, 256):
        r = dense_prefill_case(torch, timer, gen, Sq=Sq, dtype=bf16,
                               timed=True, **qwen)
        buckets[Sq] = r
        log(f"  chunked prefill qwen bf16 {r['shape']}: err "
            f"{r['max_abs_err']:.3e} kernel {r['ms']:.4f} ms plain "
            f"{r['plain_ms']:.4f} ms sdpa {r['library_ms']:.4f} ms bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    for dtype, shape, Sq, name in ((bf16, gqa, 64, "gqa bf16 Sq=64"),
                                   (bf16, gqa128, 64, "gqa hd=128 bf16 Sq=64"),
                                   (bf16, gqa128, 1, "gqa hd=128 bf16 Sq=1"),
                                   (f32, qwen, 128, "qwen f32 Sq=128"),
                                   (bf16, group7, 1, "group 7 bf16 Sq=1"),
                                   (bf16, group7, 128, "group 7 bf16 Sq=128"),
                                   (f32, group7, 64, "group 7 f32 Sq=64")):
        r = dense_prefill_case(torch, timer, gen, Sq=Sq, dtype=dtype,
                               timed=False, **shape)
        log(f"  chunked prefill {name}: err {r['max_abs_err']:.3e}")
    log("  every chunked prefill output bitwise equal to the paged prefill "
        "kernel's on the same keys in pages; a NaN key reaches its row")
    pre = dict(buckets[128])
    pre["max_abs_err"] = max(b["max_abs_err"] for b in buckets.values())
    results["chunked_prefill_attention"] = pre

    dec = dense_decode_case(torch, timer, gen, dtype=bf16, timed=True, **qwen)
    log(f"  decode qwen bf16 {dec['shape']}: err {dec['max_abs_err']:.3e} "
        f"kernel {dec['ms']:.4f} ms plain {dec['plain_ms']:.4f} ms sdpa "
        f"{dec['library_ms']:.4f} ms bound {dec['bound_ms']:.4f} ms "
        f"({dec['bound_by']})" + device_note(dec))
    worst = dec["max_abs_err"]
    for dtype, shape, name in ((bf16, gqa, "gqa bf16"),
                               (bf16, gqa128, "gqa hd=128 bf16"),
                               (f32, qwen, "qwen f32"),
                               (f32, group12, "group 12 f32"),
                               (f32, group48, "group 48 f32"),
                               (bf16, group7, "group 7 bf16"),
                               (f32, group7, "group 7 f32"),
                               (bf16, merge, "gqa hd=128 S=2048 bf16"),
                               (f32, merge, "gqa hd=128 S=2048 f32"),
                               (bf16, merge48, "group 48 S=2048 bf16"),
                               (bf16, merge7, "group 7 S=2048 bf16")):
        r = dense_decode_case(torch, timer, gen, dtype=dtype, timed=False,
                              **shape)
        worst = max(worst, r["max_abs_err"])
        log(f"  decode {name}: err {r['max_abs_err']:.3e}")
    for shape, name in ((group12, "group 12 bf16"),
                        (group48, "group 48 bf16")):
        r = dense_decode_case(torch, timer, gen, dtype=bf16, timed=True,
                              **shape)
        worst = max(worst, r["max_abs_err"])
        log(f"  decode {name} {r['shape']}: err {r['max_abs_err']:.3e} "
            f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms sdpa "
            f"{r['library_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})" + device_note(r))
    # qwen3-8b's attention widths over a 32k cache: 268 MB per tensor
    long = dense_decode_case(torch, timer, gen, B=4, Hq=32, Hkv=8, hd=128,
                             S=32768, dtype=bf16, timed=True, sink=False)
    worst = max(worst, long["max_abs_err"])
    log(f"  decode long bf16 {long['shape']}: err {long['max_abs_err']:.3e} "
        f"kernel {long['ms']:.4f} ms plain {long['plain_ms']:.4f} ms sdpa "
        f"{long['library_ms']:.4f} ms bound {long['bound_ms']:.4f} ms "
        f"({long['bound_by']})" + device_note(long))
    log("  decode outputs on the sink views bitwise equal to the paged decode "
        "kernel's; a NaN key reaches its row")
    dec["max_abs_err"] = worst
    results["decode_attention"] = dec
    torch.cuda.empty_cache()
    return results


# -- phase 15: the fused SwiGLU kernel -----------------------------------------
# In bf16 the kernel and the plain version each round the hidden tile from
# their own f32 sums, which differ in the last bits (another summation
# order): a hidden value that close to a bf16 rounding boundary rounds the
# other way, one bf16 step, and moves output k by that step times |Wd_fk|.
# How many such values a row holds grows with the widths, so the bf16 gates
# account for them exactly.  The kernel's own hidden values are read back by
# running it on the same x, Wg and Wu with a Wd that selects D hidden
# columns (one 1 per output column): each output is then one hidden value
# plus exact zeros, and the hidden tile is computed as in the full call.
# Gates: each of those values within one bf16 step of the float64 hidden;
# the output within one output rounding step (phase 3's rule) of the plain
# down product of the kernel's hidden values, and of ``fused_swiglu_plain``
# plus ``|h_kernel - h_plain| @ |Wd|``.  Printed per shape: the most hidden
# values per row that the plain version and the kernel round off the
# float64 value, and the largest |kernel - plain| over one output step plus
# one worst-case hidden flip (2**-7 max|h_row| max|Wd_col|).


def kernel_hidden(fused_swiglu, torch, x, wg, wu):
    """The kernel's own rounded hidden values (M, F), read back through a
    down projection that selects D hidden columns per call."""
    D, F = wg.shape
    parts = []
    for f0 in range(0, F, D):
        n = min(D, F - f0)
        sel = torch.zeros((F, D), dtype=x.dtype, device=x.device)
        sel[f0:f0 + n, :n] = torch.eye(n, dtype=x.dtype, device=x.device)
        parts.append(fused_swiglu(x, wg, wu, sel)[:, :n])
    return torch.cat(parts, 1)


def swiglu_case(torch, timer, gen, ffn, M, dtype, timed):
    from repro_torch.kernels.fused_swiglu import (
        fused_swiglu, fused_swiglu_plain)
    from repro_torch.kernels.ref import fused_swiglu_ref
    import torch.nn.functional as F

    wg, wu, wd = (ffn[n].to(dtype) for n in ("w_gate", "w_up", "w_down"))
    D, Fh = wg.shape
    x = torch.randn((M, D), generator=gen, device="cuda").to(dtype)
    got = fused_swiglu(x, wg, wu, wd)
    want = fused_swiglu_plain(x, wg, wu, wd)
    oracle = fused_swiglu_ref(x, wg, wu, wd)
    torch.cuda.synchronize()
    require(got.shape == (M, D) and bool(torch.isfinite(got).all()),
            "fused_swiglu: output not finite or of the wrong shape")
    g_, w_ = got.float(), want.float()
    err = (g_ - w_).abs()
    if dtype == torch.float32:
        require(bool((err <= 1e-4).all()),
                f"fused_swiglu f32: max |kernel - plain| {err.max().item():.3e}"
                " > 1e-4")
        over_step = 0
    else:
        xf, wgf, wuf, wdf = (a.float() for a in (x, wg, wu, wd))
        g, u = xf @ wgf, xf @ wuf
        h_plain = (g * torch.sigmoid(g) * u).to(dtype).float()
        x64 = x.double()
        g64 = x64 @ wg.double()
        h64 = g64 * torch.sigmoid(g64) * (x64 @ wu.double())
        h_exact = h64.to(dtype).float()
        del g64, h64
        h_kern = kernel_hidden(fused_swiglu, torch, x, wg, wu).float()
        h_step = TOL_BF16[0] + TOL_BF16[1] * h_exact.abs()
        bad = (h_kern - h_exact).abs() > h_step
        require(not bool(bad.any()),
                f"fused_swiglu bf16: {int(bad.sum())} hidden values more than "
                "one bf16 step off the float64 hidden")
        flips = {"plain": int((h_plain != h_exact).sum(1).max()),
                 "kernel": int((h_kern != h_exact).sum(1).max()),
                 "kernel_vs_plain": int((h_kern != h_plain).sum(1).max())}
        step = TOL_BF16[0] + TOL_BF16[1] * w_.abs()
        own = (h_kern @ wdf).to(dtype).float()
        bad = (g_ - own).abs() > TOL_BF16[0] + TOL_BF16[1] * own.abs()
        require(not bool(bad.any()),
                f"fused_swiglu bf16: {int(bad.sum())} outputs more than one "
                "bf16 step off the plain down product of its hidden values")
        moved = (h_kern - h_plain).abs() @ wdf.abs()
        bad = err > step + moved
        require(not bool(bad.any()),
                f"fused_swiglu bf16: |kernel - plain| "
                f"{err[bad].max().item() if bad.any() else 0:.3e} over one "
                f"bf16 step plus the move of the hidden values that differ "
                f"at {int(bad.sum())} outputs")
        one_flip = (2.0 ** -7 * h_exact.abs().amax(1, keepdim=True)
                    * wdf.abs().amax(0, keepdim=True))
        flips["err_over_step_plus_one_flip"] = (
            err / (step + one_flip)).max().item()
        over_step = int((err > step).sum())
        o_ = oracle.float()
        require(bool(((g_ - o_).abs() <= 0.1 + 0.1 * o_.abs()).all()),
                "fused_swiglu bf16: outside 5 x 2e-2 of fused_swiglu_ref")
    r = {"max_abs_err": err.max().item(), "over_step": over_step,
         "ref_err": (g_ - oracle.float()).abs().max().item()}
    if dtype != torch.float32:
        r["flips"] = flips
    if not timed:
        return r
    ms = timer(lambda: fused_swiglu(x, wg, wu, wd))
    if dtype == torch.bfloat16:
        # device time of each of the kernel's two GEMMs (torch.profiler)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fused_swiglu(x, wg, wu, wd)
            torch.cuda.synchronize()
        r["gemm_us"] = {e.key.split("(")[0].replace("void ", ""):
                        e.device_time_total / e.count
                        for e in prof.key_averages()
                        if e.device_type.name == "CUDA" and "gemm" in e.key}
    plain_ms = timer(lambda: fused_swiglu_plain(x, wg, wu, wd))
    lib_ms = timer(lambda: (F.silu(x @ wg) * (x @ wu)) @ wd)
    esz = x.element_size()
    n_bytes = (2 * M * D + 3 * D * Fh) * esz
    rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    b_ms, b_by = bound_ms(n_bytes, 6 * M * D * Fh, rate)
    r.update({"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
              "bound_ms": b_ms, "bound_by": b_by})
    return r


def swiglu_phase(torch, ffn0):
    """Phase 15: ``fused_swiglu`` on full-width qwen1.5-0.5b's layer-0 FFN
    weights (``ffn0``) at M in {16, 256, 2048}, bf16 and f32, and at
    qwen3-8b's FFN widths (seeded weights) at M = 256 in bf16; every case
    timed."""
    from repro_torch.models import layers as L

    gen = torch.Generator(device="cuda").manual_seed(15)
    timer = Timer(torch)
    results = {}
    cases = [(ffn0, "qwen1.5-0.5b layer 0", M, dtype)
             for dtype in (torch.bfloat16, torch.float32)
             for M in (16, 256, 2048)]
    ffn8b = L.init_ffn(gen, 4096, 12288, torch.bfloat16, "cuda")
    cases.append((ffn8b, "qwen3-8b widths", 256, torch.bfloat16))
    for ffn, name, M, dtype in cases:
        r = swiglu_case(torch, timer, gen, ffn, M, dtype, timed=True)
        D, Fh = ffn["w_gate"].shape
        r["shape"] = f"{name} M={M} D={D} F={Fh} {str(dtype)[6:]}"
        results[(name, M, dtype)] = r
        log(f"  fused_swiglu {r['shape']}: max |kernel - plain| "
            f"{r['max_abs_err']:.3e} (over one bf16 step at {r['over_step']} "
            f"outputs), max |kernel - ref| {r['ref_err']:.3e}; kernel "
            f"{r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms library "
            f"{r['library_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
        if "gemm_us" in r:
            log("    device time per call: " + ", ".join(
                f"{k} {v:.1f} us" for k, v in r["gemm_us"].items()))
        if "flips" in r:
            f = r["flips"]
            log(f"    hidden values per row rounded off the float64 value: "
                f"plain <= {f['plain']}, kernel <= {f['kernel']}; kernel vs "
                f"plain differ in <= {f['kernel_vs_plain']}; max |kernel - "
                f"plain| / (one step + one worst-case flip) "
                f"{f['err_over_step_plus_one_flip']:.4f}")
    del ffn8b
    torch.cuda.empty_cache()
    head = dict(results[("qwen1.5-0.5b layer 0", 2048, torch.bfloat16)])
    head["max_abs_err"] = max(r["max_abs_err"] for r in results.values()
                              if "bfloat16" in r["shape"])
    return {"fused_swiglu": head}


# -- phase 16: the standalone kernels through their entry points --------------
def standalone_phase(torch, ffn0):
    """``decode_attention`` and ``fused_swiglu`` run on no serve path (as in
    the reference); a user calls them from their modules.  One call of each,
    at the dense serve's decode shape and full-width qwen1.5-0.5b's FFN at
    M = 256, must launch exactly its kernel and nothing else, and a second
    call must give the same bits; returns the first calls' launch counts."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.fused_swiglu import fused_swiglu

    gen = torch.Generator(device="cuda").manual_seed(16)
    k, v = dense_cache(torch, gen, B=16, S=512, Hkv=16, hd=64,
                       dtype=torch.bfloat16)
    q = torch.randn((16, 16, 64), generator=gen, device="cuda").to(k.dtype)
    kv_lens = torch.randint(1, 513, (16,), generator=gen,
                            device="cuda").to(torch.int32)
    w = [ffn0[n] for n in ("w_gate", "w_up", "w_down")]
    x = torch.randn((256, w[0].shape[0]), generator=gen,
                    device="cuda").to(w[0].dtype)
    torch.cuda.synchronize()
    zero_launches()
    got_d = decode_attention(q, k, v, kv_lens)
    got_s = fused_swiglu(x, *w)
    torch.cuda.synchronize()
    launches = read_launches()
    want = {n: int(n in ("decode_attention", "fused_swiglu"))
            for n in launches}
    require(launches == want, f"standalone kernels launched {launches}")
    require(same_bits(got_d, decode_attention(q, k, v, kv_lens))
            and same_bits(got_s, fused_swiglu(x, *w)),
            "a standalone kernel's second call differs from its first")
    log(f"  decode_attention and fused_swiglu launched "
        f"{ {n: c for n, c in launches.items() if c} } and nothing else")
    return launches


# -- phases 17-18: the dense KV layout served ------------------------------------
PAGED_ATTENTION = ("paged_decode_attention", "paged_prefill_attention",
                   "paged_decode_attention_fused",
                   "paged_prefill_attention_fused")


def dense_serve_phase(torch, baseline, swap=False):
    """``serve --full --dense-kv`` (static budget, recompute): every request
    finishes, ``chunked_prefill_attention`` runs exactly once per layer per
    round -- every bucket, C = 1 included -- and no paged attention kernel
    runs.  With ``swap``: ``SWAP_FLAGS``, where
    swap-outs happen and are all restored through plain slot-row copies, no
    swap kernel launches, nothing stays staged and the pool's invariants
    hold."""
    from repro_torch.engine.engine import serve
    from repro_torch.launch import serve as serve_cli

    flags = ["--full", "--dense-kv"] + (SWAP_FLAGS if swap else [])
    args = serve_cli.build_parser().parse_args(flags)
    engine, sched, kv_pool, reqs = serve_cli.build(args)  # binds + warms up
    cfg = engine.model_cfg
    require(not engine.cfg.paged_kv and engine.block_tables is None
            and tuple(engine.cache) == ("k", "v")
            and engine.cache["k"].shape == (
                cfg.n_layers, 16, 513, cfg.n_kv_heads, cfg.resolved_head_dim),
            f"not a dense cache: {[tuple(t.shape) for t in engine.cache.values()]}")
    torch.cuda.synchronize()
    engine.bucket_rounds.clear()
    zero_launches()
    res = serve(reqs, sched, engine, kv_pool=kv_pool)
    torch.cuda.synchronize()
    launches = read_launches()

    toks = check_outputs(res, reqs, cfg.vocab_size)
    rounds = sum(engine.bucket_rounds.values())
    require(launches["chunked_prefill_attention"] == cfg.n_layers * rounds,
            f"chunked prefill launches {launches} != {cfg.n_layers} x "
            f"{rounds} rounds")
    require(engine.bucket_rounds.get(1, 0) > 0,
            f"no pure-decode round: {engine.bucket_rounds}")
    others = [n for n in launches if n != "chunked_prefill_attention"]
    require(all(launches[n] == 0 for n in others),
            f"another kernel ran on the dense path: {launches}")
    st = sched.stats
    if swap:
        require(st.swap_preemptions > 0, "no swap preemption happened")
        require(st.swap_restores == st.swap_preemptions,
                f"{st.swap_restores} restores != {st.swap_preemptions} "
                "swap-outs")
        require(not kv_pool.swapped_requests(), "a request is still staged")
        kv_pool.check_invariants()
    log(f"  served {res.report.n_finished}/{res.report.n_total} requests, "
        f"{len(toks)} output tokens in {res.wall_s:.3f} s over {res.rounds} "
        f"rounds (by chunk bucket: {dict(sorted(engine.bucket_rounds.items()))})"
        f"; {st.preemptions} preemptions, {st.swap_preemptions} swapped out "
        f"({st.swap_restores} restored); output tok/s "
        f"{len(toks) / res.wall_s:.1f}; mean TTFT "
        f"{res.report.ttft['mean'] * 1e3:.2f} ms P99 E2E "
        f"{res.report.e2e['p99'] * 1e3:.2f} ms")
    log(f"  kernel launches on the dense path: "
        f"{ {n: c for n, c in launches.items() if c} }")
    note_tokens(reqs, res.outputs, baseline)
    return launches


# -- phase 19: the NaN guard -----------------------------------------------------
def nan_guard_phase(torch, layout):
    """``serve --full --nan-guard`` on the ``layout`` engine under
    ``serve(robustness=...)`` with a ``nan_logits`` fault at the second
    decode invocation: exactly the poisoned request is shed, for
    ``"numerics"``; every other request finishes with its full token count;
    nothing stays poisoned, and every value of the engine's KV cache is
    finite at the end (releasing the victim zeroed what the poison and its
    round wrote, and no kernel left a NaN in a sink)."""
    from repro_torch.engine.engine import serve
    from repro_torch.launch import serve as serve_cli
    from repro_torch.robustness import (
        FaultInjector, FaultPlan, FaultSpec, RobustnessConfig)

    flags = {"split": [], "fused": ["--kv-layout", "fused"],
             "dense": ["--dense-kv"]}[layout]
    args = serve_cli.build_parser().parse_args(["--full", "--nan-guard"]
                                               + flags)
    engine, sched, kv_pool, reqs = serve_cli.build(args)  # binds + warms up
    require(engine.cfg.nan_guard, "--nan-guard did not reach the engine")
    injector = FaultInjector(FaultPlan((FaultSpec("nan_logits", nth=2),)))
    torch.cuda.synchronize()
    zero_launches()
    res = serve(reqs, sched, engine, kv_pool=kv_pool,
                robustness=RobustnessConfig(injector=injector))
    torch.cuda.synchronize()
    launches = read_launches()
    fired = [f for f in injector.fired if f.site == "nan_logits"]
    require(len(fired) == 1, f"nan_logits fired {len(fired)} times")
    victim = fired[0].req_id
    shed = {r.req_id: r.shed_reason for r in reqs if r.shed_reason}
    require(shed == {victim: "numerics"},
            f"shed {shed}, expected only the victim {victim} for numerics")
    require(res.robustness.quarantined == 1 and res.robustness.crash_unwinds == 0,
            f"quarantined {res.robustness.quarantined}, crash unwinds "
            f"{res.robustness.crash_unwinds}")
    short = [r.req_id for r in reqs if r.req_id != victim and (
        r.finish_time is None
        or len(res.outputs.get(r.req_id, [])) != r.max_new_tokens)]
    require(not short, f"requests other than the victim unfinished: {short}")
    require(not engine._poisoned, f"still poisoned: {engine._poisoned}")
    for name, cache in engine.cache.items():
        require(bool(torch.isfinite(cache).all()),
                f"a non-finite value is left in cache[{name!r}]")
    kv_pool.check_invariants()
    attn = ("chunked_prefill_attention",) if layout == "dense" else (
        attention_names(layout)[0])
    require(min(launches[n] for n in attn) > 0,
            f"an attention kernel of the {layout} path did not run: {launches}")
    victim_req = next(r for r in reqs if r.req_id == victim)
    log(f"  {layout}: request {victim} poisoned, quarantined after "
        f"{len(res.outputs[victim])} of {victim_req.max_new_tokens} tokens "
        f"(shed_reason numerics); the other {len(reqs) - 1} finished; "
        f"nothing poisoned left, every cache value finite; served in "
        f"{res.wall_s:.3f} s over {res.rounds} rounds")


# -- phase 20: the decode kernel at granite-34b's group, served ----------------
GRANITE_LAYERS = 2      # of granite-34b's 88: the widths stay published


def build_at_width(torch, cfg, params=None, cuda_graphs=True):
    """What ``serve --full --arch`` builds for ``cfg`` (the split layout,
    greedy, 8 of the serve workload's requests), bound to its pool and
    warmed up: (engine, pool, args).  ``params``: another engine's weights,
    shared."""
    from repro_torch.engine.engine import TorchEngine
    from repro_torch.engine.kv_cache import pool_for_model
    from repro_torch.launch import serve as serve_cli

    args = serve_cli.build_parser().parse_args(
        ["--full", "--arch", cfg.name, "--n-requests", "8"])
    engine = TorchEngine(cfg, serve_cli._engine_cfg(args), params=params,
                         device="cuda", cuda_graphs=cuda_graphs)
    kv_pool = pool_for_model(cfg, n_blocks=args.kv_blocks)
    engine.bind_kv_pool(kv_pool)
    engine.warmup()
    torch.cuda.synchronize()
    return engine, kv_pool, args


def gated_serve(torch, engine, kv_pool, args):
    """Serve the workload of ``args`` on a built engine.  Every request must
    finish with its full token count; the decode kernel runs ``n_layers``
    times per pure-decode round and the prefill kernel ``n_layers`` times
    per round with C > 1.  Returns (result, requests, output tokens, kernel
    launches, each round's span on the device by chunk bucket: CUDA events
    around its dispatch, as phase 21 takes them)."""
    from repro_torch.engine.engine import serve
    from repro_torch.launch import serve as serve_cli

    cfg = engine.model_cfg
    sched = serve_cli.build_scheduler(args)
    reqs = serve_cli.workload(args, cfg)
    spans = []
    dispatch = engine.dispatch

    def timed(batch):
        before = dict(engine.bucket_rounds)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = dispatch(batch)
        end.record()
        C = next(c for c, n in engine.bucket_rounds.items()
                 if n != before.get(c, 0))
        spans.append((C, start, end))
        return out

    engine.dispatch = timed
    torch.cuda.synchronize()
    engine.bucket_rounds.clear()
    zero_launches()
    try:
        res = serve(reqs, sched, engine, kv_pool=kv_pool)
        torch.cuda.synchronize()
    finally:
        del engine.dispatch
    launches = read_launches()
    toks = check_outputs(res, reqs, cfg.vocab_size)
    decode_rounds = engine.bucket_rounds.get(1, 0)
    mixed_rounds = sum(n for c, n in engine.bucket_rounds.items() if c > 1)
    require(decode_rounds > 0, f"no pure-decode round: {engine.bucket_rounds}")
    require(launches["paged_decode_attention"] == cfg.n_layers * decode_rounds,
            f"decode launches {launches} != {cfg.n_layers} x {decode_rounds} "
            "pure-decode rounds")
    require(launches["paged_prefill_attention"] == cfg.n_layers * mixed_rounds,
            f"prefill launches {launches} != {cfg.n_layers} x {mixed_rounds} "
            "rounds with C > 1")
    by_bucket = {}
    for C, a, b in spans:
        by_bucket.setdefault(C, []).append(a.elapsed_time(b))
    kv_pool.reset()
    return res, reqs, toks, launches, by_bucket


def log_served(res, toks, engine, launches) -> None:
    log(f"  served {res.report.n_finished}/{res.report.n_total} requests, "
        f"{len(toks)} output tokens in {res.wall_s:.3f} s over {res.rounds} "
        f"rounds (by chunk bucket: {dict(sorted(engine.bucket_rounds.items()))})"
        f"; output tok/s {len(toks) / res.wall_s:.1f}")
    log(f"  kernel launches: { {n: c for n, c in launches.items() if c} }")


def granite_serve_phase(torch):
    """A short serve through ``TorchEngine`` at granite-34b's published
    widths -- d_model 6144, 48 query heads over 1 KV head (MQA: a decode
    group of 48), hd 128, d_ff 24,576, vocab 49,152 -- with ``n_layers`` cut
    to GRANITE_LAYERS, seeded bf16 weights, the split layout, greedy, 8 of
    the serve workload's requests, gated by ``gated_serve``."""
    import dataclasses

    from repro_torch.configs import get_config

    full = get_config("granite-34b")
    cfg = dataclasses.replace(full, n_layers=GRANITE_LAYERS)
    log(f"  {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads} query heads over "
        f"{cfg.n_kv_heads} KV head(s), hd {cfg.resolved_head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}; reduced: n_layers "
        f"{full.n_layers} -> {cfg.n_layers}")
    engine, kv_pool, args = build_at_width(torch, cfg)
    res, _, toks, launches, _ = gated_serve(torch, engine, kv_pool, args)
    log_served(res, toks, engine, launches)
    del engine, kv_pool


# -- phase 21: the compiled round ---------------------------------------------
LAYOUT_FLAGS = {"split": [], "fused": ["--kv-layout", "fused"],
                "dense": ["--dense-kv"]}
# the bitwise engines' context: 1,056 keys of pages a slot, so a decode
# round merges three splits of 512 keys
GRAPH_MAX_CONTEXT = 1024
GRAPH_PAIRS = 3         # interleaved graph / eager serve pairs, split
DRAWS = 8               # replays of one sampled round


def graph_pool_bytes(torch, engine) -> int:
    """Bytes of the segments in the engine's graph memory pool."""
    pool = tuple(engine._graph_pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


def round_arrays(gen, B, C, lens, max_len, vocab):
    """One round's packed inputs (tokens (B, C), chunk lengths, use_last,
    sample_mask, as ``TorchEngine._inputs`` packs them): slot 0 idle, slots
    1-2 decodes from ``last_token``, slots 3-4 decodes of a staged id, the
    rest chunks of 1..C tokens (1 at C = 1), none past ``max_len``;
    decodes and every other chunk sampled."""
    import numpy as np
    chunk = gen.integers(1, C + 1, B)
    chunk[0], chunk[1:5] = 0, 1
    chunk = np.minimum(chunk, max_len - lens).astype(np.int32)
    tokens = np.zeros((B, C), np.int32)
    for b in range(B):
        tokens[b, :chunk[b]] = gen.integers(1, vocab, chunk[b])
    use_last = np.zeros(B, np.int32)
    use_last[1:3] = 1
    tokens[1:3, 0] = 0
    sample = np.zeros(B, np.int32)
    sample[1:5] = 1
    sample[5::2] = 1
    sample[chunk == 0] = 0
    return np.concatenate([tokens.reshape(-1), chunk, use_last, sample]), chunk


def bitwise_round_case(torch, layout):
    """Two full-width engines of ``layout`` from the same seed, one with
    CUDA graphs and one eager, through ``bitwise_rounds`` (lengths up to 560
    of 1,024: at C = 1 again at the end, past 1,024 keys, three decode
    splits merged).  Returns (graphs captured, warm-up s of the graph
    engine, capture s, pool bytes)."""
    import dataclasses

    from repro_torch.engine.engine import TorchEngine
    from repro_torch.launch import serve as serve_cli

    args = serve_cli.build_parser().parse_args(["--full"]
                                               + LAYOUT_FLAGS[layout])
    cfg = serve_cli._model_cfg(args)
    ecfg = dataclasses.replace(serve_cli._engine_cfg(args),
                               max_context=GRAPH_MAX_CONTEXT)
    engines, warm_s = [], []
    for on in (True, False):
        t0 = time.perf_counter()
        eng = TorchEngine(cfg, ecfg, device="cuda", cuda_graphs=on)
        eng.warmup()
        torch.cuda.synchronize()
        warm_s.append(time.perf_counter() - t0)
        engines.append(eng)
    g, e = engines
    require(same_bits(g.params["embed"], e.params["embed"]),
            f"{layout}: the two engines' seeded weights differ")
    bitwise_rounds(torch, g, e, layout, GRAPH_MAX_CONTEXT, 560, (540, 515))
    out = (len(g.graphs), warm_s[0], warm_s[1],
           sum(gr.capture_s for gr in g.graphs.values()),
           graph_pool_bytes(torch, g))
    del g, e, engines
    torch.cuda.empty_cache()
    return out


def bitwise_rounds(torch, g, e, tag, max_len, lens_hi, long):
    """A graph engine ``g`` and an eager engine ``e`` of one config given
    one state (the same random K/V in every page or row, permuted block
    tables, ragged lengths up to ``lens_hi`` with slots 1 and 2 at
    ``long``, random ``last_token``): at every bucket, and at C = 1 again
    at the end, one replay against one eager ``_step`` on the same inputs;
    the sampled ids, ``lens``, ``last_token`` and every cache tensor must
    agree BITWISE, and ``g`` must hold one graph per bucket."""
    import numpy as np

    ecfg, cfg = g.cfg, g.model_cfg
    require(len(g.graphs) == len(ecfg.chunk_buckets) and not e.graphs,
            f"{tag}: {len(g.graphs)} graphs captured for "
            f"{len(ecfg.chunk_buckets)} buckets, {len(e.graphs)} eager")
    B = ecfg.n_slots
    gen = np.random.default_rng(21)
    tgen = torch.Generator(device="cuda").manual_seed(21)
    for name, cache in g.cache.items():
        for l in range(cache.shape[0]):
            vals = torch.randn(cache.shape[1:], generator=tgen, device="cuda",
                               dtype=cache.dtype)
            cache[l].copy_(vals)
            e.cache[name][l].copy_(vals)
    lens = gen.integers(0, lens_hi + 1, B).astype(np.int32)
    lens[0], (lens[1], lens[2]) = 0, long
    if ecfg.paged_kv:
        tables = gen.permutation(g._n_phys - 1)[: B * g.max_pages]
        for eng in (g, e):
            eng._bt_host[:] = tables.reshape(B, g.max_pages)
            eng._bt_len[:] = g.max_pages
            eng._copy_in(eng.block_tables, eng._bt_host)
    last = gen.integers(1, cfg.vocab_size, B).astype(np.int32)
    for eng in (g, e):
        eng._copy_in(eng.lens, lens)
        eng._copy_in(eng.last_token, last)
    for C in ecfg.chunk_buckets + (1,):
        arr, chunk = round_arrays(gen, B, C, lens, max_len, cfg.vocab_size)
        g._copy_in(g._inputs(C), arr)
        got = g.graphs[C].replay()
        e._copy_in(e._inputs(C), arr)
        want = e._packed_step(e._inputs(C), C)
        lens = lens + chunk
        for what, a, b in (("sampled ids", got[0], want[0]),
                           ("lens", g.lens, e.lens),
                           ("last_token", g.last_token, e.last_token)):
            require(same_bits(a, b),
                    f"{tag} C={C}: the replay's {what} differ from the "
                    "eager step's")
        for name in g.cache:
            require(same_bits(g.cache[name], e.cache[name]),
                    f"{tag} C={C}: cache[{name!r}] differs from the "
                    "eager step's")
        require(bool((g.lens.cpu().numpy() == lens).all()),
                f"{tag} C={C}: lens {g.lens.tolist()} != {lens.tolist()}")
    torch.cuda.synchronize()


def sampled_replays(torch):
    """``temperature=1.0`` at full width, split, with graphs: the sampler's
    generator is registered with each graph, so DRAWS replays of one idle
    round (nothing written, ``lens`` and ``last_token`` unchanged) draw
    DRAWS different rows of ids, not one frozen draw.  Returns the number
    of distinct rows."""
    import numpy as np
    from repro_torch.engine.engine import EngineConfig, TorchEngine
    from repro_torch.engine.sampler import SamplerConfig
    from repro_torch.launch import serve as serve_cli

    args = serve_cli.build_parser().parse_args(["--full"])
    cfg = serve_cli._model_cfg(args)
    eng = TorchEngine(cfg, EngineConfig(
        n_slots=16, max_context=512, sampler=SamplerConfig(temperature=1.0)),
        device="cuda")
    eng.warmup()
    require(len(eng.graphs) == len(eng.cfg.chunk_buckets),
            f"sampling engine: {len(eng.graphs)} graphs")
    idle = np.zeros(eng._inputs(1).numel(), np.int32)
    lens0, last0 = eng.lens.clone(), eng.last_token.clone()
    draws = []
    for _ in range(DRAWS):
        eng._copy_in(eng._inputs(1), idle)
        draws.append(eng.graphs[1].replay()[0].clone())
    torch.cuda.synchronize()
    rows = {tuple(d.tolist()) for d in draws}
    require(all(0 <= t < cfg.vocab_size for r in rows for t in r),
            "a sampled id is outside the vocabulary")
    require(same_bits(eng.lens, lens0) and same_bits(eng.last_token, last0),
            "an idle round changed lens or last_token")
    require(len(rows) == DRAWS,
            f"{DRAWS} replays of one sampled round drew {len(rows)} distinct "
            "rows of ids (a frozen draw repeats)")
    del eng
    torch.cuda.empty_cache()
    return len(rows)


def build_served(torch, layout, cuda_graphs):
    """What ``serve_cli.build`` does for ``--full`` and ``layout`` (no
    LPRS), with or without CUDA graphs: (engine, pool, args)."""
    from repro_torch.engine.engine import TorchEngine
    from repro_torch.engine.kv_cache import pool_for_model
    from repro_torch.launch import serve as serve_cli

    args = serve_cli.build_parser().parse_args(["--full"]
                                               + LAYOUT_FLAGS[layout])
    cfg = serve_cli._model_cfg(args)
    engine = TorchEngine(cfg, serve_cli._engine_cfg(args), device="cuda",
                         cuda_graphs=cuda_graphs)
    kv_pool = pool_for_model(cfg, n_blocks=args.kv_blocks)
    engine.bind_kv_pool(kv_pool)
    engine.warmup()
    torch.cuda.synchronize()
    return engine, kv_pool, args


def timed_serve(torch, engine, kv_pool, args):
    """Phase 5's serve on a built engine, then the pool reset for the next:
    its metrics, the host ms per round spent in ``schedule()``, in the
    engine's input copies (block tables and the packed round) and in
    ``dispatch`` as a whole, the round's span on the device (CUDA events
    before and after each dispatch: from the end of the work before it to
    the end of the round's copies and step; its device time where one
    launch enqueues it, as a graph's replay, and the host's enqueue time
    where the host is the slower, as eagerly), and the greedy outputs."""
    from repro_torch.engine.engine import serve
    from repro_torch.launch import serve as serve_cli
    from repro_torch.tracing import Tracer

    sched = serve_cli.build_scheduler(args)
    reqs = serve_cli.workload(args, engine.model_cfg)
    spent = {"schedule": 0.0, "copy_in": 0.0, "dispatch": 0.0}

    def timed(key, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            spent[key] += time.perf_counter() - t0
            return out
        return call

    events = []

    def on_device(fn):
        def call(batch):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(batch)
            end.record()
            events.append((start, end))
            return out
        return call

    sched.schedule = timed("schedule", sched.schedule)
    engine._copy_in = timed("copy_in", engine._copy_in)
    engine.dispatch = on_device(timed("dispatch", engine.dispatch))
    tracer = Tracer()
    torch.cuda.synchronize()
    try:
        res = serve(reqs, sched, engine, kv_pool=kv_pool, tracer=tracer)
        torch.cuda.synchronize()
    finally:
        # each wrapper holds a bound method of the object it is set on: a
        # reference cycle, which for the scheduler (its hooks are the
        # engine's bound methods) would keep the engine alive until the
        # cyclic collector runs
        del engine._copy_in, engine.dispatch, sched.schedule
    toks = check_outputs(res, reqs, engine.model_cfg.vocab_size)
    kv_pool.reset()
    rep = res.report
    per_round = {k: v * 1e3 / res.rounds for k, v in spent.items()}
    device_ms = sum(a.elapsed_time(b) for a, b in events)
    return {"tok_s": len(toks) / res.wall_s,
            "ttft_ms": rep.ttft["mean"] * 1e3,
            "p99_e2e_ms": rep.e2e["p99"] * 1e3,
            "bubble_ms": statistics.mean(res.host_bubble_ms),
            "replay_ms": replay_ms(tracer),
            "rounds": res.rounds, "wall_s": res.wall_s,
            "span_ms": device_ms / res.rounds,
            "span_share": device_ms / (res.wall_s * 1e3),
            **{f"{k}_ms": v for k, v in per_round.items()},
            "outputs": [res.outputs[r.req_id] for r in reqs]}


def spread(xs) -> str:
    return (f"{statistics.mean(xs):.3f} (min {min(xs):.3f} max "
            f"{max(xs):.3f})")


def serve_pairs(torch, layout, n_pairs):
    """``n_pairs`` interleaved pairs (graph, eager, eager, graph, ...) of
    phase 5's serve on the ``layout`` engine built both ways; prints each
    metric's mean and range per side and how many requests' greedy tokens
    agree (not gated: the pipelined loop's rounds depend on timing, so bf16
    batches may differ).  Returns the runs by side."""
    built = {on: build_served(torch, layout, on) for on in (True, False)}
    runs = {True: [], False: []}
    for i in range(n_pairs):
        for on in ((True, False) if i % 2 == 0 else (False, True)):
            runs[on].append(timed_serve(torch, *built[on]))
    for on in (True, False):
        r = runs[on]
        log(f"  {layout} {'graph' if on else 'eager'} x{len(r)}: output "
            f"tok/s {spread([x['tok_s'] for x in r])}; mean TTFT ms "
            f"{spread([x['ttft_ms'] for x in r])}; P99 E2E ms "
            f"{spread([x['p99_e2e_ms'] for x in r])}; mean bubble_ms "
            f"{spread([x['bubble_ms'] for x in r])}; mean engine.replay "
            f"span ms {spread([x['replay_ms'] for x in r])}")
        log(f"    per round, host ms: schedule() "
            f"{spread([x['schedule_ms'] for x in r])}; input copies "
            f"{spread([x['copy_in_ms'] for x in r])}; dispatch "
            f"{spread([x['dispatch_ms'] for x in r])}; device span ms "
            f"{spread([x['span_ms'] for x in r])}; wall ms "
            f"{spread([x['wall_s'] * 1e3 / x['rounds'] for x in r])}; "
            f"spans {spread([x['span_share'] for x in r])} of the wall; "
            f"rounds {[x['rounds'] for x in r]}")
    same = sum(a == b for a, b in zip(runs[True][0]["outputs"],
                                      runs[False][0]["outputs"]))
    log(f"  {layout}: greedy outputs of the first graph serve equal to the "
        f"first eager serve's for {same} of {len(runs[True][0]['outputs'])} "
        "requests (printed, not gated: bf16)")
    del built
    torch.cuda.empty_cache()
    return runs


# a dropped engine's device memory, back without the cyclic collector: what
# may stay is per-stream state the process keeps (a cuBLAS workspace per
# stream the engine's capture ran on, the decode kernels' ticket buffer)
FREED_SLACK = 64 << 20


def freed_without_gc(torch):
    """Phase 21's memory gate: a split engine with CUDA graphs built, warmed
    up (its graphs captured) and serving phase 5's workload, then dropped
    with ``del`` while the cyclic collector is off, must return
    ``torch.cuda.memory_allocated()`` to within FREED_SLACK of its level
    before the build: nothing of it is held in a reference cycle.  On a
    miss, the collector's haul is printed by type before the run fails.
    Returns the bytes (before, with the engine, after)."""
    import collections

    torch.cuda.synchronize()
    gc.disable()
    try:
        before = torch.cuda.memory_allocated()
        engine, kv_pool, args = build_served(torch, "split", True)
        timed_serve(torch, engine, kv_pool, args)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        del engine, kv_pool
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        if after - before > FREED_SLACK:
            gc.set_debug(gc.DEBUG_SAVEALL)
            gc.collect()
            kinds = collections.Counter(type(o).__name__ for o in gc.garbage)
            gc.set_debug(0)
            gc.garbage.clear()
            log(f"  in reference cycles: {kinds.most_common(20)}; "
                f"{torch.cuda.memory_allocated()} B allocated after a "
                "collection")
    finally:
        gc.enable()
    require(after - before <= FREED_SLACK,
            f"a dropped graph engine left {after - before} B allocated "
            f"({before} B before its build, {after} B after its del)")
    return before, held, after


def compiled_round_phase(torch):
    """Phase 21: the replayed round bitwise against the eager step at every
    bucket on split, fused and dense; the graphs per engine; a sampled
    round's replays drawing afresh; serve pairs with and without graphs;
    a dropped graph engine's memory back without the cyclic collector."""
    for layout in ("split", "fused", "dense"):
        n, warm_g, warm_e, cap_s, pool = bitwise_round_case(torch, layout)
        log(f"  {layout}: replays bitwise equal to the eager step at every "
            "bucket and at C=1 again (three decode splits merged): sampled "
            f"ids, lens, last_token, every cache tensor; {n} graphs "
            f"captured, warm-up {warm_g:.2f} s with graphs ({cap_s:.2f} s "
            f"in the captures) against {warm_e:.2f} s eager; graph pool "
            f"{pool} B")
    n = sampled_replays(torch)
    log(f"  temperature 1.0: {DRAWS} replays of one idle round drew {n} "
        "distinct rows of 16 ids (the generator advances per replay)")
    serve_pairs(torch, "split", GRAPH_PAIRS)
    serve_pairs(torch, "fused", 1)
    serve_pairs(torch, "dense", 1)
    before, held, after = freed_without_gc(torch)
    log(f"  memory gate: a split graph engine built, warmed up, served and "
        f"dropped with the cyclic collector off: {before} B allocated before "
        f"its build, {held} B with it, {after} B after its del "
        f"({after - before:+d} B; the gate is {FREED_SLACK} B)")


# -- phase 22: the MoE and VLM families served -------------------------------
ARCTIC_LAYERS = 2       # of arctic-480b's 35: 55.4 GB of bf16 weights
# the per-token check's inputs (B, S): a decode round (T = 16, capacity 1)
# and a C = 128 round (T = 2,048, capacity 40)
MOE_CHECKS = ((16, 1), (16, 128))


def param_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(param_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def round_bound(cfg, params, B, C):
    """The least time of one round of ``B`` slots at chunk bucket ``C`` on
    the card as the batched expert GEMMs ran it: the weights it must read
    once (every layer's, every expert included, the unembedding, and the
    embedding rows it gathers; KV bytes left out, a few percent here) over
    HBM, against its GEMMs' operations (every expert's capacity slots) over
    the bf16 peak.  The grouped expert kernels read only the experts a
    round reaches, so a MoE round may beat it: phase 22 prints the bound of
    the weights the data needs beside it.  (ms, "bytes" or "operations",
    bytes)."""
    from repro_torch.models import layers as L

    T, D = B * C, cfg.d_model
    esz = 2
    head = params["lm_head"] if "lm_head" in params else params["embed"]
    n_bytes = (param_bytes(params["layers"]) + head.numel() * esz
               + params["final_norm"].numel() * esz + T * D * esz)
    hd = cfg.resolved_head_dim
    per_layer = 2 * T * D * (2 * cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    lp = params["layers"][0]
    if "ffn" in lp:
        per_layer += 6 * T * D * cfg.d_ff
    if "moe" in lp:
        m = cfg.moe
        cap = L.moe_capacity(min(T, L.MOE_GROUP_SIZE), m.n_experts, m.top_k,
                             m.capacity_factor) * max(1, T // L.MOE_GROUP_SIZE)
        per_layer += 2 * T * D * m.n_experts + 6 * m.n_experts * cap * D * m.d_ff
    n_ops = cfg.n_layers * per_layer + 2 * B * head.numel()
    ms, by = bound_ms(n_bytes, n_ops)
    return ms, by, n_bytes


def log_rounds(cfg, params, by_bucket, B) -> None:
    """Each bucket's mean device span per round against its bound."""
    for C in sorted(by_bucket):
        xs = by_bucket[C]
        b_ms, b_by, n_bytes = round_bound(cfg, params, B, C)
        log(f"    C={C}: {len(xs)} rounds, device ms per round "
            f"{spread(xs)}; bound {b_ms:.3f} ms ({b_by}: {n_bytes / 1e9:.2f} "
            f"GB of weights); mean / bound {statistics.mean(xs) / b_ms:.2f}")


def counted_drops(torch, reqs_fn):
    """Run ``reqs_fn()`` (a serve on an EAGER engine) while counting,
    by chunk bucket, the real tokens' expert choices that the scatter
    dispatch drops at capacity and the experts that the kept ones reach:
    each round's MoE inputs (``moe_round``'s) routed again through the
    port's own routing and the reference's capacity order (``moe_route``,
    ``capacity_rows``).  Returns (reqs_fn's
    result, {C: (dropped, real choices, experts reached summed over the
    MoE layers of the bucket's rounds, those layer-rounds)})."""
    from repro_torch.models import layers as L

    counts = {}
    moe = L.moe_round

    def moe_rec(p, x, cfg, lane_mask, moe_counts=None, group_size=0):
        m = cfg.moe
        xg = L.moe_groups(x, group_size)
        G, t, _ = xg.shape
        _, top_idx = L.moe_route(p, xg, m.top_k)
        cap = L.moe_capacity(t, m.n_experts, m.top_k, m.capacity_factor)
        dest = L.capacity_rows(top_idx, m.n_experts, cap, "token")
        real = lane_mask.reshape(G, t, 1)
        dropped = dest == m.n_experts * G * cap
        reached = (torch.nn.functional.one_hot(top_idx, m.n_experts)
                   * (real & ~dropped)[..., None]).amax((0, 1, 2))
        c = counts.setdefault(x.shape[1], [])
        c.append(torch.stack([(dropped & real).sum(), real.sum() * m.top_k,
                              reached.sum()]))
        return moe(p, x, cfg, lane_mask, moe_counts, group_size)

    L.moe_round = moe_rec
    try:
        out = reqs_fn()
        torch.cuda.synchronize()
    finally:
        L.moe_round = moe
    return out, {C: tuple(int(v) for v in torch.stack(c).sum(0)) + (len(c),)
                 for C, c in counts.items()}


def capacity_slots(idx, E, cap, impl):
    """The reference's capacity walk, one (token, choice) at a time: each
    pair's slot in its expert, -1 where the expert is full.  ``scatter``:
    token-major over the flattened (token, choice) axis; ``onehot``: choice
    0 of every token first, the kept counts carried into choice 1."""
    import numpy as np
    T, K = idx.shape
    slot = np.full((T, K), -1, np.int64)
    if impl == "scatter":
        n = np.zeros(E, np.int64)
        for t in range(T):
            for j in range(K):
                e = idx[t, j]
                if n[e] < cap:
                    slot[t, j] = n[e]
                n[e] += 1
        return slot
    kept = np.zeros(E, np.int64)
    for j in range(K):
        run = np.zeros(E, np.int64)
        for t in range(T):
            e = idx[t, j]
            if kept[e] + run[e] < cap:
                slot[t, j] = kept[e] + run[e]
            run[e] += 1
        kept += np.bincount(idx[slot[:, j] >= 0, j], minlength=E)
    return slot


def moe_token_check(torch, p, cfg, B, S, impl, gen):
    """``moe_round`` (the engine round's MoE; ``impl`` "scatter" or
    "onehot": its capacity order and combine) on random bf16 rows x (B, S,
    D), every lane real, against the reference computed per token: the
    top-k of the f32 router probabilities on the host (largest first, the
    lowest index among equals), the renormalised weights and each impl's
    capacity walk (``capacity_slots``).  Gates: (1) the output BITWISE
    equal to the combine, in the impl's dtype rule, of the expert rows that
    the grouped kernels give on the reference's kept (token, choice) pairs
    (a layout built from the host's walk): routing, drops, the layout and
    the combine exact; (2) each kept row within one bf16 step (phase 3's
    rule; its 2e-2 cap, an attention output's size, replaced by a floor of
    2**-16 of the row's largest |y|, the f32 sums' own noise at these
    magnitudes) of the per-token SwiGLU (the tokens of one expert stacked
    in one GEMM: its rows are independent), plus the move of the hidden
    values that round differently (phase 15's accounting).  Returns a dict
    of counts and errors."""
    import numpy as np
    from repro_torch.kernels import grouped_swiglu as GK
    from repro_torch.models import layers as L

    m, D = cfg.moe, cfg.d_model
    E, K = m.n_experts, m.top_k
    T = B * S
    require(T <= L.MOE_GROUP_SIZE, "one capacity group")
    cap = L.moe_capacity(T, E, K, m.capacity_factor)
    require(cap < T, "the capacity-bound case: every lane takes capacity")
    icfg = dataclasses.replace(cfg, moe_impl=impl)
    x = torch.randn((B, S, D), generator=gen, device="cuda").to(torch.bfloat16)
    lanes = torch.ones((B, S), dtype=torch.bool, device="cuda")
    got = L.moe_round(p, x, icfg, lanes).reshape(T, D)
    xf = x.reshape(T, D)
    probs = torch.softmax(xf.float() @ p["router"], dim=-1).cpu().numpy()
    idx = np.argsort(-probs, axis=1, kind="stable")[:, :K]
    w = np.take_along_axis(probs, idx, 1)
    w = w / np.maximum(w.sum(1, keepdims=True), np.float32(1e-9))
    slot = capacity_slots(idx, E, cap, impl)
    tt, jj = np.nonzero(slot >= 0)
    ee = idx[tt, jj]
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa
    lay = GK.expert_layout(dev(idx), dev(slot >= 0), E)
    h_all = GK.grouped_gate_up(xf, p["w_gate"], p["w_up"], lay.tok,
                               lay.tiles, lay.n_tiles)
    y_all = GK.grouped_down(h_all, p["w_down"], lay.tiles, lay.n_tiles)
    at = lay.row[dev(tt), dev(jj)]           # each kept pair's row
    rows = torch.zeros((T, K, D), dtype=x.dtype, device="cuda")
    rows[dev(tt), dev(jj)] = y_all[at]
    wt = dev(w)
    if impl == "scatter":
        want = (rows * wt.to(x.dtype)[..., None]).sum(1)
    else:
        want = (wt.to(x.dtype)[..., None].float() * rows.float()).sum(1).to(
            x.dtype)
    if not same_bits(got, want):
        d = (got.float() - want.float()).abs()
        raise AssertionError(
            f"moe {impl} T={T}: output differs from the per-token routing, "
            f"drops and combine at {int((d > 0).sum())} of {d.numel()} "
            f"values (max |d| {d.max().item():.3e})")
    worst, flips, over = 0.0, 0, 0
    for e in np.unique(ee):
        sel = ee == e
        xe = xf[dev(tt[sel])]
        h_tok = (torch.nn.functional.silu(xe @ p["w_gate"][e])
                 * (xe @ p["w_up"][e]))
        y_tok = (h_tok @ p["w_down"][e]).float()
        h_b = h_all[at[dev(sel)]]
        y_b = y_all[at[dev(sel)]].float()
        moved = (h_b.float() - h_tok.float()).abs() @ p["w_down"][e].float().abs()
        floor = 2.0 ** -16 * y_tok.abs().amax(1, keepdim=True)
        step = TOL_BF16[0] + TOL_BF16[1] * y_tok.abs()
        err = (y_b - y_tok).abs()
        bad = err > torch.maximum(step, floor) + moved
        require(not bool(bad.any()),
                f"moe {impl} T={T} expert {e}: {int(bad.sum())} expert "
                "outputs off the per-token SwiGLU by more than one bf16 step "
                "plus the move of the hidden values that differ")
        flips += int((h_b != h_tok).sum())
        over += int((err > step).sum())
        worst = max(worst, err.max().item())
    torch.cuda.synchronize()
    return {"T": T, "capacity": cap, "kept": len(tt), "dropped": T * K - len(tt),
            "max_err": worst, "hidden_differ": flips, "over_step": over}


def moe_vlm_phase(torch):
    """Phase 22: arctic-480b at its published widths (2 of 35 layers),
    served through the graphs (the split layout, greedy, 8 of the serve
    workload's requests) and gated as phase 20; the same requests served by
    an eager engine sharing its weights, counting the real tokens dropped
    at capacity; the replays bitwise against that eager engine's step at
    every bucket; ``moe_round`` in both impls' orders on layer 0's experts
    against the per-token reference; then llava-next-mistral-7b's backbone
    at full width and depth, served and gated the same way."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.engine.engine import serve
    from repro_torch.launch import serve as serve_cli

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"  device memory in use as the phase starts: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    full = get_config("arctic-480b")
    cfg = dataclasses.replace(full, n_layers=ARCTIC_LAYERS)
    m = cfg.moe
    log(f"  {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads} query heads over "
        f"{cfg.n_kv_heads} KV heads (group {cfg.q_per_kv}), hd "
        f"{cfg.resolved_head_dim}, {m.n_experts} experts top-{m.top_k} of "
        f"d_ff {m.d_ff} + a dense residual FFN of d_ff {cfg.d_ff}, capacity "
        f"factor {m.capacity_factor}, moe_impl {cfg.moe_impl!r}, vocab "
        f"{cfg.vocab_size}; reduced: n_layers {full.n_layers} -> "
        f"{cfg.n_layers}")
    t0 = time.perf_counter()
    g, g_pool, args = build_at_width(torch, cfg)
    log(f"  weights {param_bytes(g.params) / 1e9:.2f} GB (seeded, bf16); "
        f"built and warmed up in {time.perf_counter() - t0:.2f} s: "
        f"{len(g.graphs)} graphs captured in "
        f"{sum(x.capture_s for x in g.graphs.values()):.2f} s, graph pool "
        f"{graph_pool_bytes(torch, g)} B; device memory in use "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    e, e_pool, _ = build_at_width(torch, cfg, params=g.params,
                                  cuda_graphs=False)
    res, reqs, toks, launches, spans = gated_serve(torch, g, g_pool, args)
    log_served(res, toks, g, launches)
    log_rounds(cfg, g.params, spans, g.cfg.n_slots)

    def eager_serve():
        sched = serve_cli.build_scheduler(args)
        ereqs = serve_cli.workload(args, cfg)
        return ereqs, serve(ereqs, sched, e, kv_pool=e_pool)

    (ereqs, eres), drops = counted_drops(torch, eager_serve)
    etoks = check_outputs(eres, ereqs, cfg.vocab_size)
    e_pool.reset()
    same = sum(res.outputs[a.req_id] == eres.outputs[b.req_id]
               for a, b in zip(reqs, ereqs))
    total = [sum(v[i] for v in drops.values()) for i in (0, 1)]
    expert_bytes = param_bytes(
        {n: g.params["layers"][0]["moe"][n] for n in ("w_gate", "w_up",
                                                      "w_down")}) / m.n_experts
    log(f"  the same requests on an eager engine sharing the weights: output "
        f"tok/s {len(etoks) / eres.wall_s:.1f} over {eres.rounds} rounds; "
        f"greedy outputs equal to the graph serve's for {same} of {len(reqs)}"
        " requests (printed, not gated: the rounds depend on timing)")
    log(f"  real expert choices dropped at capacity (eager serve, both "
        f"layers), by chunk bucket: "
        + ", ".join(f"C={C}: {d} of {n}"
                    for C, (d, n, *_) in sorted(drops.items()))
        + f"; in all {total[0]} of {total[1]} "
        f"({total[0] / max(total[1], 1):.2%})")
    for C, (_, _, reached, layer_rounds) in sorted(drops.items()):
        per_layer = reached / layer_rounds
        b_ms, _, n_bytes = round_bound(cfg, g.params, g.cfg.n_slots, C)
        need = n_bytes - cfg.n_layers * (m.n_experts - per_layer) * expert_bytes
        log(f"    C={C}: the real tokens' kept choices reach {per_layer:.1f} "
            f"of {m.n_experts} experts a layer (eager serve): the bound of "
            f"the weights this data needs {need / HBM_BYTES_PER_S * 1e3:.3f} "
            f"ms ({need / 1e9:.2f} GB), against {b_ms:.3f} ms for every "
            "expert")
    bitwise_rounds(torch, g, e, "arctic", g.cfg.max_context, 240, (250, 245))
    log("  replays bitwise equal to the eager step at every bucket and at C=1 "
        "again: sampled ids, lens, last_token, every cache tensor")
    del e, e_pool
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(22)
    moe0 = g.params["layers"][0]["moe"]
    for B, S in MOE_CHECKS:
        for impl in ("scatter", "onehot"):
            r = moe_token_check(torch, moe0, cfg, B, S, impl, gen)
            log(f"  per-token check of moe_round, {impl}, T={r['T']} (capacity "
                f"{r['capacity']}): {r['kept']} choices kept, "
                f"{r['dropped']} dropped; output bitwise equal to the "
                "per-token routing, drops and combine of the grouped "
                "kernels' rows; expert rows within one "
                f"bf16 step plus the hidden move of the per-token SwiGLU (max "
                f"|d| {r['max_err']:.3e}; {r['over_step']} values over one "
                f"step; {r['hidden_differ']} hidden values round otherwise)")
    log(f"  arctic's peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.max_memory_reserved() / 1e9:.2f} GB reserved")
    del g, g_pool, moe0
    torch.cuda.empty_cache()

    cfg = get_config("llava-next-mistral-7b")
    log(f"  {cfg.name} (its text backbone): {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, hd "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
        "full width and depth")
    t0 = time.perf_counter()
    v, v_pool, args = build_at_width(torch, cfg)
    log(f"  weights {param_bytes(v.params) / 1e9:.2f} GB; built and warmed "
        f"up in {time.perf_counter() - t0:.2f} s ({len(v.graphs)} graphs)")
    res, _, toks, launches, spans = gated_serve(torch, v, v_pool, args)
    log_served(res, toks, v, launches)
    log_rounds(cfg, v.params, spans, v.cfg.n_slots)
    del v, v_pool
    torch.cuda.empty_cache()
    log(f"  phase 22 took {time.perf_counter() - t_phase:.1f} s")


# -- phase 27: the grouped expert kernels --------------------------------------
GROUPED_SLOTS = 16      # arctic-1l.chat's slots
# (lanes t = 16 x C, real lanes) of the cell's rounds: a decode round with
# ~11.5 of 16 slots held at 9.6 req/s; a C = 16 round of ~25 real tokens
# (the traced segment's ~3,500 decode and ~2,700 prefill tokens over ~340
# rounds); a C = 128 round of the token budget, 128
GROUPED_CASES = ((16, 12), (256, 25), (2048, 128))
GROUPED_DECODES = 11    # decode slots of a mixed round; the rest one chunk


def cell_cfg(capacity_factor):
    """``arctic-1l``'s program config (bench/configs/arctic-1l.json): one
    of arctic-480b's layers, the dense residual d_model wide, the experts'
    capacity factor ``capacity_factor`` (64 = E / K: dropless)."""
    from repro_torch.configs import get_config
    full = get_config("arctic-480b")
    return dataclasses.replace(
        full, n_layers=1, d_ff=full.d_model,
        moe=dataclasses.replace(full.moe, capacity_factor=capacity_factor))


def round_lanes(torch, C, n_real):
    """(16, C) bool: the real lanes of a round of bucket C holding n_real
    tokens, laid out as the engine lays them: decodes at lane 0 of their
    slots, prefill chunks from lane 0 of the next ones."""
    mask = torch.zeros((GROUPED_SLOTS, C), dtype=torch.bool, device="cuda")
    if C == 1:
        mask[:n_real] = True
        return mask
    mask[:GROUPED_DECODES, 0] = True
    left, slot = n_real - GROUPED_DECODES, GROUPED_DECODES
    while left > 0 and slot < GROUPED_SLOTS:
        mask[slot, : min(C, left)] = True
        left, slot = left - C, slot + 1
    return mask


def grouped_bound(n_experts_read, n_rows, D, F, gated):
    """(ms, by) of one grouped kernel: the touched experts' weights (2 D F
    or D F bf16 each), the rows read and written, against 4 or 2 n D F
    operations."""
    w = (2 if gated else 1) * D * F * 2
    rows = n_rows * (D + F) * 2
    return bound_ms(n_experts_read * w + rows,
                    (4 if gated else 2) * n_rows * D * F)


def rows_within_step(got, want, what):
    """Each value within one bf16 step of ``want`` (TOL_BF16) or, at
    values near 0, within 2**-16 of its row's largest |want| (the f32
    sums' own noise); returns (max |d|, values that differ)."""
    import torch
    g, w = got.float(), want.float()
    err = (g - w).abs()
    floor = 2.0 ** -16 * w.abs().amax(1, keepdim=True)
    bad = err > torch.maximum(TOL_BF16[0] + TOL_BF16[1] * w.abs(), floor)
    require(not bool(bad.any()),
            f"{what}: {int(bad.sum())} values off the plain version by more "
            f"than one bf16 step (max |d| {err.max().item():.3e})")
    return err.max().item(), int((got != want).sum())


def grouped_kernels(torch, timer, p, xf, idx, kept, what, timed=True):
    """The two grouped kernels on rows xf (t, D) routed to ``idx`` (t, K)
    where ``kept``: each against its plain version (the down kernel fed the
    gate/up kernel's h, so a hidden value rounded the other way is charged
    once), the layout's counts against a host count; with ``timed``, each
    kernel's device time and both plain versions' time."""
    import numpy as np
    from repro_torch.kernels import grouped_swiglu as GK

    E = p["w_gate"].shape[0]
    host = idx.cpu().numpy()[kept.cpu().numpy()]
    counts = np.bincount(host.reshape(-1), minlength=E)
    n_rows = int(counts.sum())
    lay = GK.expert_layout(idx, kept, E)
    require(bool((lay.counts.cpu().numpy() == counts).all()),
            f"{what}: the layout's counts differ from the host's")
    args = (lay.tok, lay.tiles, lay.n_tiles)
    h = GK.grouped_gate_up(xf, p["w_gate"], p["w_up"], *args)
    h_p = GK.grouped_gate_up_plain(xf, p["w_gate"], p["w_up"], *args)
    y = GK.grouped_down(h, p["w_down"], lay.tiles, lay.n_tiles)
    y_p = GK.grouped_down_plain(h, p["w_down"], lay.tiles, lay.n_tiles)
    torch.cuda.synchronize()
    h_err, h_flips = rows_within_step(h[:n_rows], h_p[:n_rows],
                                      f"gate/up {what}")
    y_err, _ = rows_within_step(y[:n_rows], y_p[:n_rows], f"down {what}")
    out = {"rows": n_rows, "experts": int((counts > 0).sum()),
           "most_rows": int(counts.max()), "h_err": h_err,
           "h_flips": h_flips, "y_err": y_err}
    if timed:
        out["ms_up"] = timer.device(
            lambda: GK.grouped_gate_up(xf, p["w_gate"], p["w_up"], *args))
        out["ms_down"] = timer.device(
            lambda: GK.grouped_down(h, p["w_down"], lay.tiles, lay.n_tiles))
        out["plain_ms"] = timer(lambda: GK.grouped_down_plain(
            GK.grouped_gate_up_plain(xf, p["w_gate"], p["w_up"], *args),
            p["w_down"], lay.tiles, lay.n_tiles))
    return out


def grouped_case(torch, timer, p, cfg, t, n_real, gen, timed=True):
    """The two grouped kernels at one of the cell's shapes (t lanes, n_real
    real, the dropless cell's routing of random bf16 rows), checked and
    timed by ``grouped_kernels``; with ``timed``, the bounds, the batched
    GEMMs' (``L.expert_ffn`` over the dropless (E, t, D) buffer) and the
    whole layer's time both ways (CUDA graph replays)."""
    from repro_torch.models import layers as L

    m, D = cfg.moe, cfg.d_model
    E, K, F = m.n_experts, m.top_k, m.d_ff
    C = t // GROUPED_SLOTS
    x = torch.randn((GROUPED_SLOTS, C, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    mask = round_lanes(torch, C, n_real)
    xf = x.reshape(t, D)
    _, top_idx = L.moe_route(p, xf[None], K)
    kept = mask.reshape(t, 1).expand(t, K)
    out = {"t": t, "real": n_real}
    out.update(grouped_kernels(torch, timer, p, xf, top_idx[0], kept,
                               f"t={t}", timed))
    out["bound_up"] = grouped_bound(out["experts"], out["rows"], D, F, True)
    out["bound_down"] = grouped_bound(out["experts"], out["rows"], D, F,
                                      False)
    if timed:
        buf = torch.zeros((E, t, D), dtype=x.dtype, device="cuda")
        out["bmm_ms"] = timer.device(lambda: L.expert_ffn(p, buf))
        del buf
        torch.cuda.empty_cache()
        out["layer_ms"] = timer.graph(lambda: L.moe_round(p, x, cfg, mask))[1]
        out["layer_bmm_ms"] = timer.graph(
            lambda: L.moe_ffn_scatter(p, x, cfg))[1]
        torch.cuda.empty_cache()
    return out


def log_grouped_case(r) -> None:
    (b_up, by_up), (b_dn, by_dn) = r["bound_up"], r["bound_down"]
    line = (f"  t={r['t']} ({r['real']} real lanes): {r['rows']} expert rows "
            f"over {r['experts']} experts; h within one step (max |d| "
            f"{r['h_err']:.3e}, {r['h_flips']} rounded otherwise), y max |d| "
            f"{r['y_err']:.3e}")
    if "ms_up" in r:
        line += f", gate/up {r['ms_up']:.4f} ms, down {r['ms_down']:.4f} ms"
    log(line)
    if "bmm_ms" in r:
        both = r["ms_up"] + r["ms_down"]
        log(f"    bound: gate/up {b_up:.4f} ms ({by_up}), down {b_dn:.4f} ms "
            f"({by_dn}); kernels at {b_up / r['ms_up']:.1%} / "
            f"{b_dn / r['ms_down']:.1%} of their bounds, together "
            f"{(b_up + b_dn) / both:.1%}; plain {r['plain_ms']:.3f} ms; the "
            f"batched GEMMs over every expert's (E, t, D) buffer "
            f"{r['bmm_ms']:.3f} ms ({r['bmm_ms'] / both:.1f}x); the whole "
            f"layer {r['layer_ms']:.3f} ms against moe_ffn_scatter's "
            f"{r['layer_bmm_ms']:.3f} ms")


# (config, buckets) of the capacity-bound rounds timed in phase 27: all 16
# lanes of each slot take capacity at the published factor 1.25
CAPACITY_ROUNDS = (("arctic-480b", (1, 16, 32, 64, 128)),
                   ("mixtral-8x7b", (1, 16, 24, 32, 48, 64, 128)))


def capacity_bound_rounds(torch, timer, p_arctic):
    """The MoE layer of capacity-bound rounds (arctic-480b and
    mixtral-8x7b at capacity factor 1.25, every lane real): by bucket, the
    grouped kernels (checked against their plain versions) and
    ``moe_round`` against the batched GEMMs' layer (``moe_ffn_scatter``),
    and which of the two ``moe_round`` runs (``GROUPED_MAX_CAPACITY``),
    each layer timed as a CUDA graph replay (``moe_round``'s BITWISE equal
    to its eager call, on both sides of the choice).  mixtral's engine
    rounds stop at its sliding window's assertion; its layer is timed at
    the shapes its rounds would have.  Returns the rows logged."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    gen = torch.Generator(device="cuda").manual_seed(271)
    out = []
    for name, buckets in CAPACITY_ROUNDS:
        cfg = dataclasses.replace(get_config(name), n_layers=1)
        m = cfg.moe
        p = (p_arctic if name == "arctic-480b" else
             L.init_moe(gen, cfg, torch.bfloat16, "cuda"))
        for C in buckets:
            t = GROUPED_SLOTS * C
            x = torch.randn((GROUPED_SLOTS, C, cfg.d_model), generator=gen,
                            device="cuda").to(torch.bfloat16)
            lanes = torch.ones((GROUPED_SLOTS, C), dtype=torch.bool,
                               device="cuda")
            cap = L.moe_capacity(t, m.n_experts, m.top_k, m.capacity_factor)
            xf = x.reshape(t, cfg.d_model)
            _, top_idx = L.moe_route(p, xf[None], m.top_k)
            kept = L.capacity_rank(top_idx, "token")[0] < cap
            r = grouped_kernels(torch, timer, p, xf, top_idx[0], kept,
                                f"{name} C={C}")
            got, layer_ms = timer.graph(lambda: L.moe_round(p, x, cfg, lanes))
            require(same_bits(got, L.moe_round(p, x, cfg, lanes)),
                    f"{name} C={C}: moe_round's replay differs from the "
                    "eager call")
            r.update(name=name, C=C, capacity=cap,
                     batched=cap > L.GROUPED_MAX_CAPACITY, layer_ms=layer_ms,
                     layer_bmm_ms=timer.graph(
                         lambda: L.moe_ffn_scatter(p, x, cfg))[1])
            log(f"  {name} C={C} (t={t}, capacity {cap}): {r['rows']} kept "
                f"rows over {r['experts']} experts, at most "
                f"{r['most_rows']}; grouped kernels {r['ms_up']:.4f} + "
                f"{r['ms_down']:.4f} ms (h max |d| {r['h_err']:.3e}, y max "
                f"|d| {r['y_err']:.3e}); moe_round "
                f"{r['layer_ms']:.3f} ms ("
                + ("the batched GEMMs" if r["batched"] else "grouped")
                + f") against moe_ffn_scatter's {r['layer_bmm_ms']:.3f} ms")
            out.append(r)
            torch.cuda.empty_cache()
        del p
        torch.cuda.empty_cache()
    return out


def grouped_graph_check(torch, p, cfg):
    """``L.moe_round`` captured in a CUDA graph at every bucket of the cell
    (16 x C lanes, the cell's real lanes at C = 1, 16 and 128 and a
    quarter of the lanes at the others): each replay BITWISE equal to the
    eager call on the same inputs, and the device counter moved by the
    same (experts read, rows) both ways.  Returns {C: (experts, rows)}."""
    from repro_torch.models import layers as L

    gen = torch.Generator(device="cuda").manual_seed(27)
    counter = torch.zeros(3, dtype=torch.long, device="cuda")
    stream = torch.cuda.Stream()
    real = dict(GROUPED_CASES)
    seen = {}
    for C in (1, 16, 32, 64, 128):
        t = GROUPED_SLOTS * C
        x = torch.randn((GROUPED_SLOTS, C, cfg.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)
        mask = round_lanes(torch, C, real.get(t, t // 4))
        before = counter.clone()
        want = L.moe_round(p, x, cfg, mask, counter)
        eager = counter - before
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            L.moe_round(p, x, cfg, mask)          # settle the stream first
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            got = L.moe_round(p, x, cfg, mask, counter)
        before = counter.clone()
        graph.replay()
        torch.cuda.synchronize()
        require(same_bits(got, want),
                f"capacity factor {cfg.moe.capacity_factor} C={C}: the "
                "replay differs from the eager call")
        require(bool(((counter - before) == eager).all()),
                f"C={C}: the replay moved the counter by "
                f"{(counter - before).tolist()}, the eager call by "
                f"{eager.tolist()}")
        seen[C] = tuple(eager.tolist()[:2])
        del graph, got
    torch.cuda.empty_cache()
    return seen


def grouped_expert_phase(torch, timed=True):
    """Phase 27: the grouped expert kernels at ``arctic-1l.chat``'s shapes
    (one layer of arctic-480b, 128 experts top-2, dropless at capacity 64;
    26.8 GB of seeded experts).  (a) At t = 16, 256 and 2,048 lanes with the
    cell's real lanes: each kernel against its plain version; with
    ``timed``, each kernel's device time beside its bound, the batched
    GEMMs' (E, t, D) path and the whole layer both ways, then the
    capacity-bound rounds of arctic-480b and mixtral-8x7b at 1.25 by bucket
    (``capacity_bound_rounds``).  (b)
    ``moe_round`` replayed from a CUDA graph BITWISE equal to the eager call
    at every bucket, dropless (64) and capacity-bound (1.25), the counter
    moved alike.  (c) The cell's engine served through its graphs: the
    grouped kernels launch once per layer a round, the batched expert GEMMs
    never; a traced serve's summary (experts read per round by bucket); the
    replays BITWISE equal to an eager engine's step at every bucket.
    Returns the kernel table's rows."""
    from repro_torch.engine.engine import serve
    from repro_torch.kernels import grouped_swiglu as GK
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import layers as L
    from repro_torch import tracing

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = cell_cfg(64.0)
    bmm_calls = []
    expert_ffn = L.expert_ffn

    def counted(p, buf):
        bmm_calls.append(tuple(buf.shape))
        return expert_ffn(p, buf)

    L.expert_ffn = counted
    try:
        t0 = time.perf_counter()
        g, g_pool, args = build_at_width(torch, cfg)
        log(f"  {cfg.name} as arctic-1l: 1 layer, {cfg.moe.n_experts} experts "
            f"top-{cfg.moe.top_k} of d_ff {cfg.moe.d_ff}, dense residual "
            f"{cfg.d_ff}, capacity factor {cfg.moe.capacity_factor}; weights "
            f"{param_bytes(g.params) / 1e9:.2f} GB, built and warmed up in "
            f"{time.perf_counter() - t0:.2f} s ({len(g.graphs)} graphs)")
        require(not bmm_calls, f"the batched expert GEMMs ran at warm-up: "
                f"{bmm_calls}")
        p = g.params["layers"][0]["moe"]
        timer = Timer(torch)
        gen = torch.Generator(device="cuda").manual_seed(270)
        rows = {}
        for t, n_real in GROUPED_CASES:
            r = grouped_case(torch, timer, p, cfg, t, n_real, gen, timed)
            log_grouped_case(r)
            rows[t] = r
        if timed:
            capacity_bound_rounds(torch, timer, p)
        for cf in (64.0, 1.25):
            seen = grouped_graph_check(torch, p, cell_cfg(cf))
            log(f"  moe_round at capacity factor {cf}: replays bitwise equal "
                "to the eager call at every bucket, the counter alike; "
                "(experts read, rows) by C: " + ", ".join(
                    f"C={C} {e}/{n}" for C, (e, n) in seen.items()))
        bmm_calls.clear()       # the cases' deliberate yardstick calls
        res, reqs, toks, launches, spans = gated_serve(torch, g, g_pool, args)
        log_served(res, toks, g, launches)
        n_rounds = sum(g.bucket_rounds.values())
        for name in ("grouped_gate_up", "grouped_down"):
            require(launches[name] == cfg.n_layers * n_rounds,
                    f"{name} launched {launches[name]} times over "
                    f"{n_rounds} rounds of {cfg.n_layers} layer(s)")
        require(not bmm_calls, f"the batched expert GEMMs ran: {bmm_calls}")
        tracer = tracing.Tracer()
        sched = serve_cli.build_scheduler(args)
        treqs = serve_cli.workload(args, cfg)
        serve(treqs, sched, g, kv_pool=g_pool, tracer=tracer)
        g_pool.reset()
        for line in tracing.summary(tracer.spans()):
            log(f"  traced serve: {line}")
        e, e_pool, _ = build_at_width(torch, cfg, params=g.params,
                                      cuda_graphs=False)
        bitwise_rounds(torch, g, e, "arctic-1l", g.cfg.max_context, 240,
                       (250, 245))
        log("  the cell's replays bitwise equal to the eager step at every "
            "bucket and at C=1 again")
        require(not bmm_calls, f"the batched expert GEMMs ran: {bmm_calls}")
    finally:
        L.expert_ffn = expert_ffn
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"GB allocated; phase 27 took {time.perf_counter() - t_phase:.1f} s")
    table = {}
    if timed:
        r = rows[16]
        for name, ms, (b_ms, by) in (
                ("grouped_gate_up", r["ms_up"], r["bound_up"]),
                ("grouped_down", r["ms_down"], r["bound_down"])):
            table[name] = {"max_abs_err": r["y_err"] if "down" in name
                           else r["h_err"], "ms": ms,
                           "plain_ms": r["plain_ms"], "bound_ms": b_ms,
                           "bound_by": by, "library_ms": r["bmm_ms"],
                           "launches": launches[name]}
    del g, g_pool, e, e_pool, p
    torch.cuda.empty_cache()
    return table


# -- phase 28: the windowed kernels and K-EXAONE's layer kinds, served --------
EXAONE_CONFIG = ROOT / "bench" / "configs" / "k-exaone-8l.json"
EXAONE_HELD = 8         # of the cell's 64 held experts; every width published
SPAN_KERNELS = ("decode_splitk_kernel", "paged_prefill")


def windowed_kernel_cases(torch, window):
    """Phase 28 (a): both paged kernels' windowed instantiations at
    ``k-exaone-8l``'s heads (64 over 8, hd 128, page 16), split and fused,
    against the windowed plain versions under phase 3's tolerances: decode
    over up to 512 keys (B = 16) and up to 2,048 (B = 4, several splits
    merged), prefill at Sq 16 and 128; bf16, and f32 at 512 keys."""
    gen = torch.Generator(device="cuda").manual_seed(28)
    timer = Timer(torch)
    heads = dict(Hq=64, Hkv=8, hd=128, ps=16, n_pages=2049)
    shapes = (("512 keys", dict(heads, B=16, max_pages=33)),
              ("2048 keys", dict(heads, B=4, max_pages=129)))
    bf16, f32 = torch.bfloat16, torch.float32
    worst = 0.0
    for fused in (False, True):
        layout = "fused" if fused else "split"
        for dtype, (keys, shape) in ((bf16, shapes[0]), (bf16, shapes[1]),
                                     (f32, shapes[0])):
            name = f"{layout} window {window} {keys} {str(dtype)[6:]}"
            r = decode_case(torch, timer, gen, dtype=dtype, timed=False,
                            fused=fused, window=window, **shape)
            errs = [r["max_abs_err"]]
            for Sq in (16, 128):
                r = prefill_case(torch, timer, gen, Sq=Sq, dtype=dtype,
                                 timed=False, fused=fused, window=window,
                                 **shape)
                errs.append(r["max_abs_err"])
            worst = max(worst, *errs)
            log(f"  {name}: err decode {errs[0]:.3e}, prefill Sq=16 "
                f"{errs[1]:.3e}, Sq=128 {errs[2]:.3e}")
    log("  every windowed output within phase 3's tolerance of its plain "
        "version, fused bitwise equal to split; a NaN key in the window "
        "reaches its decode row, one below every window changes no output")
    return worst


def traced_spans(prof):
    """The paged attention kernels the card ran, counted by the span of
    their template argument in the kernel's name."""
    seen = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if (str(e.device_type()).endswith("CUDA")
                and any(k in name for k in SPAN_KERNELS)):
            kind = next((k for k in ("SlidingWindow", "Causal") if k in name),
                        name)
            seen[kind] = seen.get(kind, 0) + 1
    return seen


def exaone_phase(torch):
    """Phase 28: (a) ``windowed_kernel_cases`` at the cell's window of 128;
    (b) ``k-exaone-8l``'s form as its model module builds it (8 layers
    LLLG LLLG: the dense lead layer, 6 sliding RoPE layers, 2 global NoPE
    layers, QK-norm, post-norm, the sigmoid router over 128 experts and the
    shared expert) with EXAONE_HELD experts held, seeded bf16 weights,
    served through ``TorchEngine``'s graphs on the split layout by
    ``gated_serve`` under ``torch.profiler``: the launch counters, zeroed
    just before the serve, must read 6 windowed and 2 causal launches a
    round (the decode kernel at C = 1, the prefill kernel above), and the
    card's trace as many ``paged::SlidingWindow`` and ``paged::Causal``
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    from bench import cell as cells, weights

    t_phase = time.perf_counter()
    config = dict(cells.load_json(EXAONE_CONFIG), num_experts=EXAONE_HELD)
    model = cells.model_module(config)
    cfg = model.program_config(config)
    window = max(cfg.window(l) for l in range(cfg.n_layers))
    err = windowed_kernel_cases(torch, window)
    torch.cuda.empty_cache()
    stacks = weights.make_stacks(model.draws(config, cfg), 28, "cuda")
    n_win = sum(1 for l in range(cfg.n_layers) if cfg.window(l))
    n_full = cfg.n_layers - n_win
    log(f"  {cfg.name}: {cfg.n_layers} layers, {n_win} with a window of "
        f"{window} and RoPE, {n_full} global without; {cfg.moe.held} of "
        f"{cfg.moe.n_experts} experts held, top-{cfg.moe.top_k}, a shared "
        f"expert; weights {param_bytes(stacks) / 1e9:.2f} GB")
    engine, kv_pool, args = build_at_width(
        torch, cfg, params=model.as_params(cfg, stacks))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res, _, toks, launches, _ = gated_serve(torch, engine, kv_pool, args)
    log_served(res, toks, engine, launches)
    rounds = {"paged_decode_attention": engine.bucket_rounds.get(1, 0),
              "paged_prefill_attention": sum(
                  n for c, n in engine.bucket_rounds.items() if c > 1)}
    for name, n in rounds.items():
        got = (launches[name + ".windowed"],
               launches[name] - launches[name + ".windowed"])
        require(got == (n_win * n, n_full * n),
                f"{name}: {got[0]} windowed and {got[1]} causal launches "
                f"over {n} rounds, not {n_win} and {n_full} a round")
    total = sum(rounds.values())
    traced = traced_spans(prof)
    require(traced == {"SlidingWindow": n_win * total,
                       "Causal": n_full * total},
            f"the trace's paged attention kernels {traced} over {total} "
            f"rounds, not {n_win} SlidingWindow and {n_full} Causal a round")
    log(f"  {n_win} windowed and {n_full} causal launches a round, counted "
        f"and traced ({traced}); peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated; "
        f"phase 28 took {time.perf_counter() - t_phase:.1f} s")
    del engine, kv_pool, stacks, prof
    torch.cuda.empty_cache()
    return err


# -- phase 23: the whole-prompt prefill and decode -----------------------------
PD_B, PD_S, PD_CHUNK, PD_STEPS = 4, 512, 128, 8   # qwen1.5-0.5b, full depth
PD_PAGE = 16
FLASH_S = 8192          # B = 1: flash runs 8 query blocks of 1,024 over 2
#                         key blocks of 4,096
MIXTRAL_LAYERS = 2      # of mixtral-8x7b's 32: 6.3 GB of bf16 weights
MIXTRAL_S = 4352        # past its sliding window of 4,096
# no expert choice dropped (tiny_config's factor): a prefill of S tokens and
# a decode of one group their tokens differently, so at the published 1.25
# their capacity drops, and so their outputs, may differ legitimately
MIXTRAL_CAPACITY = 8.0
# the reference's bf16 bar (atol, rtol), tests/test_engine.py:52-55
BF16_BAR = (0.25, 0.05)
EXAMPLES = ("torch_quickstart", "torch_serve_lprs_apc")


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def bf16_gate(torch, got, want, what):
    """``got`` finite and within BF16_BAR of ``want`` everywhere, and each
    row's greedy id equal to ``want``'s wherever ``want``'s top-2 margin
    exceeds the bar at its top logit.  Returns (max |d|, rows with such a
    margin, rows)."""
    atol, rtol = BF16_BAR
    g, w = got.float(), want.float()
    require(bool(torch.isfinite(g).all()), f"{what}: a non-finite value")
    d = (g - w).abs()
    over = d > atol + rtol * w.abs()
    require(not bool(over.any()),
            f"{what}: {int(over.sum())} values beyond the bf16 bar (max |d| "
            f"{float(d.max()):.4f})")
    top = w.topk(2, dim=-1).values
    clear = top[..., 0] - top[..., 1] > atol + rtol * top[..., 0].abs()
    same = g.argmax(-1) == w.argmax(-1)
    require(bool(same[clear].all()),
            f"{what}: greedy ids differ where the top-2 margin is clear")
    return float(d.max()), int(clear.sum()), clear.numel()


def event_ms(torch, fn):
    """(fn()'s result, its ms on the card: CUDA events around one call)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def qwen_prefill_decode(torch, card):
    """qwen1.5-0.5b at full width and depth, seeded bf16 weights:
    ``Model.prefill`` of PD_B prompts of PD_S tokens against the same
    prompts through ``chunked_step_paged`` in chunks of PD_CHUNK (the paged
    prefill kernel), then PD_STEPS ``decode`` steps on the prefill cache
    padded by PD_STEPS rows against C = 1 rounds (the paged decode kernel);
    each gated by ``bf16_gate`` and the kernels' launches counted over the
    chunked side alone.  Then ``train_hidden`` under flash (the default)
    against ``ATTN_IMPL = "naive"`` at B = 1, S = FLASH_S."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models.model import build_model

    cfg = get_config("qwen1.5-0.5b")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(23)
    params = model.init(gen, "cuda")
    B, S, ps = PD_B, PD_S, PD_PAGE
    log(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.resolved_head_dim}; "
        f"full width and depth, seeded bf16 weights")
    host = torch.Generator().manual_seed(23)
    ids = torch.randint(1, cfg.vocab_size, (B, S + PD_STEPS), generator=host,
                        dtype=torch.int32).cuda()
    prompt, steps = ids[:, :S], ids[:, S:]
    with torch.no_grad():
        model.prefill(params, {"tokens": prompt})           # warm-up
        (logits, cache), pre_ms = event_ms(
            torch, lambda: model.prefill(params, {"tokens": prompt}))
        require(tuple(cache["k"].shape) == (cfg.n_layers, B, S,
                                             cfg.n_kv_heads,
                                             cfg.resolved_head_dim),
                f"prefill cache {tuple(cache['k'].shape)}")
        pad = (0, 0, 0, 0, 0, PD_STEPS)
        cache = {n: torch.nn.functional.pad(c, pad) for n, c in cache.items()}
        dec, dec_ms = [], []
        for i in range(PD_STEPS):
            lens = torch.full((B,), S + i, dtype=torch.int32, device="cuda")
            (out, cache), ms = event_ms(torch, lambda: model.decode(
                params, steps[:, i:i + 1], cache, lens))
            dec.append(out)
            dec_ms.append(ms)

        n_pages = -(-(S + PD_STEPS) // ps)
        n_phys = B * n_pages + 1                   # the last page: the sink
        shape = (cfg.n_layers, n_phys, ps, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        pool = {n: torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
                for n in ("k", "v")}
        tables = torch.randperm(n_phys - 1, generator=host)[: B * n_pages]
        tables = tables.view(B, n_pages).to(torch.int32).cuda()
        lens = torch.zeros(B, dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        zero_launches()
        for c in range(0, S, PD_CHUNK):
            chunk = torch.full((B,), PD_CHUNK, dtype=torch.int32, device="cuda")
            chunked = model.impl.chunked_step_paged(
                params, prompt[:, c:c + PD_CHUNK], pool, lens, chunk, tables)
            lens = lens + chunk
        one = torch.ones(B, dtype=torch.int32, device="cuda")
        rounds = []
        for i in range(PD_STEPS):
            rounds.append(model.impl.chunked_step_paged(
                params, steps[:, i:i + 1], pool, lens, one, tables))
            lens = lens + one
        torch.cuda.synchronize()
        launches = read_launches()
    want = {"paged_prefill_attention": cfg.n_layers * S // PD_CHUNK,
            "paged_decode_attention": cfg.n_layers * PD_STEPS}
    require(launches == {n: want.get(n, 0) for n in launches},
            f"chunked side's launches {launches}, expected {want}")
    err, clear, rows = bf16_gate(torch, logits, chunked,
                                 "prefill against the chunked kernel path")
    log(f"  prefill of {B} x {S} tokens against {S // PD_CHUNK} chunks of "
        f"{PD_CHUNK} through chunked_step_paged: last-position logits max "
        f"|d| {err:.4f} within the bf16 bar; greedy ids equal on {clear} of "
        f"{rows} rows with a clear top-2 margin (every row agrees: "
        f"{bool((logits.argmax(-1) == chunked.argmax(-1)).all())})")
    errs = [bf16_gate(torch, d, r, f"decode step {i}")
            for i, (d, r) in enumerate(zip(dec, rounds))]
    log(f"  {PD_STEPS} decode steps on the prefill cache padded to "
        f"{S + PD_STEPS} rows against C = 1 rounds: max |d| "
        f"{max(e[0] for e in errs):.4f}; greedy ids equal on "
        f"{sum(e[1] for e in errs)} of {sum(e[2] for e in errs)} rows with a "
        "clear margin")
    log(f"  kernel launches on the chunked side: "
        f"{ {n: c for n, c in launches.items() if c} }")
    log(f"  prefill {pre_ms:.3f} ms for {B} x {S} tokens "
        f"({B * S / pre_ms * 1e3:.0f} tok/s); decode "
        f"{statistics.median(dec_ms):.3f} ms a step (median of {PD_STEPS}; "
        f"{min(dec_ms):.3f}-{max(dec_ms):.3f}) at B = {B}; {card}")
    del cache, pool, dec, rounds

    long = {"tokens": torch.randint(1, cfg.vocab_size, (1, FLASH_S),
                                    generator=host, dtype=torch.int32).cuda()}
    with torch.no_grad():
        model.train_hidden(params, long)                     # warm-up
        flash, flash_ms = event_ms(
            torch, lambda: model.train_hidden(params, long))
        impl = L.ATTN_IMPL
        L.ATTN_IMPL = "naive"
        try:
            model.train_hidden(params, long)
            naive, naive_ms = event_ms(
                torch, lambda: model.train_hidden(params, long))
        finally:
            L.ATTN_IMPL = impl
    err, _, _ = bf16_gate(torch, flash, naive,
                          f"train_hidden flash against naive at S={FLASH_S}")
    log(f"  train_hidden at B = 1, S = {FLASH_S}: flash ({FLASH_S // 1024} "
        f"query blocks x 2 key blocks) against the exact chunked path: max "
        f"|d| {err:.4f} within the bf16 bar over {flash.numel()} hidden "
        f"values; flash {flash_ms:.3f} ms, naive {naive_ms:.3f} ms; {card}")
    return params


def mixtral_ring(torch, card):
    """mixtral-8x7b's published widths at MIXTRAL_LAYERS layers (capacity
    factor MIXTRAL_CAPACITY): ``Model.prefill`` of MIXTRAL_S > W tokens
    gives the W-sized ring with the last W positions at ``pos % W``; then
    PD_STEPS ``decode`` steps, each gated by ``bf16_gate`` against the last
    logits of a whole ``Model.prefill`` of the extended prompt."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    full = get_config("mixtral-8x7b")
    cfg = dataclasses.replace(
        full, n_layers=MIXTRAL_LAYERS,
        moe=dataclasses.replace(full.moe, capacity_factor=MIXTRAL_CAPACITY))
    W, S, m = cfg.sliding_window, MIXTRAL_S, cfg.moe
    log(f"  {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
        f"heads (group {cfg.q_per_kv}), hd {cfg.resolved_head_dim}, "
        f"{m.n_experts} experts top-{m.top_k} of d_ff {m.d_ff}, sliding "
        f"window {W}; reduced: n_layers {full.n_layers} -> {cfg.n_layers}, "
        f"capacity factor {full.moe.capacity_factor} -> {m.capacity_factor} "
        "(no expert choice dropped, so prefill and decode route alike)")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(23)
    t0 = time.perf_counter()
    params = model.init(gen, "cuda")
    torch.cuda.synchronize()
    log(f"  weights {param_bytes(params) / 1e9:.2f} GB (seeded, bf16) in "
        f"{time.perf_counter() - t0:.2f} s")
    host = torch.Generator().manual_seed(24)
    ids = torch.randint(1, cfg.vocab_size, (1, S + PD_STEPS), generator=host,
                        dtype=torch.int32).cuda()
    with torch.no_grad():
        (_, cache), pre_ms = event_ms(
            torch, lambda: model.prefill(params, {"tokens": ids[:, :S]}))
        kv = (cfg.n_layers, 1, W, cfg.n_kv_heads, cfg.resolved_head_dim)
        require(tuple(cache["k"].shape) == tuple(cache["v"].shape) == kv,
                f"ring cache {tuple(cache['k'].shape)}, expected {kv}")
        pos = torch.arange(S - W, S, device="cuda", dtype=torch.int32)
        ring = torch.empty(W, dtype=torch.int32, device="cuda")
        ring[pos % W] = pos
        require(tuple(cache["kv_pos"].shape) == (cfg.n_layers, 1, W)
                and bool((cache["kv_pos"] == ring).all()),
                "kv_pos does not hold the last W positions at pos % W")
        errs, dec_ms = [], []
        for i in range(PD_STEPS):
            n = S + i
            lens = torch.full((1,), n, dtype=torch.int32, device="cuda")
            (out, cache), ms = event_ms(torch, lambda: model.decode(
                params, ids[:, n:n + 1], cache, lens))
            dec_ms.append(ms)
            require(bool((cache["kv_pos"][:, 0, n % W] == n).all()),
                    f"decode step {i} did not record position {n}")
            ref, _ = model.prefill(params, {"tokens": ids[:, :n + 1]})
            errs.append(bf16_gate(torch, out, ref,
                                  f"ring decode step {i} against a prefill "
                                  f"of {n + 1} tokens"))
    log(f"  prefill of {S} tokens: a {W}-slot ring holding positions "
        f"{S - W}-{S - 1} at pos % {W} in every layer ({pre_ms:.3f} ms); "
        f"{PD_STEPS} decode steps wrapping it, each against a whole prefill "
        f"of the extended prompt: max |d| {max(e[0] for e in errs):.4f} "
        f"within the bf16 bar, greedy ids equal on {sum(e[1] for e in errs)}"
        f" of {PD_STEPS} steps with a clear margin; decode "
        f"{statistics.median(dec_ms):.3f} ms a step; {card}")


def run_examples(torch):
    """Each of EXAMPLES as a process of its own on the card (the published
    width of its model): it must exit 0, which it does only when every
    request of every run finished.  Returns each one's seconds."""
    seconds = {}
    for name in EXAMPLES:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, str(ROOT / "examples" /
                                                  f"{name}.py")],
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=600)
        seconds[name] = time.perf_counter() - t0
        for line in res.stdout.splitlines():
            if "finished" in line or "TTFT" in line or "target" in line:
                log(f"  [{name}] {line.strip()}")
        require(res.returncode == 0,
                f"examples/{name}.py exited {res.returncode}: "
                f"{res.stderr[-2000:]}")
    return seconds


def prefill_decode_phase(torch):
    """Phase 23: the whole-prompt entry points of ``TransformerLM`` on the
    card (qwen1.5-0.5b against the chunked kernel path, flash against
    naive, mixtral's ring at its real window) and two torch examples."""
    t_phase = time.perf_counter()
    card = card_line()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = qwen_prefill_decode(torch, card)
    log(f"  qwen's peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated; {card}")
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mixtral_ring(torch, card)
    log(f"  mixtral's peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated; {card}")
    torch.cuda.empty_cache()
    seconds = run_examples(torch)
    log(f"  examples exited 0 with every request finished: "
        + ", ".join(f"{n} in {s:.1f} s" for n, s in seconds.items()))
    log(f"  phase 23 took {time.perf_counter() - t_phase:.1f} s")


# -- phase 24: training ------------------------------------------------------
TRAIN_ARCH = "llama3.2-1b"      # the train CLI's default arch, at full width
TRAIN_STEPS, TRAIN_B, TRAIN_S = 8, 8, 128
TRAIN_CKPT_EVERY = 4
MICRO_BAR = 0.05                # tests/test_training.py:41-54
RESTART_RTOL = 2e-2             # tests/test_training.py (the restart test)
CARD_CPU_RTOL = 1e-4
CARD_CPU_STEPS = 3


def host_copy(tree) -> list:
    from repro_torch.tree import tree_leaves
    return [t.detach().to("cpu", copy=True) for t in tree_leaves(tree)]


def train_run(torch, ckpt_dir, *, resume, step_ms, saved, restored,
              stash_at=None):
    """``repro_torch.launch.train.train`` at full width on the card, each
    step timed (synchronised), the state saved at step ``stash_at`` and
    every restored state copied to the host as they happen.  Returns the
    losses."""
    import repro_torch.launch.train as T
    from repro_torch.distributed.checkpoint import CheckpointManager

    real_make, real_save = T.make_train_step, CheckpointManager.save
    real_restore = CheckpointManager.restore

    def make(model, cfg):
        fn = real_make(model, cfg)

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        return timed

    def save(self, step, state, **kw):
        if step == stash_at:
            saved[step] = host_copy(state)
        return real_save(self, step, state, **kw)

    def restore(self, template, *args, **kw):
        step, state = real_restore(self, template, *args, **kw)
        restored[step] = host_copy(state)
        return step, state

    T.make_train_step, CheckpointManager.save = make, save
    CheckpointManager.restore = restore
    try:
        params, losses = T.train(
            TRAIN_ARCH, tiny=False, steps=TRAIN_STEPS, global_batch=TRAIN_B,
            seq_len=TRAIN_S, ckpt_dir=ckpt_dir, ckpt_every=TRAIN_CKPT_EVERY,
            resume=resume, log_every=TRAIN_STEPS, device="cuda")
    finally:
        T.make_train_step, CheckpointManager.save = real_make, real_save
        CheckpointManager.restore = real_restore
    del params
    return losses


def micro_check(torch, card):
    """``loss_and_grad`` at 4 microbatches against 1 on one full-width batch
    (fresh seeded weights): each leaf within MICRO_BAR of its largest grad."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.train_step import TrainConfig, loss_and_grad
    from repro_torch.tree import tree_leaves

    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(24), "cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLM(
        DataConfig(cfg.vocab_size, TRAIN_B, TRAIN_S)).batch_at(0).items()}
    (l1, _, g1), ms1 = event_ms(torch, lambda: loss_and_grad(
        model, params, batch, TrainConfig(n_microbatches=1)))
    g1 = tree_leaves(g1)
    (l4, _, g4), ms4 = event_ms(torch, lambda: loss_and_grad(
        model, params, batch, TrainConfig(n_microbatches=4)))
    worst = 0.0
    for a, b in zip(g1, tree_leaves(g4)):
        d = float((a - b).abs().max() / (a.abs().max() + 1e-6))
        worst = max(worst, d)
    require(worst < MICRO_BAR, f"4 microbatches against 1: a leaf's max "
            f"|g4 - g1| / max |g1| is {worst:.4f} (bar {MICRO_BAR})")
    log(f"  microbatches: loss_and_grad at B = {TRAIN_B}, S = {TRAIN_S}: "
        f"loss {l1.item():.5f} (1 microbatch) / {l4.item():.5f} (4); worst "
        f"leaf max |g4 - g1| / max |g1| {worst:.5f} < {MICRO_BAR} over "
        f"{len(g1)} leaves; {ms1:.1f} ms / {ms4:.1f} ms; {card}")


def card_cpu_losses(torch, device):
    """CARD_CPU_STEPS train steps of tiny qwen1.5-0.5b in f32 on
    ``device`` from weights drawn on the CPU (the same on both sides), with
    the train driver's optimizer settings: the losses."""
    from repro_torch.configs import tiny_config
    from repro_torch.models.model import build_model
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (
        TrainConfig, init_train_state, make_train_step,
    )
    from repro_torch.tree import tree_map

    cfg = tiny_config("qwen1.5-0.5b").with_(param_dtype="float32")
    model = build_model(cfg)
    steps = CARD_CPU_STEPS
    tcfg = TrainConfig(optimizer=AdamWConfig(
        lr=3e-4, weight_decay=0.1, grad_clip_norm=1.0,
        warmup_steps=max(1, steps // 20), total_steps=steps))
    params, opt = init_train_state(model, torch.Generator().manual_seed(24),
                                   tcfg, "cpu")
    params, opt = tree_map(lambda t: t.to(device), (params, opt))
    step = make_train_step(model, tcfg)
    data = SyntheticLM(DataConfig(cfg.vocab_size, 8, 64))
    losses = []
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch_at(i).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(m["loss"].item())
    return losses


def training_phase(torch):
    """Phase 24: the train driver at llama3.2-1b's full width (the timed
    run doubles as the uninterrupted run of the restart check), the
    microbatch gate, the restart gates, the card against the CPU, and
    ``examples/torch_train_tiny.py``."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    card = card_line()
    torch.cuda.empty_cache()
    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    zero_launches()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(ckpt_dir).free
        log(f"  {TRAIN_ARCH} at full width (16 layers, d_model 2048, 32/8 "
            f"heads, hd 64, d_ff 8,192, vocab 128,256, tied embeddings), "
            f"seeded bf16 weights, f32 grads and moments; B = {TRAIN_B}, "
            f"S = {TRAIN_S}, {TRAIN_STEPS} steps, a checkpoint every "
            f"{TRAIN_CKPT_EVERY} into {ckpt_dir} ({free / 1e9:.0f} GB free)")
        torch.cuda.reset_peak_memory_stats()
        step_ms, saved, restored = [], {}, {}
        at = TRAIN_STEPS - TRAIN_CKPT_EVERY
        full = train_run(torch, ckpt_dir, resume=False, step_ms=step_ms,
                         saved=saved, restored=restored, stash_at=at)
        peak = torch.cuda.max_memory_allocated()
        require(all(math.isfinite(x) for x in full), f"losses {full}")
        require(full[-1] < full[0], f"the loss did not fall: {full}")
        ms = statistics.median(step_ms[1:])
        log(f"  losses {' '.join(f'{x:.4f}' for x in full)}")
        log(f"  train step {ms:.1f} ms (median of steps 2-{TRAIN_STEPS}; "
            f"{min(step_ms[1:]):.1f}-{max(step_ms[1:]):.1f}; step 1 "
            f"{step_ms[0]:.1f}), {TRAIN_B * TRAIN_S / ms * 1e3:.0f} tokens/s, "
            f"peak {peak / 1e9:.2f} GB allocated; {card}")

        # restart: the last checkpoint deleted, a resume under the same steps
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{TRAIN_STEPS:010d}"))
        held = saved.pop(at)
        tail = train_run(torch, ckpt_dir, resume=True, step_ms=[],
                         saved=saved, restored=restored)
        require(list(restored) == [at], f"restored steps {list(restored)}")
        got = restored[at]
        require(len(got) == len(held) and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(held, got)),
            "the restored params, moments and step differ from the save's")
        want = full[at:]
        rel = max(abs(a - b) / abs(b) for a, b in zip(tail, want))
        require(len(tail) == len(want) and rel <= RESTART_RTOL,
                f"resumed losses {tail} against {want}")
        log(f"  restart: the step-{TRAIN_STEPS} checkpoint deleted, resumed "
            f"from step {at}: {len(held)} leaves (params, moments, step) "
            f"bitwise what the save held; losses {at}-{TRAIN_STEPS - 1} "
            f"{' '.join(f'{x:.4f}' for x in tail)}, max relative difference "
            f"{rel:.3g} (bar {RESTART_RTOL}; bitwise: {tail == want}; run "
            "without torch.use_deterministic_algorithms: the embedding and "
            "gather backward accumulate with atomics)")
        del held, got, saved, restored
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    micro_check(torch, card)
    torch.cuda.empty_cache()

    on_card = card_cpu_losses(torch, "cuda")
    on_cpu = card_cpu_losses(torch, "cpu")
    rel = max(abs(a - b) / abs(b) for a, b in zip(on_card, on_cpu))
    require(rel <= CARD_CPU_RTOL,
            f"card losses {on_card} against the CPU's {on_cpu}")
    log(f"  tiny qwen1.5-0.5b f32, {CARD_CPU_STEPS} steps: card "
        f"{' '.join(f'{x:.6f}' for x in on_card)} against CPU "
        f"{' '.join(f'{x:.6f}' for x in on_cpu)}: max relative difference "
        f"{rel:.3g} (bar {CARD_CPU_RTOL}; TF32 off)")

    t0 = time.perf_counter()
    res = subprocess.run([sys.executable,
                          str(ROOT / "examples" / "torch_train_tiny.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    for line in res.stdout.splitlines():
        if "loss:" in line or "resumed" in line or line.strip() == "ok":
            log(f"  [torch_train_tiny] {line.strip()}")
    require(res.returncode == 0, f"examples/torch_train_tiny.py exited "
            f"{res.returncode}: {res.stderr[-2000:]}")
    log(f"  examples/torch_train_tiny.py exited 0 in "
        f"{time.perf_counter() - t0:.1f} s")
    launched = {n: c for n, c in read_launches().items() if c}
    require(not launched, f"kernels launched by the training path: {launched}")
    log("  no kernel launched (the training path is plain PyTorch, as it is "
        f"jnp in the reference); phase 24 took "
        f"{time.perf_counter() - t_phase:.1f} s")


# -- phase 25: the hybrid, xLSTM and Whisper families -------------------------
FAM_STEPS = 8
XLSTM_B, XLSTM_S = 2, 512
WHISPER_B, WHISPER_S = 2, 64
JAMBA_LAYERS = 8        # of jamba's 72: one group (1 attention + 7 mamba)
JAMBA_EXPERTS = 4       # of 16: one group at 16 holds 77 GB of experts
JAMBA_B, JAMBA_S = 1, 512
# an xLSTM block's decode against its whole run, over its mixer's largest
# |output| (``mixer_ratio``), by the params' dtype: between the sound
# blocks' worst and the planted fault's least, each about 10x away, on an
# H100 (bf16 0.036 and 0.92, f32 7.9e-5 and 0.93)
XLSTM_BLOCK_BAR = {"bfloat16": 0.1, "float32": 1e-3}


def pad_rows(torch, cache, names, n):
    """The named K/V caches (sequence on axis 2) padded by n zero rows."""
    pad = (0, 0, 0, 0, 0, n)
    return {k: (torch.nn.functional.pad(v, pad) if k in names else v)
            for k, v in cache.items()}


def beyond_bar(torch, got, want):
    """(max |got - want|, the number of values beyond BF16_BAR)."""
    atol, rtol = BF16_BAR
    d = (got.float() - want.float()).abs()
    return float(d.max()), int((d > atol + rtol * want.float().abs()).sum())


def mixer_ratio(torch, got, want, inp):
    """max |got - want| over the largest |want - inp|: a block's error
    relative to its mixer's own output (the residual input cancels)."""
    own = (want.float() - inp.float()).abs().max()
    return float((got.float() - want.float()).abs().max() / own)


def xlstm_block_check(torch, card, cfg, params, ids, S):
    """Every xLSTM block at full width and depth, each fed the same input
    both ways: the block over the whole prompt of S + FAM_STEPS tokens (its
    input the previous block's output over that prompt) against the block
    over the first S tokens and then FAM_STEPS one-token steps from the
    state it returned.  Each step is held within the params' dtype's
    XLSTM_BLOCK_BAR by ``mixer_ratio``; a planted fault, the first step
    taken from a reset state (the history dropped), must exceed the bar in
    every block, so the gate can fail."""
    from repro_torch.models import xlstm as X

    dtype = str(params["embed"].dtype)[6:]
    bar = XLSTM_BLOCK_BAR[dtype]
    x = params["embed"][ids[:, :S + FAM_STEPS].long()]
    sound, fault = [], []
    for g in range(len(params["slstm"])):
        blocks = ([(X.mlstm_mixer, lp) for lp in params["mlstm"][g]]
                  + [(X.slstm_mixer, params["slstm"][g])])
        for fn, lp in blocks:
            whole, _ = fn(lp, x, cfg)
            _, st = fn(lp, x[:, :S], cfg)
            worst = 0.0
            for i in range(FAM_STEPS):
                step, st = fn(lp, x[:, S + i:S + i + 1], cfg, st)
                require(bool(torch.isfinite(step).all()),
                        f"xLSTM {dtype} block {len(sound)} step {i}: a "
                        "non-finite value")
                worst = max(worst, mixer_ratio(torch, step[:, 0],
                                               whole[:, S + i], x[:, S + i]))
            reset, _ = fn(lp, x[:, S:S + 1], cfg)
            fault.append(mixer_ratio(torch, reset[:, 0], whole[:, S],
                                     x[:, S]))
            sound.append(worst)
            x = whole
    n = len(sound)
    log(f"  {dtype}: each of the {n} blocks, fed the same input both ways: "
        f"{FAM_STEPS} one-token steps from the state of a {S}-token run "
        f"against the block over all {S + FAM_STEPS} tokens, max |d| over "
        f"the mixer's largest |output|: worst {max(sound):.3g} (block "
        f"{sound.index(max(sound))}; median over blocks "
        f"{statistics.median(sound):.3g}), bar {bar}; the planted fault "
        f"(step 0 from a reset state): least {min(fault):.4f} (block "
        f"{fault.index(min(fault))}; median {statistics.median(fault):.4f}); "
        f"{card}")
    require(max(sound) <= bar,
            f"xLSTM {dtype} block {sound.index(max(sound))}: decode against "
            f"the whole run {max(sound):.3g} of the mixer's output (bar {bar})")
    require(min(fault) > bar,
            f"xLSTM {dtype} block {fault.index(min(fault))}: a reset state "
            f"reads {min(fault):.3g}, within the bar {bar}: the gate cannot "
            "see it")


def xlstm_checks(torch, card, cfg, model, params, ids, B, S):
    """xLSTM's checks beyond ``family_run``'s: the input gate's spread at
    block 0; then on its bf16 weights and on the same weights upcast to
    f32, two valid chunkings of one prefill (printed), in f32 the whole
    model's last of FAM_STEPS decode steps against a whole prefill of the
    extended prompt (printed beside that spread), and
    ``xlstm_block_check`` (gated); the f32 loss's grad norm."""
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import global_norm
    from repro_torch.training.train_step import TrainConfig, loss_and_grad
    from repro_torch.tree import tree_map

    half = build_model(dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, chunk_size=cfg.ssm.chunk_size // 2)))
    p32 = tree_map(lambda t: t.float(), params)
    with torch.no_grad():
        lp = params["mlstm"][0][0]
        h = rms_norm(params["embed"][ids[:, :S].long()], lp["norm"],
                     cfg.norm_eps).float()
        log(f"  log_i = rms_norm(x) @ wi at block 0: std "
            f"{float((h @ lp['wi']).std()):.3f} (wi drawn at scale 0.1 with no "
            f"fan-in factor, as the reference's: 0.1 * sqrt({cfg.d_model}) = "
            f"{0.1 * math.sqrt(cfg.d_model):.3f})")
        for p in (params, p32):
            dtype = str(p["embed"].dtype)[6:]
            a, cache = model.prefill(p, {"tokens": ids[:, :S]})
            b, _ = half.prefill(p, {"tokens": ids[:, :S]})
            err, over = beyond_bar(torch, b, a)
            log(f"  {dtype}: two valid prefills of the same {S} tokens, mLSTM "
                f"chunks of {cfg.ssm.chunk_size} and {cfg.ssm.chunk_size // 2}"
                f": max |d| {err:.4f}, {over} logits beyond the bf16 bar "
                "(printed, not gated)")
            if p is p32:
                for n in range(S, S + FAM_STEPS):
                    lens = torch.full((B,), n, dtype=torch.int32,
                                      device="cuda")
                    out, cache = model.decode(p, ids[:, n:n + 1], cache, lens)
                ref, _ = model.prefill(p, {"tokens": ids[:, :S + FAM_STEPS]})
                err, over = beyond_bar(torch, out, ref)
                log(f"  f32: the whole model's last decode step against a "
                    f"whole prefill of {S + FAM_STEPS} tokens (printed, not "
                    f"gated): max |d| {err:.4f}, {over} of "
                    f"{B * cfg.vocab_size} logits beyond the bf16 bar")
            del cache
            xlstm_block_check(torch, card, cfg, p, ids, S)
    bt = {"tokens": ids[:, :S], "labels": ids[:, 1:S + 1]}
    (loss, _, grads), ms = event_ms(torch, lambda: loss_and_grad(
        model, p32, bt, TrainConfig()))
    gn = float(global_norm(grads))
    require(math.isfinite(loss.item()) and math.isfinite(gn) and gn > 0,
            f"{cfg.name} f32 loss {loss.item()}, grad norm {gn}")
    log(f"  f32 loss + backward at B = {B}, S = {S}: loss {loss.item():.4f}, "
        f"grad norm {gn:.6g}, {ms:.1f} ms; {card}")
    del grads, p32


def family_run(torch, card, cfg, B, S, extra, pad_names, backward,
               gate_whole=True):
    """Seeded bf16 weights of ``cfg`` on the card: ``Model.prefill`` of B
    prompts of S tokens, then FAM_STEPS ``decode`` steps on its cache (the
    K/V caches padded by FAM_STEPS rows), each gated by ``bf16_gate``
    against the last logits of a whole ``Model.prefill`` of the extended
    prompt (with ``gate_whole=False``, xLSTM's, only the last step, printed,
    and ``xlstm_checks`` run); then, if ``backward``, one ``loss`` and its
    backward (``loss_and_grad``): finite, grad norm > 0.  Frees the
    model."""
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import global_norm
    from repro_torch.training.train_step import TrainConfig, loss_and_grad

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(25), "cuda")
    torch.cuda.synchronize()
    log(f"  weights {param_bytes(params) / 1e9:.2f} GB (seeded, bf16) in "
        f"{time.perf_counter() - t0:.2f} s")
    host = torch.Generator().manual_seed(25)
    ids = torch.randint(1, cfg.vocab_size, (B, S + FAM_STEPS + 1),
                        generator=host, dtype=torch.int32).cuda()

    def batch(n):
        return {"tokens": ids[:, :n], **extra}

    with torch.no_grad():
        model.prefill(params, batch(S))                     # warm-up
        (_, cache), pre_ms = event_ms(torch,
                                      lambda: model.prefill(params, batch(S)))
        cache = pad_rows(torch, cache, pad_names, FAM_STEPS)
        errs, dec_ms = [], []
        for i in range(FAM_STEPS):
            n = S + i
            lens = torch.full((B,), n, dtype=torch.int32, device="cuda")
            (out, cache), ms = event_ms(torch, lambda: model.decode(
                params, ids[:, n:n + 1], cache, lens))
            dec_ms.append(ms)
            require(bool(torch.isfinite(out).all()),
                    f"{cfg.name} decode step {i}: a non-finite logit")
            if gate_whole:
                ref, _ = model.prefill(params, batch(n + 1))
                errs.append(bf16_gate(torch, out, ref,
                                      f"{cfg.name} decode step {i} against "
                                      f"a prefill of {n + 1} tokens"))
            elif i == FAM_STEPS - 1:
                ref, _ = model.prefill(params, batch(n + 1))
                errs.append(beyond_bar(torch, out, ref))
    del cache
    if gate_whole:
        log(f"  prefill of {B} x {S} tokens {pre_ms:.3f} ms ({card}); "
            f"{FAM_STEPS} decode steps, each against a whole prefill of the "
            f"extended prompt: max |d| {max(e[0] for e in errs):.4f} within "
            f"the bf16 bar, greedy ids equal on {sum(e[1] for e in errs)} of "
            f"{sum(e[2] for e in errs)} rows with a clear margin")
    else:
        log(f"  prefill of {B} x {S} tokens {pre_ms:.3f} ms ({card}); the "
            f"whole model's last bf16 decode step against a whole prefill "
            f"of {S + FAM_STEPS} tokens (printed, not gated): max |d| "
            f"{errs[0][0]:.4f}, {errs[0][1]} of {B * cfg.vocab_size} logits "
            "beyond the bf16 bar")
    log(f"  decode {statistics.median(dec_ms):.3f} ms a step (median; "
        f"{min(dec_ms):.3f}-{max(dec_ms):.3f}); {card}")
    if backward:
        b = {**batch(S), "labels": ids[:, 1:S + 1]}
        model.loss(params, b)                               # warm-up
        (loss, _, grads), ms = event_ms(torch, lambda: loss_and_grad(
            model, params, b, TrainConfig()))
        gn = float(global_norm(grads))
        require(math.isfinite(loss.item()) and math.isfinite(gn) and gn > 0,
                f"{cfg.name} loss {loss.item()}, grad norm {gn}")
        log(f"  loss + backward at B = {B}, S = {S}: loss {loss.item():.4f}, "
            f"grad norm {gn:.6g}, {ms:.1f} ms; {card}")
        del grads
    else:
        log("  loss + backward: not run at this size")
    if not gate_whole:
        xlstm_checks(torch, card, cfg, model, params, ids, B, S)
    log(f"  {cfg.name}'s peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated; {card}")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def families_phase(torch):
    """Phase 25: xlstm-1.3b and whisper-large-v3 at full width and depth,
    jamba-1.5-large-398b's widths at one group with 4 experts."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    card = card_line()
    zero_launches()

    cfg = get_config("xlstm-1.3b")
    log(f"  {cfg.name}: {cfg.n_layers} layers (sLSTM every "
        f"{cfg.ssm.slstm_every}th), d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads of hd {cfg.resolved_head_dim}, mLSTM chunk "
        f"{cfg.ssm.chunk_size}, vocab {cfg.vocab_size}; full width and depth")
    family_run(torch, card, cfg, XLSTM_B, XLSTM_S, {}, (), backward=True,
               gate_whole=False)

    cfg = get_config("whisper-large-v3")
    frames = torch.randn((WHISPER_B, cfg.encoder.seq_len, cfg.d_model),
                         generator=torch.Generator().manual_seed(26)).cuda()
    log(f"  {cfg.name}: {cfg.encoder.n_layers} encoder + {cfg.n_layers} "
        f"decoder layers, d_model {cfg.d_model}, {cfg.n_heads} heads of hd "
        f"{cfg.resolved_head_dim}, {cfg.encoder.seq_len} frames (seeded), "
        f"vocab {cfg.vocab_size}; full width and depth; the self-attention "
        f"cache padded to {WHISPER_S + FAM_STEPS} rows")
    family_run(torch, card, cfg, WHISPER_B, WHISPER_S, {"frames": frames},
               ("self_k", "self_v"), backward=True)
    del frames

    full = get_config("jamba-1.5-large-398b")
    m = dataclasses.replace(full.moe, n_experts=JAMBA_EXPERTS,
                            capacity_factor=JAMBA_EXPERTS / full.moe.top_k)
    cfg = dataclasses.replace(full, n_layers=JAMBA_LAYERS, moe=m)
    log(f"  {cfg.name}: d_model {cfg.d_model}, d_inner "
        f"{cfg.ssm.expand * cfg.d_model}, d_state {cfg.ssm.d_state}, conv "
        f"{cfg.ssm.conv_width}, {cfg.n_heads}/{cfg.n_kv_heads} heads of hd "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, top-{m.top_k} of "
        f"{m.n_experts} experts, vocab {cfg.vocab_size}; reduced: n_layers "
        f"{full.n_layers} -> {cfg.n_layers} (one group), n_experts "
        f"{full.moe.n_experts} -> {m.n_experts} (a group at 16 holds 77 GB of "
        f"expert weights), capacity factor {full.moe.capacity_factor} -> "
        f"{m.capacity_factor} (= experts / top-k: an expert takes every "
        "token, so no choice drops and prefill and decode route alike); the "
        f"attention cache padded to {JAMBA_S + FAM_STEPS} rows")
    family_run(torch, card, cfg, JAMBA_B, JAMBA_S, {}, ("k", "v"),
               backward=False)

    launched = {n: c for n, c in read_launches().items() if c}
    require(not launched, f"kernels launched by the families: {launched}")
    log("  no kernel launched (these families are plain PyTorch, as they are "
        f"jnp in the reference); phase 25 took "
        f"{time.perf_counter() - t_phase:.1f} s")


# -- --turns: the attention and SwiGLU kernels of two trees in turns ----------
TURN_CODE = """
import json, sys, zlib
sys.path.insert(0, "src")
import torch, chip_smoke as cs
from repro_torch.models import layers as L
torch.backends.cuda.matmul.allow_tf32 = False
bf16 = torch.bfloat16
only = sys.argv[1] if len(sys.argv) > 1 else ""


class DeviceTimer(cs.Timer):
    # the device time alone: the card spins while the host enqueues the call
    # (written out: the other checkout's Timer may not have device())
    def __call__(self, fn):
        for _ in range(3):
            fn()
        times = []
        for _ in range(cs.ITERS):
            self.flush.zero_()
            torch.cuda._sleep(HOST_AHEAD_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]


timer, dtimer = cs.Timer(torch), DeviceTimer(torch)
gen = torch.Generator(device="cuda")
paged = dict(B=16, Hq=16, Hkv=16, hd=64, ps=16, max_pages=33, n_pages=2049)
dense = dict(B=16, Hq=16, Hkv=16, hd=64, S=512)
heads = {"": {}, " group 12": dict(Hq=96, Hkv=8, hd=128),
         " group 48": dict(Hq=48, Hkv=1, hd=128)}
ms = {}


def case(name, fn):
    # each case's inputs from its own seed; a group the checkout refuses
    # (ValueError) is skipped
    if only not in name:
        return
    gen.manual_seed(zlib.crc32(name.encode()))
    try:
        ms[name] = fn()
    except ValueError as e:
        print(f"skipped {name}: {e}", flush=True)


for fused in (False, True):
    lay = "fused" if fused else "split"
    for g, h in heads.items():
        for t, label in ((timer, ""), (dtimer, " device")):
            case(f"paged_decode_attention {lay}{g}{label}",
                 lambda: cs.decode_case(torch, t, gen, dtype=bf16, timed=True,
                                        fused=fused, **{**paged, **h})["ms"])
    for Sq in (16, 32, 64, 128, 256):
        case(f"paged_prefill_attention {lay} Sq={Sq}",
             lambda: cs.prefill_case(torch, timer, gen, Sq=Sq, dtype=bf16,
                                     timed=True, fused=fused, **paged)["ms"])
for Sq in (1, 16, 32, 64, 128, 256):
    case(f"chunked_prefill_attention Sq={Sq}",
         lambda: cs.dense_prefill_case(torch, timer, gen, Sq=Sq, dtype=bf16,
                                       timed=True, **dense)["ms"])
longc = dict(B=4, Hq=32, Hkv=8, hd=128, S=32768, sink=False)
for g, h in {**heads, " long": longc}.items():
    for t, label in ((timer, ""), (dtimer, " device")):
        case(f"decode_attention{g}{label}",
             lambda: cs.dense_decode_case(torch, t, gen, dtype=bf16,
                                          timed=True, **{**dense, **h})["ms"])
torch.cuda.empty_cache()
gen.manual_seed(15)
ffn = L.init_ffn(gen, 1024, 2816, bf16, "cuda")
for M in (16, 256, 2048):
    case(f"fused_swiglu M={M}",
         lambda: cs.swiglu_case(torch, timer, gen, ffn, M, bf16,
                                timed=True)["ms"])
if only in "fused_swiglu qwen3-8b M=256":
    gen.manual_seed(15)
    ffn = L.init_ffn(gen, 4096, 12288, bf16, "cuda")
    case("fused_swiglu qwen3-8b M=256",
         lambda: cs.swiglu_case(torch, timer, gen, ffn, 256, bf16,
                                timed=True)["ms"])
# the four swap kernels at phase 4's timed case (bf16, bucket 32, 19 real
# ids) on the split and the fused serve pool, through the wrappers
from repro_torch.kernels import swap as sw
for lay, pool in (("split", cs.SWAP_POOL), ("fused", cs.FUSED_SWAP_POOL)):
    names = [f"{k} {lay}{x}" for k in cs.SWAP_KERNELS
             for x in ("", " device", " host us")]
    if not any(only in n for n in names):
        continue
    gen.manual_seed(zlib.crc32(f"swap {lay}".encode()))
    pages = torch.randn(pool, generator=gen, device="cuda").to(bf16)
    ids = cs.swap_ids(torch, gen, 32, 19, pool[1])
    dst = cs.swap_ids(torch, gen, 32, 19, pool[1])
    staged = torch.randn((pool[0], 32) + tuple(pool[2:]), generator=gen,
                         device="cuda").to(bf16)
    q, s = sw.swap_gather_pages_q8_plain(pages, ids)
    target = pages.clone()
    fns = {"swap_gather_pages": lambda: sw.swap_gather_pages(pages, ids),
           "swap_scatter_pages":
               lambda: sw.swap_scatter_pages(target, dst, staged),
           "swap_gather_pages_q8": lambda: sw.swap_gather_pages_q8(pages, ids),
           "swap_scatter_pages_q8":
               lambda: sw.swap_scatter_pages_q8(target, dst, q, s)}
    for k, fn in fns.items():
        for label, t in (("", timer), (" device", dtimer),
                         (" host us", lambda f: cs.host_us(torch, f))):
            if only in f"{k} {lay}{label}":
                ms[f"{k} {lay}{label}"] = t(fn)
    del pages, target, staged, q, s
    torch.cuda.empty_cache()
print("TURN " + json.dumps(ms), flush=True)
""".replace("HOST_AHEAD_CYCLES", str(HOST_AHEAD_CYCLES))


def turns(other: Path, only: str = "") -> int:
    """Phase 3's and 10's paged attention kernels (decode at groups 1, 12
    and 48, and prefill at every bucket), phase 14's chunked prefill buckets
    and dense decode (the serve shape, groups 12 and 48, and the 32k cache),
    phase 15's bf16 SwiGLU shapes and the four swap kernels at phase 4's
    timed case on the split and fused pools, of the checkout at ``other``
    and of this one, each turn in a process of its own -- other, this,
    this, other, since the card's clocks drift between timings; the decode
    and swap kernels both as phases 3 and 4 time them and on the device
    alone, and the swap wrappers' host time per call.  ``only`` keeps the
    cases whose name holds it.  Each case draws its inputs from a seed of
    its own, and a case a checkout refuses is skipped on its side.  Prints
    each turn's times (ms; host time in us), then per kernel and shape both
    sides' times and this / other."""
    sides = {"other": [], "this": []}
    for label, root in (("other", other), ("this", ROOT), ("this", ROOT),
                        ("other", other)):
        res = subprocess.run([sys.executable, "-c", TURN_CODE, only],
                             cwd=root, capture_output=True, text=True,
                             timeout=900)
        line = [ln for ln in res.stdout.splitlines() if ln.startswith("TURN ")]
        if res.returncode != 0 or not line:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        for ln in res.stdout.splitlines():
            if ln.startswith("skipped "):
                log(f"  {label}: {ln}")
        log(f"TURN {label} {root}: {line[0][5:]}")
        sides[label].append(json.loads(line[0][5:]))
    for name in sides["this"][0]:
        t = [s[name] for s in sides["this"]]
        o = [s[name] for s in sides["other"] if name in s]
        ratio = (f"; this / other {statistics.mean(t) / statistics.mean(o):.3f}"
                 if o else "; the other checkout refuses it")
        unit = "us" if name.endswith(" host us") else "ms"
        log(f"  {name}: other {' / '.join(f'{x:.4f}' for x in o) or '-'} "
            f"this {' / '.join(f'{x:.4f}' for x in t)} {unit}{ratio}")
    return 0


DRY_LEAF_ELEMENTS = {      # the built param trees' elements, as in repro
    "llama3.2-1b": 1_235_814_400, "granite-34b": 47_249_922_048,
    "qwen1.5-0.5b": 463_987_712, "mistral-large-123b": 122_610_069_504,
    "jamba-1.5-large-398b": 398_555_111_424,
    "whisper-large-v3": 1_534_602_240, "arctic-480b": 476_850_275_328,
    "mixtral-8x7b": 46_702_792_704, "llava-next-mistral-7b": 7_241_732_096,
    "xlstm-1.3b": 1_339_431_080,
}
DRY_TARGET_S = 120.0
COUNT_BYTES_RTOL = 0.01
BOUND_FLOOR = 0.95
DENSE_SLOTS, DENSE_CONTEXT, DENSE_C = 16, 512, 128   # one dense serve bucket


def dryrun_cells(torch):
    """(a): ``main(["--both", "--chunked-serve", "--quiet"])`` with its JSON
    record, every cell ok, the meta trees' element counts."""
    import tempfile

    from repro_torch.launch import dryrun

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dry_") as d:
        path = os.path.join(d, "dryrun.json")
        t0 = time.perf_counter()
        rc = dryrun.main(["--both", "--chunked-serve", "--quiet", "--json",
                          path])
        wall = time.perf_counter() - t0
        with open(path) as f:
            rows = json.load(f)
    bad = [f"{r['arch']} {r['shape']} {r['mesh']}: {r['error']}"
           for r in rows if not r["ok"]]
    require(rc == 0 and not bad, f"dry-run cells failed: {bad}")
    n_cells = sum(1 for r in rows if r["shape"] != "chunk_serve")
    require(n_cells == 66, f"{n_cells} dry-run cells, not 33 x 2")
    leaves = {r["arch"]: r["param_leaves"] for r in rows}
    require(leaves == DRY_LEAF_ELEMENTS, f"meta leaf counts {leaves}")
    log(f"  {len(rows)} dry-run cells ok ({n_cells} of 33 x 2 meshes + "
        f"{len(rows) - n_cells} chunked-serve), meta leaf counts equal "
        f"repro's for all 10 archs; (a) took {wall:.1f} s (target "
        f"{DRY_TARGET_S:.0f} s: {'met' if wall <= DRY_TARGET_S else 'MISSED'})")
    return wall


def count_pair(torch, fn_meta, fn_cuda):
    from repro_torch.launch.op_cost import OpCounter

    reps = []
    for fn in (fn_meta, fn_cuda):
        with OpCounter() as c:
            fn()
        reps.append(c.report)
    return reps


def train_step_bound(torch, card):
    """(b): llama3.2-1b's train step at B = 8, S = 128 counted on meta and
    on the card, then timed on the card against its one-chip bound."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    from repro_torch.launch.op_cost import bytes_breakdown, flop_breakdown
    from repro_torch.models.model import build_model
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.train_step import (
        TrainConfig, init_train_state, init_train_state_shape, train_step,
    )

    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg)
    tcfg = TrainConfig()
    m_params, m_opt = init_train_state_shape(model, tcfg)
    # the train driver's inputs on both devices: tokens, labels, loss_mask
    m_batch = {k: torch.empty((TRAIN_B, TRAIN_S), dtype=dt, device="meta")
               for k, dt in (("tokens", torch.int32), ("labels", torch.int32),
                             ("loss_mask", torch.float32))}
    params, opt = init_train_state(
        model, torch.Generator(device="cuda").manual_seed(26), tcfg, "cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLM(
        DataConfig(cfg.vocab_size, TRAIN_B, TRAIN_S)).batch_at(0).items()}
    meta, card_rep = count_pair(
        torch, lambda: train_step(model, tcfg, m_params, m_opt, m_batch),
        lambda: train_step(model, tcfg, params, opt, batch))
    torch.cuda.synchronize()
    for name in sorted(set(meta.by_op) | set(card_rep.by_op)):
        a = meta.by_op.get(name, [0.0, 0.0, 0.0])
        b = card_rep.by_op.get(name, [0.0, 0.0, 0.0])
        if a[:2] != b[:2]:
            log(f"  counted differently by device: {name}: meta {a[0]:.0f} "
                f"flops {a[1]:.0f} B in {a[2]:.0f} calls, cuda {b[0]:.0f} "
                f"flops {b[1]:.0f} B in {b[2]:.0f} calls")
    rel = abs(meta.hbm_bytes - card_rep.hbm_bytes) / card_rep.hbm_bytes
    log(f"  {TRAIN_ARCH} train step (B = {TRAIN_B}, S = {TRAIN_S}, "
        f"TrainConfig()): meta {meta.flops:.6e} flops {meta.hbm_bytes:.6e} B "
        f"({meta.n_while_loops} trip scopes), cuda {card_rep.flops:.6e} flops "
        f"{card_rep.hbm_bytes:.6e} B; bytes differ by {rel:.2e}; unknown ops "
        f"meta {meta.unknown_ops} cuda {card_rep.unknown_ops}")
    log("  its bytes by op (meta): " + ", ".join(
        f"{k} {v / 1e9:.2f} GB" for k, v in bytes_breakdown(meta, 8))
        + "; flops by op: " + ", ".join(
        f"{k} {v:.3e}" for k, v in flop_breakdown(meta, 4)))
    require(meta.flops == card_rep.flops,
            f"flops: meta {meta.flops} != cuda {card_rep.flops}")
    require(rel <= COUNT_BYTES_RTOL, f"bytes differ by {rel:.4f}")
    bound = max(meta.flops / PEAK_FLOPS_BF16, meta.hbm_bytes / HBM_BW) * 1e3
    step = lambda: train_step(model, tcfg, params, opt, batch)   # noqa: E731
    step()
    times = [event_ms(torch, step)[1] for _ in range(5)]
    ms = statistics.median(times)
    log(f"  train step {ms:.3f} ms (median of 5, CUDA events; "
        f"{min(times):.3f}-{max(times):.3f}) against its one-chip bound "
        f"{bound:.3f} ms (max of {meta.flops / PEAK_FLOPS_BF16 * 1e3:.3f} ms "
        f"at 989 TFLOP/s and {meta.hbm_bytes / HBM_BW * 1e3:.3f} ms at 3.35 "
        f"TB/s): {ms / bound:.2f}x; {card}")
    require(ms >= BOUND_FLOOR * bound,
            f"the step ({ms:.3f} ms) beat its bound ({bound:.3f} ms): the "
            "count is wrong")
    del params, opt, batch
    torch.cuda.empty_cache()


def dense_round_bound(torch, card):
    """(b): one dense serve bucket of full-width qwen1.5-0.5b: the plain
    ``chunked_step`` counted on meta, its bound beside the round timed on
    the card (the kernel path).  Printed, not gated."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    from repro_torch.launch.op_cost import count
    from repro_torch.models.model import build_model

    cfg = get_config("qwen1.5-0.5b")
    impl = build_model(cfg).impl
    B, C, S = DENSE_SLOTS, DENSE_C, DENSE_CONTEXT
    kv = (cfg.n_layers, B, S + 1, cfg.n_kv_heads, cfg.resolved_head_dim)

    def inputs(dev):
        i32 = dict(dtype=torch.int32, device=dev)
        return (torch.zeros((B, C), **i32),
                {k: torch.zeros(kv, dtype=torch.bfloat16, device=dev)
                 for k in ("k", "v")},
                torch.full((B,), S // 2, **i32), torch.full((B,), C, **i32))

    meta_params = impl.init(torch.Generator(), "meta")
    with torch.no_grad():
        _, rep = count(impl.chunked_step, meta_params, *inputs("meta"))
        params = impl.init(torch.Generator(device="cuda").manual_seed(26),
                           "cuda")
        args = inputs("cuda")
        impl.chunked_step(params, *args)
        times = [event_ms(torch, lambda: impl.chunked_step(params, *args))[1]
                 for _ in range(5)]
    bound = max(rep.flops / PEAK_FLOPS_BF16, rep.hbm_bytes / HBM_BW) * 1e3
    ms = statistics.median(times)
    log(f"  dense chunked_step, qwen1.5-0.5b, {B} slots x C = {C} over "
        f"{S // 2} cached (max_context {S}): counted (meta, plain attention) "
        f"{rep.flops:.6e} flops {rep.hbm_bytes:.6e} B, bound {bound:.3f} ms; "
        f"the round on the card (eager, the kernel) {ms:.3f} ms (median of "
        f"5; {min(times):.3f}-{max(times):.3f}); printed only; {card}")
    del params, args
    torch.cuda.empty_cache()


def compression_check(torch, card):
    """(c): INT8 quantization under the reference's bars on the card, and
    ``compressed_psum`` over an NCCL group of one."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.distributed.compression import (
        compressed_psum, compression_ratio, dequantize_int8, quantize_int8,
    )

    gen = torch.Generator(device="cuda").manual_seed(26)
    x = torch.randn((1000,), generator=gen, device="cuda") * 3.0
    q, s = quantize_int8(x, gen)
    err = float((dequantize_int8(q.to(torch.int32), s, x.shape, x.numel())
                 - x).abs().max())
    x2 = torch.randn((256,), generator=gen, device="cuda")
    bias = statistics.mean(
        float((dequantize_int8(qq.to(torch.int32), ss, x2.shape, x2.numel())
               - x2).mean())
        for qq, ss in (quantize_int8(x2, gen) for _ in range(64)))
    require(err <= float(s.max()), f"INT8 error {err} > scale {float(s.max())}")
    require(abs(bias) < 5e-3 and compression_ratio() < 0.27,
            f"INT8 mean error {bias}, ratio {compression_ratio()}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as d:
        store = dist.FileStore(os.path.join(d, "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1)
        try:
            grads = {"w": torch.linspace(-1, 1, 512, device="cuda").reshape(
                2, 256)}
            out, res = compressed_psum(grads, None, gen)
            torch.cuda.synchronize()
            d_out = float((out["w"] - grads["w"]).abs().max())
            d_res = float(res["w"].abs().max())
        finally:
            dist.destroy_process_group()
    require(d_out <= 2e-2 and d_res <= 2e-2,
            f"compressed_psum over NCCL: |out - in| {d_out}, residual {d_res}")
    log(f"  INT8 on the card: max error {err:.4f} <= block scale "
        f"{float(s.max()):.4f}, mean error over 64 draws {bias:.2e} (bar "
        f"5e-3), wire ratio {compression_ratio():.4f}; compressed_psum over "
        f"an NCCL group of one: |out - in| {d_out:.4f}, residual {d_res:.4f} "
        f"(bars 2e-2); {card}")


def sharding_sizes(torch):
    """(d): every arch's params and train state per device on both meshes
    under its own fsdp setting; every shard shape divides its dim."""
    from repro_torch.configs import ASSIGNED_ARCHS, get_config
    from repro_torch.distributed.sharding import param_specs, shardings_for
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.model import build_model
    from repro_torch.training.train_step import (
        default_train_config, init_train_state_shape,
    )
    from repro_torch.tree import tree_leaves

    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        model = build_model(cfg)
        tcfg = default_train_config(cfg.param_count(), batch_shards=1,
                                    global_batch=1)
        params, opt = init_train_state_shape(model, tcfg)
        fsdp = cfg.sharding == "fsdp_tp"
        parts = []
        for mp in (False, True):
            mesh = make_production_mesh(multi_pod=mp)
            shard = tree_leaves(shardings_for(
                param_specs(params, mesh, fsdp=fsdp), mesh))
            p_b = m_b = 0
            for t, mu, sh in zip(tree_leaves(params), tree_leaves(opt.mu),
                                 shard):
                local = sh.shard_shape(tuple(t.shape))   # raises if not
                require(all(d % k == 0 for d, k in zip(t.shape, local)),
                        f"{arch} {tuple(t.shape)} -> {local}")
                n = math.prod(local)
                p_b += n * t.element_size()
                m_b += 2 * n * mu.element_size()
            parts.append(f"{'x'.join(map(str, mesh.axis_sizes))}: params "
                         f"{p_b / 1e9:.3f} GB, train state "
                         f"{(p_b + m_b) / 1e9:.3f} GB per device")
        log(f"  {arch} (fsdp {fsdp}, moments {tcfg.moment_dtype}): "
            + "; ".join(parts))


def dryrun_phase(torch):
    """Phase 26: the whole dry-run on the card machine's host, the counter
    held against the card, INT8 compression on the card and over NCCL, and
    every arch's per-device sizes."""
    t_phase = time.perf_counter()
    card = card_line()
    zero_launches()
    wall = dryrun_cells(torch)
    require(all(v == 0 for v in read_launches().values()),
            f"a kernel launched in the dry-run: {read_launches()}")
    train_step_bound(torch, card)
    dense_round_bound(torch, card)
    compression_check(torch, card)
    sharding_sizes(torch)
    log(f"  phase 26 took {time.perf_counter() - t_phase:.1f} s (the dry-run "
        f"{wall:.1f} s of it); {card}")


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
    if sys.argv[1:2] == ["--turns"]:
        return turns(Path(sys.argv[2]).resolve(), *sys.argv[3:4])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    log("== device")
    log(card_line())
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
            if any(w in line for w in ("Compiling entry", "registers", "spill",
                                       "error", "warning")):
                log(f"  [{name}] {line.strip()}")

    log("== kernels vs plain versions")
    kern = kernel_phase(torch)
    torch.cuda.empty_cache()

    log("== swap kernels vs plain versions")
    swap_kern = swap_kernel_phase(torch)
    torch.cuda.empty_cache()

    log("== serve (python -m repro_torch.launch.serve --full)")
    engine, launches, baseline = serve_phase(torch)

    log(f"== serve, swap (--full {' '.join(SWAP_FLAGS)})")
    swap_launches = swap_serve_phase(torch, "auto", baseline)
    torch.cuda.empty_cache()
    log("== serve, INT8 host tier (the same, pool_for_model(..., "
        "host_kv_dtype='int8'))")
    q8_launches = swap_serve_phase(torch, "int8", baseline)
    torch.cuda.empty_cache()
    log("== serve, disagg (--full --disagg: 1 prefill + 1 decode replica)")
    disagg_phase(torch, baseline)
    torch.cuda.empty_cache()

    log("== full-width model: kernels on the card vs plain on the CPU")
    reference_phase(torch, engine.model_cfg, engine.params)
    ffn0 = engine.params["layers"][0]["ffn"]    # for phases 15-16
    del engine
    torch.cuda.empty_cache()

    log("== fused kernels vs plain versions and the split kernels")
    kern.update(kernel_phase(torch, fused=True))
    torch.cuda.empty_cache()
    log("== swap kernels on the fused pool")
    fused_swap_kernel_phase(torch)

    log("== serve, fused (--full --kv-layout fused)")
    fused_engine, fused_pool, fused_launches, static = fused_serve_phase(
        torch, baseline)
    log(f"== serve, fused swap (--full --kv-layout fused "
        f"{' '.join(SWAP_FLAGS)})")
    swap_serve_phase(torch, "auto", baseline, layout="fused")
    torch.cuda.empty_cache()
    log("== LPRS (--full --kv-layout fused --policy aging --lprs --apc)")
    lprs_phase(torch, fused_engine, fused_pool, static)
    del fused_engine, fused_pool, static
    torch.cuda.empty_cache()

    log("== dense attention kernels vs plain versions and the paged kernels")
    dense_kern = dense_kernel_phase(torch)
    log("== NaN keys through the paged kernels")
    paged_poison_phase(torch)
    log("== fused SwiGLU kernel vs plain versions")
    swiglu_kern = swiglu_phase(torch, ffn0)
    log("== standalone kernels: decode_attention and fused_swiglu")
    standalone_launches = standalone_phase(torch, ffn0)
    torch.cuda.empty_cache()
    log("== serve, dense (--full --dense-kv)")
    dense_launches = dense_serve_phase(torch, baseline)
    torch.cuda.empty_cache()
    log(f"== serve, dense swap (--full --dense-kv {' '.join(SWAP_FLAGS)})")
    dense_serve_phase(torch, baseline, swap=True)
    torch.cuda.empty_cache()
    for layout in ("split", "fused", "dense"):
        log(f"== NaN guard, {layout} (--full --nan-guard"
            + {"split": "", "fused": " --kv-layout fused",
               "dense": " --dense-kv"}[layout]
            + ", a nan_logits fault at the 2nd decode)")
        nan_guard_phase(torch, layout)
        torch.cuda.empty_cache()

    log(f"== serve at granite-34b's widths ({GRANITE_LAYERS} layers, MQA: "
        f"decode group 48)")
    granite_serve_phase(torch)
    torch.cuda.empty_cache()

    log("== the compiled round: CUDA graphs against the eager step")
    compiled_round_phase(torch)
    torch.cuda.empty_cache()

    log(f"== the MoE and VLM families: arctic-480b's widths ({ARCTIC_LAYERS} "
        "layers, 128 experts, group 7) and llava-next-mistral-7b, served")
    moe_vlm_phase(torch)
    torch.cuda.empty_cache()

    log("== the grouped expert kernels at arctic-1l.chat's shapes (1 layer, "
        "128 experts, dropless), the cell served")
    grouped_kern = grouped_expert_phase(torch)
    torch.cuda.empty_cache()

    log("== the windowed kernels and k-exaone-8l's layer kinds, served "
        f"({EXAONE_HELD} experts held)")
    exaone_phase(torch)

    log("== the whole-prompt prefill and decode: qwen1.5-0.5b against the "
        f"chunked kernel path, flash against naive, mixtral-8x7b's ring "
        f"({MIXTRAL_LAYERS} layers), the torch examples")
    prefill_decode_phase(torch)
    torch.cuda.empty_cache()

    log(f"== training: the train driver at {TRAIN_ARCH}'s full width, "
        "microbatches, restart, the card against the CPU, the example")
    training_phase(torch)
    torch.cuda.empty_cache()

    log("== the other families: xlstm-1.3b and whisper-large-v3 at full "
        f"width and depth, jamba-1.5-large-398b's widths ({JAMBA_LAYERS} "
        f"layers, {JAMBA_EXPERTS} experts)")
    families_phase(torch)
    torch.cuda.empty_cache()

    log("== the dry-run: every (arch x shape) cell on the meta device over "
        "both virtual meshes, the counter against the card, INT8 "
        "compression, per-device sizes")
    dryrun_phase(torch)

    sources = {
        "paged_decode_attention": "src/repro/kernels/paged_decode_attention.py:249",
        "paged_prefill_attention": "src/repro/kernels/paged_prefill_attention.py:213",
        "paged_decode_attention_fused":
            "src/repro/kernels/paged_decode_attention.py:303",
        "paged_prefill_attention_fused":
            "src/repro/kernels/paged_prefill_attention.py:274",
        "swap_gather_pages": "src/repro/kernels/swap.py:84",
        "swap_scatter_pages": "src/repro/kernels/swap.py:113",
        "swap_gather_pages_q8": "src/repro/kernels/swap.py:179",
        "swap_scatter_pages_q8": "src/repro/kernels/swap.py:221",
        "chunked_prefill_attention":
            "src/repro/kernels/chunked_prefill_attention.py:144",
        "decode_attention": "src/repro/kernels/decode_attention.py:115",
        "fused_swiglu": "src/repro/kernels/fused_swiglu.py:85",
        "grouped_gate_up": "none (repro's MoE layers are plain jnp)",
        "grouped_down": "none (repro's MoE layers are plain jnp)",
    }
    # each kernel's launches come from the run of its own path: split
    # attention from the recompute main path, fused attention from the fused
    # serve phase, the fp swap pair from the swap phase, the INT8 pair from
    # the INT8 phase, the dense chunked prefill from the dense serve phase,
    # and the two kernels no serve path runs from their entry points' run
    path_launches = {**swap_launches, **{n: q8_launches[n]
                                         for n in SWAP_KERNELS[2:]}, **launches,
                     **{n: fused_launches[n]
                        for n in attention_names("fused")[0]},
                     "chunked_prefill_attention":
                         dense_launches["chunked_prefill_attention"],
                     **{n: standalone_launches[n]
                        for n in ("decode_attention", "fused_swiglu")},
                     **{n: r["launches"] for n, r in grouped_kern.items()}}
    kernels = []
    for name, rep in {**kern, **swap_kern, **dense_kern,
                      **swiglu_kern, **grouped_kern}.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": sources[name],
            "launches": path_launches[name],
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
