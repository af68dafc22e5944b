"""Real-execution chunked-prefill engine on PyTorch: the paper's serving loop
running actual forward passes, on an NVIDIA GPU through the port's CUDA
kernels (or on the CPU through their plain versions, for tests).

The port of ``repro/engine/engine.py``.  Continuous batching with PAGED KV
storage (vLLM layout) by default, or dense per-slot KV (``paged_kv=False``,
the A/B layout):
  * ``n_slots`` fixed *batch rows*; a request binds a slot at its FIRST
    scheduled chunk (late binding) and keeps it until it finishes or is
    preempted.
  * K/V live in a physical page pool ``(layers, n_blocks + 1, block_size,
    kv_heads, head_dim)`` whose page ids are exactly the ``KVBlockPool``'s
    block ids, addressed through per-slot block tables; the last page is a
    write sink for padding lanes.  ``kv_layout="split"`` keeps two pools
    (``cache["k"]``, ``cache["v"]``); ``"fused"`` one pool ``cache["kv"]``
    with ``2 * kv_heads`` head rows, K of head h at 2h and V at 2h+1, which
    swaps and hands off as a one-entry payload.
  * One step per scheduling round executes the ENTIRE mixed batch -- decode
    slots advance by 1 token, prefill slots by their scheduled chunk, idle
    slots by 0 -- under bucketed chunk shapes, then samples and keeps the
    sampled ids in a device-resident ``last_token`` tensor that the NEXT
    round consumes directly.  The step is many kernel launches (per layer:
    norm, projections, RoPE, KV scatter, attention, output projection,
    FFN); on a card each chunk bucket's step is captured once as a CUDA
    graph (``engine/graphs.py``, the counterpart of the JAX engine's
    ``jax.jit``) and a round is one replay, its inputs copied into the
    bucket's fixed buffer first.  ``bubble_ms`` records the host gap before
    each dispatch.
  * PIPELINED serving (``EngineConfig(pipelined=True)``, the default): the
    host schedules round N+1 while the device runs round N; the sampled ids
    come back through an async copy into a pinned buffer owned by the round
    and are drained one round late.  Greedy outputs are identical to the
    synchronous engine (``pipelined=False``).
  * DENSE KV (``paged_kv=False``): ``(layers, n_slots, max_context + 1,
    kv_heads, head_dim)`` per tensor, one row per slot and a sink row at the
    end of each; every round attends through the dense chunked-prefill
    kernel.  Prefix-cache hits copy parked block payloads into the slot; a
    swap stages the whole slot row, with no swap kernel.
  * SWAP preemption (``preemption_mode="swap"``) and disaggregated
    handoffs move a request's pages through the swap kernels: a gather into
    one staging tensor and an async copy into pinned host memory at
    swap-out, landed one round late by ``finalize_swaps``; an upload and a
    scatter into fresh pages at swap-in.  With ``host_kv_dtype="int8"`` on
    the pool the staged pages are INT8 with per-page-per-head scales.
  * NaN GUARD (``nan_guard=True``): each round also checks its logits for
    non-finite values; the mask rides the token readback, and the serve loop
    quarantines the requests it names.  ``poison_kv`` is the ``nan_logits``
    chaos site's hook; ``release`` zeroes a victim's poisoned storage.
  * The scheduler under test is the real ``repro_torch.core`` code (a copy
    of ``repro.core``); latencies are wall-clock.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.request import Request, RequestState
from repro_torch.core.scheduler import ChunkedPrefillScheduler, ScheduledBatch
from repro_torch.engine import graphs
from repro_torch.engine.costmodel import CostModel, CostModelConfig
from repro_torch.engine.kv_cache import KVBlockPool, KVPoolConfig, PAGED_RESIDENT
from repro_torch.engine.metrics import (
    LatencyReport, MemoryReport, RobustnessReport, SLOReport, summarize,
    summarize_memory, summarize_robustness, summarize_slo,
)
from repro_torch.engine.sampler import SamplerConfig, sample_tokens
from repro_torch.kernels.swap import (
    swap_gather_pages, swap_gather_pages_q8, swap_scatter_pages,
    swap_scatter_pages_q8,
)
from repro_torch.models.model import Model, build_model
from repro_torch.models.transformer import torch_dtype
from repro_torch.robustness import FailoverStats, ReplicaHealth
from repro_torch.tracing import OFF, Tracer


@dataclass
class EngineConfig:
    n_slots: int = 16
    max_context: int = 1024
    chunk_buckets: Tuple[int, ...] = (1, 16, 32, 64, 128, 256)
    paged_kv: bool = True             # False: dense per-slot KV (A/B layout)
    kv_block_size: int = 16           # page size when the engine owns its pool
    # physical page-pool layout: "split" keeps separate K and V pools;
    # "fused" interleaves them on the head axis ([K0,V0,K1,V1,...]) so the
    # attention kernels read each key's K and V as one contiguous run and
    # a swap moves one payload tensor
    kv_layout: str = "split"
    pipelined: bool = True            # overlap schedule(N+1) with execute(N)
    # preemption mode: "recompute" discards a victim's KV (re-prefill from
    # scratch, the A/B default); "swap" stages it host-side and restores it
    # on re-schedule -- the scheduler picks per victim via the cost model
    preemption_mode: str = "recompute"
    # check each round's logits for NaN/Inf; the serve loop quarantines the
    # requests whose sampled logits are non-finite
    nan_guard: bool = False
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    seed: int = 0


def resolve_device(device) -> torch.device:
    """The engine's device; "cuda" without a usable card raises (no silent
    CPU fallback: the caller asks for the CPU explicitly)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev


def _pow2_bucket(n: int) -> int:
    """Smallest power of two >= n: swap page-id lists are padded to these
    buckets with the sink page, as the JAX engine pads them."""
    k = 1
    while k < n:
        k <<= 1
    return k


def _tree_map(fn, x):
    """``fn`` over a tensor or array, or over a (nested) tuple of them,
    keeping the structure: a swap payload is a tuple of staged arrays, one
    per cache tensor, or of ``(q, scales)`` pairs."""
    if isinstance(x, tuple):
        return tuple(_tree_map(fn, a) for a in x)
    return fn(x)


def _host_numpy(t: torch.Tensor) -> np.ndarray:
    """A numpy view of a host tensor; bf16, which numpy lacks, as its raw
    int16 bits (``torch.from_numpy(a).view(torch.bfloat16)`` undoes it)."""
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


class HostCopy:
    """Tensors on their way to the host: one round's sampled ids, or a
    swap-out's staged pages (a tuple, see ``_tree_map``).

    On a card: async device->host copies into pinned buffers owned by this
    object (so later work never overwrites them) and a CUDA event recorded
    after the last one; ``is_ready()`` polls the event.  On the CPU the
    tensors are already host-side."""

    def __init__(self, tensors):
        self._event = None
        self._host = _tree_map(self._start, tensors)
        if self._event is not None:
            self._event.record()

    def _start(self, t: torch.Tensor) -> torch.Tensor:
        if not t.is_cuda:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        self._event = self._event or torch.cuda.Event()
        return host

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def numpy(self):
        """Wait for the copies; numpy views of the host tensors, in the
        structure given."""
        if self._event is not None:
            self._event.synchronize()
        return _tree_map(_host_numpy, self._host)


@dataclass
class InflightRound:
    """One dispatched-but-undrained round: the device is executing (or has
    finished) it while the host schedules the next one.  ``toks`` is the
    readback of the sampled ids; ``sampled`` names the (request, slot) pairs
    whose token this round actually produced (decodes + prefill-completing
    chunks).  Under ``nan_guard`` ``toks`` also carries the per-slot finite
    mask, and ``drain`` fills ``nonfinite`` from it.  ``out_index`` records, per request, which position of
    ``output_tokens`` received this round's placeholder (filled by the serve
    loop after ``on_batch_done``); ``drain`` patches the real ids there."""
    toks: HostCopy
    sampled: List[Tuple[Request, int]]
    t_dispatch: float
    out_index: Dict[int, int] = field(default_factory=dict)
    finished: List[Request] = field(default_factory=list)
    prefill_ids: set = field(default_factory=set)   # this round's prefill reqs
    # req_ids whose sampled logits were non-finite (nan_guard; drain fills it)
    nonfinite: set = field(default_factory=set)
    # the batch this round executed -- a crash unwind enumerates its members
    batch: Optional[ScheduledBatch] = None
    # CUDA events around the replay while a tracer is on: the round's
    # device ms, read at drain
    events: Optional[Tuple[object, object]] = None
    # the MoE counter (experts read, expert rows, absent choices) copied to
    # the host before and after the replay while a tracer is on: the
    # round's counts
    moe_counts: Optional[Tuple[HostCopy, HostCopy]] = None


class TorchEngine:
    """Executes ScheduledBatches with real forward passes on ``device``."""

    def __init__(self, model_cfg: ModelConfig, cfg: Optional[EngineConfig] = None,
                 params=None, kv_pool: Optional[KVBlockPool] = None, *,
                 device="cuda", cuda_graphs: bool = True):
        """``cuda_graphs=False`` runs every round of a card eagerly (the
        A/B baseline of the compiled round); on the CPU rounds always run
        eagerly."""
        self.cfg = cfg or EngineConfig()
        assert self.cfg.kv_layout in ("split", "fused"), self.cfg.kv_layout
        assert self.cfg.paged_kv or self.cfg.kv_layout == "split", (
            "kv_layout='fused' requires paged_kv=True"
        )
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.model: Model = build_model(model_cfg)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
            params = self.model.init(gen, self.device)
        self.params = params
        self._gen = torch.Generator(device=self.device).manual_seed(
            self.cfg.seed + 1)
        # the rounds' cumulative (experts read, expert rows, real lanes'
        # choices of experts not held here), added to on the device by every
        # round (its graphs' too, so allocated before any capture); a tracer
        # reads it around each replay
        self._moe_counts = (torch.zeros(3, dtype=torch.long,
                                        device=self.device)
                            if model_cfg.moe is not None else None)
        # the compiled round: one RoundGraph per chunk bucket, all in one
        # memory pool (they never run at once), captured on a stream of
        # this engine's own (the decode kernels' ticket buffer is per
        # stream); each bucket's packed inputs live in a fixed buffer
        self.cuda_graphs = cuda_graphs and self.device.type == "cuda"
        self.graphs: Dict[int, graphs.RoundGraph] = {}
        self._graph_pool = None
        self._capture_stream = None
        self._round_inputs: Dict[int, torch.Tensor] = {}

        B = self.cfg.n_slots
        self.slot_of: Dict[int, int] = {}          # req_id -> slot
        self.free_slots = list(range(B - 1, -1, -1))

        # device-idle gap before each dispatch (the host bubble the pipeline
        # is built to close); fed by execute()/dispatch()
        self.bubble_ms: List[float] = []
        self._t_ready: Optional[float] = None
        # spans of dispatch and drain (a ReplicaServer hands its tracer
        # over; off by default)
        self.tracer = OFF
        # sync-mode mirror of the last drained round's nonfinite set, read by
        # ReplicaServer
        self.last_nonfinite: set = set()
        # nan_logits victims whose poisoned storage release() has still to
        # zero: req_id -> the poisoned block's index in its table (paged) or
        # the poisoned row (dense)
        self._poisoned: Dict[int, int] = {}
        # rounds dispatched per chunk bucket (C == 1: pure-decode rounds)
        self.bucket_rounds: Dict[int, int] = {}
        # swap-outs whose host copy has not been landed yet -- (staging
        # record, HostCopy of the staged pages); finalize_swaps()
        # attaches the payload to the record DIRECTLY (not through the
        # pool), so a record the disagg router prefetched into the handoff
        # store or a destination pool still finalizes
        self._pending_swaps: List[Tuple[object, HostCopy]] = []
        # pinned payloads uploaded without a host copy, each with the event
        # behind its copy (see _upload)
        self._uploading: List[Tuple[torch.Tensor, object]] = []

        self.kv_pool: Optional[KVBlockPool] = kv_pool
        # warmup() flips this: binding a pool afterwards reallocates the page
        # pool the warm-up ran against, so bind_kv_pool refuses
        self.warmed = False
        # the engine books blocks itself only while it owns a private pool;
        # an externally bound pool is booked by the scheduler
        self._owns_pool = False
        if self.cfg.paged_kv and self.kv_pool is None:
            bs = self.cfg.kv_block_size
            per_slot = math.ceil(self.cfg.max_context / bs) + 1
            self.kv_pool = KVBlockPool(KVPoolConfig(
                n_blocks=B * per_slot, block_size=bs,
            ))
            self._owns_pool = True
        self._build_state()

    # -- physical KV layout ----------------------------------------------------
    def _build_state(self) -> None:
        """Allocate the KV storage, ``lens``, ``last_token`` and the block
        tables for the bound pool, and drop every captured graph: they read
        the storage this replaces."""
        self.graphs.clear()
        self._graph_pool = None
        cfg, model_cfg = self.cfg, self.model_cfg
        B, S = cfg.n_slots, cfg.max_context
        hd = model_cfg.resolved_head_dim
        dt = torch_dtype(model_cfg.param_dtype)
        dev = self.device
        if cfg.paged_kv:
            bs = self.kv_pool.cfg.block_size
            # physical pages = pool blocks + 1 trailing sink page (padding
            # lanes scatter there; block tables also pad with it)
            self._n_phys = self.kv_pool.cfg.n_blocks + 1
            self._sink = self.kv_pool.cfg.n_blocks
            self.max_pages = math.ceil(S / bs) + 1
            n_kv = model_cfg.n_kv_heads * (2 if cfg.kv_layout == "fused" else 1)
            kv_shape = (model_cfg.n_layers, self._n_phys, bs, n_kv, hd)
            # device-resident block tables, one buffer rewritten in place
            # (the graphs read it); _bt_host mirrors exactly what the device
            # holds, _bt_len tracks per-slot entries already uploaded
            self._bt_host = np.full((B, self.max_pages), self._sink, np.int32)
            self._bt_len = np.zeros((B,), np.int32)
            self._bt_dirty: set = set()
            self.block_tables = torch.empty((B, self.max_pages),
                                            dtype=torch.int32, device=dev)
            self._copy_in(self.block_tables, self._bt_host)
        else:
            # one row per slot and position, plus a sink row per slot for
            # padding lanes (never attended: the step reads cache[:, :-1])
            kv_shape = (model_cfg.n_layers, B, S + 1, model_cfg.n_kv_heads, hd)
            self.block_tables = None
        # drop the old pool before allocating the new one (a rebind at full
        # width would otherwise hold two ~1.6 GB pools per tensor at once);
        # the keys are in swap payload order
        self.cache = None
        self.cache = {name: torch.zeros(kv_shape, dtype=dt, device=dev)
                      for name in self._cache_names()}
        self.lens = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.last_token = torch.zeros((B,), dtype=torch.int32, device=dev)

    def _cache_names(self) -> Tuple[str, ...]:
        """The cache dict's tensor keys, in swap payload order: the fused
        layout stores ONE head-interleaved pool, split stores two."""
        return ("kv",) if self.cfg.kv_layout == "fused" else ("k", "v")

    def _copy_in(self, dst: torch.Tensor, arr: np.ndarray) -> torch.Tensor:
        """Host numpy -> the device tensor ``dst``, in place, ordered on the
        stream after the work already enqueued there.  On a card the bytes
        go through a fresh pinned buffer from PyTorch's caching host
        allocator, which does not hand that buffer out again until the copy
        has completed -- so the caller may mutate ``arr`` at once and the
        copy never waits for the stream (a pageable blocking copy would sync
        the stream and serialise the pipelined loop)."""
        src = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return dst.copy_(src)
        pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        pinned.copy_(src)
        return dst.copy_(pinned, non_blocking=True)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host numpy -> a NEW device tensor, as ``_copy_in`` copies."""
        src = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return src.clone()
        if src.is_pinned():
            # a payload ``finalize_swaps`` landed: already pinned, so it
            # goes up without a host copy.  Its buffer returns to the host
            # allocator with no stream event when numpy drops it, so hold
            # it until this copy has completed.
            out = src.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            self._uploading = [(t, e) for t, e in self._uploading
                               if not e.query()]
            self._uploading.append((src, done))
            return out
        return self._copy_in(torch.empty(src.shape, dtype=src.dtype,
                                         device=self.device), arr)

    def _step(self, tokens, chunk_lens, use_last, sample_mask):
        """Forward + sampling + length update + device token feedback for one
        round, all enqueued on the device without a host sync.  The cache,
        ``lens`` and ``last_token`` are updated in place (the JAX engine
        donated those buffers to its jitted step).  Returns ``(toks,)``, or
        ``(toks, finite)`` under ``nan_guard``: per slot, whether every
        logit was finite."""
        # decode lanes consume the device-resident last sampled token (the
        # host staged a 0 there -- it may not know the id yet)
        tokens[:, 0] = torch.where(use_last, self.last_token, tokens[:, 0])
        impl = self.model.impl
        if self.cfg.paged_kv:
            logits = impl.chunked_step_paged(
                self.params, tokens, self.cache, self.lens, chunk_lens,
                self.block_tables, moe_counts=self._moe_counts)
        else:
            logits = impl.chunked_step(self.params, tokens, self.cache,
                                       self.lens, chunk_lens,
                                       moe_counts=self._moe_counts)
        toks = sample_tokens(logits, self._gen, self.cfg.sampler)
        self.last_token.copy_(torch.where(sample_mask, toks, self.last_token))
        self.lens.add_(chunk_lens)
        if self.cfg.nan_guard:
            return toks, torch.isfinite(logits).all(dim=-1)
        return (toks,)

    def _inputs(self, C: int) -> torch.Tensor:
        """Bucket ``C``'s fixed input buffer: the round's token ids (B, C),
        chunk lengths, ``use_last`` and ``sample_mask``, packed as int32 so
        that one copy fills it (its graph reads it where it lies)."""
        buf = self._round_inputs.get(C)
        if buf is None:
            B = self.cfg.n_slots
            buf = torch.zeros((B * C + 3 * B,), dtype=torch.int32,
                              device=self.device)
            self._round_inputs[C] = buf
        return buf

    def _packed_step(self, packed: torch.Tensor, C: int):
        """``_step`` on the round packed in ``packed`` (see ``_inputs``)."""
        B = self.cfg.n_slots
        return self._step(packed[: B * C].view(B, C),
                          packed[B * C: B * C + B],
                          packed[B * C + B: B * C + 2 * B].bool(),
                          packed[B * C + 2 * B:].bool())

    def capture(self, C: int) -> graphs.RoundGraph:
        """Capture bucket ``C``'s round as a CUDA graph.  First one eager
        round on the capture stream builds and loads the kernel libraries,
        allocates the decode kernels' ticket buffer for that stream and
        settles cuBLAS; it is an idle round (every lane masked), which
        writes zeros into the sinks only and leaves ``lens`` and
        ``last_token`` as they were, so a bucket first met mid-serve
        captures without disturbing the requests in flight."""
        packed = self._inputs(C)
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        packed.zero_()
        torch.cuda.synchronize(self.device)
        with torch.cuda.stream(self._capture_stream):
            self._packed_step(packed, C)
        torch.cuda.synchronize(self.device)
        sampling = self.cfg.sampler.temperature > 0.0
        graph = graphs.capture(lambda: self._packed_step(packed, C),
                               pool=self._graph_pool,
                               stream=self._capture_stream,
                               generator=self._gen if sampling else None)
        self.graphs[C] = graph
        return graph

    def bind_kv_pool(self, kv_pool: Optional[KVBlockPool]) -> None:
        """Adopt the serve loop's shared pool: the physical page array is
        rebuilt so page ids == the pool's block ids (the scheduler books
        blocks; the engine just follows the tables).  Must happen before any
        request is in flight."""
        if kv_pool is None or kv_pool is self.kv_pool:
            return
        assert not self.slot_of, "cannot rebind the KV pool mid-flight"
        if self.warmed and self.cfg.paged_kv:
            raise RuntimeError(
                "bind_kv_pool after warmup(): the rebuild reallocates the page "
                "pool the warm-up ran against -- bind the external pool "
                "FIRST, then call warmup()"
            )
        if kv_pool.cfg.host_kv_dtype == "int8" and not self.cfg.paged_kv:
            raise RuntimeError(
                "host_kv_dtype='int8' requires paged_kv: the quantized swap "
                "kernels are page-shaped"
            )
        self.kv_pool = kv_pool
        self._owns_pool = False
        if self.cfg.paged_kv:
            # page ids must equal the pool's block ids; the dense slots do
            # not depend on the pool
            self._build_state()

    def warmup(self, *, include_swap: Optional[bool] = None) -> None:
        """Run every chunk bucket once so serving rounds see steady-state
        latencies: the first round of each shape builds the CUDA kernels
        (nvcc, at first use), loads cuBLAS and settles the caching
        allocator; with ``cuda_graphs`` each bucket's round is captured
        (``capture``), as the JAX engine's warm-up compiles each bucket.
        The eager dummy rounds write only into the sink page (paged), or
        slot 0's first row (dense), which its next owner writes before
        reading; ``lens`` is reset afterwards.  When a paged engine can swap
        (``preemption_mode="swap"``) or the caller says it will export/import
        KV (``include_swap=True``, the disagg handoff path, which rides the
        swap kernels whatever the preemption mode), the swap kernels run once
        too; a dense swap moves slot rows with plain copies."""
        B = self.cfg.n_slots
        off = torch.zeros((B,), dtype=torch.bool, device=self.device)
        chunk_lens = torch.zeros((B,), dtype=torch.int32, device=self.device)
        chunk_lens[0] = 1
        for C in self.cfg.chunk_buckets:
            if self.cuda_graphs:
                if C not in self.graphs:
                    self.capture(C)
                continue
            tokens = torch.ones((B, C), dtype=torch.int32, device=self.device)
            self._step(tokens, chunk_lens, off, off)
        self.lens.zero_()
        if include_swap is None:
            include_swap = self.cfg.preemption_mode == "swap"
        if include_swap and self.cfg.paged_kv:
            self._prewarm_swap_kernels()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.warmed = True

    def _prewarm_swap_kernels(self) -> None:
        """Launch the swap gather and scatter the engine's swaps use once
        each, so the first real preemption -- or disagg handoff export or
        import -- does not load their libraries inside a serving round.  The
        JAX engine compiles one shape per page-id bucket here; a CUDA kernel
        takes every bucket without recompiling, so one sink-only id is
        enough: the gather reads the sink page and the scatter writes it
        back."""
        ids = torch.full((1,), self._sink, dtype=torch.int32,
                         device=self.device)
        for cache in self.cache.values():
            if self._host_quantized():
                q, scales = swap_gather_pages_q8(cache, ids)
                swap_scatter_pages_q8(cache, ids, q, scales)
            else:
                swap_scatter_pages(cache, ids, swap_gather_pages(cache, ids))

    # -- slot management -------------------------------------------------------
    def acquire_slot(self, req: Request) -> bool:
        """Late slot binding: called by the scheduler when it first commits a
        chunk for ``req``.  Returns True when the request holds a slot after
        the call.  The prefix-cache lookup happens HERE, not at admission:
        the dense layout copies the matched block payloads into the fresh
        slot; the paged layout's matched pages are already resident
        (zero-copy)."""
        if req.req_id in self.slot_of:
            return True
        if not self.free_slots:
            return False
        slot = self.free_slots.pop()
        self.slot_of[req.req_id] = slot
        if (self.kv_pool is not None and req.prefill_done == 0
                and not self.kv_pool.tables.get(req.req_id)):
            matched = self.kv_pool.match_prefix(req.req_id, require_payload=True)
            if matched > 0:
                req.prefill_done = matched
        # a scalar fill enqueued on the stream, ordered after any round
        # still running there (no host sync)
        self.lens[slot] = req.prefill_done
        if self.cfg.paged_kv:
            self._bt_host[slot, :] = self._sink
            self._bt_len[slot] = 0
            self._bt_dirty.add(slot)
        elif req.prefill_done > 0 and self.kv_pool is not None:
            self._restore_prefix_dense(req, slot)
        return True

    def release(self, req: Request) -> None:
        """Drop the request's slot (finish or preemption).  Idempotent.  With
        an engine-owned pool the request's blocks go back too."""
        slot = self.slot_of.pop(req.req_id, None)
        start = self._poisoned.pop(req.req_id, None)
        if slot is not None and start is not None:
            self._zero_poisoned(slot, start)
        if slot is not None and self.cfg.paged_kv:
            self._bt_host[slot, :] = self._sink
            self._bt_len[slot] = 0
            self._bt_dirty.add(slot)
        if slot is not None:
            self.free_slots.append(slot)
        if self._owns_pool:
            self.kv_pool.release(req.req_id)

    def has_capacity(self) -> bool:
        return len(self.free_slots) > 0

    # -- swap-out preemption (device<->host KV migration) ----------------------
    def _host_quantized(self) -> bool:
        """True when staged host pages are INT8 (pool ``host_kv_dtype``)."""
        return (self.kv_pool is not None
                and self.kv_pool.cfg.host_kv_dtype == "int8")

    def _swap_page_ids(self, req_id: int) -> Tuple[np.ndarray, int]:
        """The request's physical page ids, right-padded with the sink page
        to a power-of-two bucket (the staged payload's page count, as in the
        JAX engine).  Returns (padded ids, real count)."""
        table = self.kv_pool.tables.get(req_id, [])
        n = len(table)
        k = _pow2_bucket(max(n, 1))
        ids = np.full((k,), self._sink, np.int32)
        ids[:n] = table
        return ids, n

    def swap_out(self, req: Request) -> None:
        """Scheduler swapper hook: gather the victim's pages into one
        contiguous staging tensor per cache tensor (INT8 codes and scales
        under ``host_kv_dtype="int8"``) -- the dense layout copies its whole
        slot row instead -- start their async copy into pinned host memory,
        move the pool accounting to a SWAPPING staging record, and release
        the slot.  The gather runs on the current stream, after
        the round already enqueued there.  The payload becomes restorable
        only when ``finalize_swaps`` lands the copy -- the same
        one-round-late visibility the token readback has, so a
        mid-pipeline victim is never restored (or re-bound) in the round
        that is still copying its pages out."""
        pool = self.kv_pool
        slot = self.slot_of.get(req.req_id)
        assert slot is not None, f"swap_out of unbound req {req.req_id}"
        if self.cfg.paged_kv:
            ids, _n = self._swap_page_ids(req.req_id)
            d_ids = self._upload(ids)
            gather = (swap_gather_pages_q8 if self._host_quantized()
                      else swap_gather_pages)
            staged = tuple(gather(c, d_ids) for c in self.cache.values())
        else:
            # dense layout: a copy of the whole slot row (positions past the
            # stored length are never attended to after the restore), taken
            # on the stream before any later round writes the slot
            staged = tuple(c[:, slot].clone() for c in self.cache.values())
        copy = HostCopy(staged)
        # keep the RECORD, not just the id: finalize must find it wherever
        # the disagg router's prefetch may have moved it by then
        rec = pool.swap_out(req.req_id)        # state: SWAPPING
        self._pending_swaps.append((rec, copy))
        self.release(req)

    def finalize_swaps(self) -> None:
        """Land pending swap-out copies: wait for each staged tensor to be
        host-side (the copies were enqueued before the current round's step,
        so the wait is bounded) and attach numpy views of the pinned buffers
        to the staging records, which become SWAPPED_OUT.  The payload
        attaches to the record object itself -- under handoff PREFETCH the
        record may already sit in the ``KVHandoffStore`` or a destination
        pool's staging store.  Called from ``drain`` and by the serve loop
        when no round is in flight to piggyback on."""
        for rec, copy in self._pending_swaps:
            KVBlockPool.finalize_record(rec, copy.numpy())
        self._pending_swaps.clear()

    def has_pending_swaps(self) -> bool:
        return bool(self._pending_swaps)

    def _check_payload(self, req: Request, payload) -> int:
        """The staged page count of a payload that fits this engine's cache
        layout (one entry per cache tensor)."""
        assert payload is not None, f"restore of req {req.req_id} without payload"
        names = self._cache_names()
        assert len(payload) == len(names), (
            f"req {req.req_id}: payload arity {len(payload)} != cache layout "
            f"{names} -- swapped under a different kv_layout?"
        )
        first = payload[0][0] if isinstance(payload[0], tuple) else payload[0]
        return first.shape[1]

    def _scatter_payload(self, ids: np.ndarray, payload) -> None:
        """Upload each cache tensor's staged pages (through fresh pinned
        buffers: a pageable copy would block the host until the stream
        drains) and scatter them into pages ``ids``: a ``(q, scales)`` pair
        through the dequantizing scatter, a plain array through the fp
        one."""
        d_ids = self._upload(ids)
        for cache, staged in zip(self.cache.values(), payload):
            if isinstance(staged, tuple):
                q, scales = staged
                swap_scatter_pages_q8(cache, d_ids, self._upload(q),
                                      self._upload(scales))
            else:
                swap_scatter_pages(cache, d_ids,
                                   self._upload(staged).view(cache.dtype))

    def _restored(self, req: Request, slot: int) -> None:
        """After a scatter: the slot's table changed wholesale (force a full
        row rewrite) and its length is the pool's stored length."""
        self._bt_host[slot, :] = self._sink
        self._bt_len[slot] = 0
        self._bt_dirty.add(slot)
        self.lens[slot] = self.kv_pool.lens.get(req.req_id, 0)

    def swap_in(self, req: Request, payload) -> None:
        """Scheduler restorer hook, called right after ``pool.swap_in``
        rebuilt the request's table from fresh blocks: scatter the staged
        K/V into the new physical pages (paged) or copy the staged slot row
        into the freshly bound slot (dense) and restore the device-side
        length."""
        slot = self.slot_of.get(req.req_id)
        assert slot is not None, f"swap_in of unbound req {req.req_id}"
        staged_pages = self._check_payload(req, payload)
        if not self.cfg.paged_kv:
            for cache, staged in zip(self.cache.values(), payload):
                cache[:, slot] = self._upload(staged).view(cache.dtype)
            self.lens[slot] = self.kv_pool.lens.get(req.req_id, 0)
            return
        ids, n = self._swap_page_ids(req.req_id)
        assert n and ids.shape[0] == staged_pages, (
            f"req {req.req_id}: restore bucket {ids.shape[0]} != staged "
            f"{staged_pages}"
        )
        self._scatter_payload(ids, payload)
        self._restored(req, slot)

    @staticmethod
    def slice_swap_payload(payload, tail_start_blocks: int, n_blocks: int):
        """Trim a host-staged payload to its tail pages (partial swap-in):
        keep pages ``[tail_start_blocks, n_blocks)`` of every staged array
        -- page axis 1, real pages only; the pow2 padding is rebuilt for the
        tail's own scatter bucket (padded entries target the sink page, so
        their content is never read).  Returns fresh copies: the prefix
        pages' memory is released once the original payload drops."""
        k = n_blocks - tail_start_blocks
        kpad = _pow2_bucket(max(k, 1))

        def trim(a):
            a = np.asarray(a)
            out = np.zeros(a.shape[:1] + (kpad,) + a.shape[2:], a.dtype)
            out[:, :k] = a[:, tail_start_blocks:n_blocks]
            return out

        return _tree_map(trim, payload)

    def swap_in_tail(self, req: Request, payload,
                     tail_start_blocks: int) -> None:
        """Scheduler tail-restorer hook, called right after
        ``pool.swap_in_tail`` appended fresh blocks for the staged tail: the
        request re-prefilled blocks ``[0, tail_start_blocks)`` normally, so
        only the tail pages are scattered and the device length jumps to the
        record's full stored length."""
        slot = self.slot_of.get(req.req_id)
        assert slot is not None, f"swap_in_tail of unbound req {req.req_id}"
        assert self.cfg.paged_kv, "partial swap-in requires the paged layout"
        staged_pages = self._check_payload(req, payload)
        tail = self.kv_pool.tables.get(req.req_id, [])[tail_start_blocks:]
        assert tail, f"req {req.req_id}: empty tail restore"
        kpad = _pow2_bucket(len(tail))
        ids = np.full((kpad,), self._sink, np.int32)
        ids[: len(tail)] = tail
        assert kpad == staged_pages, (
            f"req {req.req_id}: tail bucket {kpad} != staged {staged_pages}"
        )
        self._scatter_payload(ids, payload)
        self._restored(req, slot)

    def poison_kv(self, req: Request) -> None:
        """Chaos hook (the ``nan_logits`` fault site): corrupt the request's
        OWN attended KV -- the row of its last cached token, in every layer
        -- so its next forward pass yields non-finite logits, exercising the
        numerics quarantine end to end.  Only PRIVATE storage is touched:
        shared prefix pages (refcount > 1) are skipped, so co-resident
        requests stay bit-identical to a fault-free run, and so are
        content-addressed ones, which a later prefix hit would read
        (``repro`` skips the shared ones only).  Reads the slot's
        device length, a host sync (on the chaos path only, as the JAX
        engine's ``device_get``)."""
        slot = self.slot_of.get(req.req_id)
        if slot is None:
            return
        written = int(self.lens[slot])
        if written <= 0:
            return
        if self.cfg.paged_kv:
            table = self.kv_pool.tables.get(req.req_id, [])
            if not table:
                return
            bs = self.kv_pool.cfg.block_size
            bi = min((written - 1) // bs, len(table) - 1)
            # pages other requests read now (shared) or may match later
            # (content-addressed) are left alone
            while bi >= 0 and (self.kv_pool._ref.get(table[bi], 1) > 1
                               or table[bi] in self.kv_pool._hash_of):
                bi -= 1
            if bi < 0:
                return           # no private page: nothing safe to poison
            for cache in self.cache.values():
                cache[:, table[bi]] = float("nan")
            self._poisoned[req.req_id] = bi
        else:
            for cache in self.cache.values():
                cache[:, slot, written - 1] = float("nan")
            self._poisoned[req.req_id] = written - 1

    def _zero_poisoned(self, slot: int, start: int) -> None:
        """Zero a released nan_logits victim's storage from its poisoned
        block (paged) or row (dense) on: the poison and what the victim's
        rounds wrote after it from NaN activations.  It runs as the slot
        frees -- the quarantine's shed, a crash unwind or a preemption --
        so it is ordered on the stream before any later round or swap-in
        can reuse the storage, and a NaN lane a later owner never
        overwrites cannot reach its attention (a plain attention's masked
        0 * NaN is NaN)."""
        if self.cfg.paged_kv:
            # poison_kv skipped content-addressed pages, which may follow
            # the poisoned one; a prefix hit may still read them
            row = self._bt_host[slot, start:self._bt_len[slot]]
            pages = [int(p) for p in row
                     if int(p) not in self.kv_pool._hash_of]
            if not pages:
                return
            ids = torch.tensor(pages, dtype=torch.long, device=self.device)
            for cache in self.cache.values():
                cache[:, ids] = 0
        else:
            for cache in self.cache.values():
                cache[:, slot, start:] = 0

    # -- prefix-cache payloads -------------------------------------------------
    def _restore_prefix_dense(self, req: Request, slot: int) -> None:
        """Dense layout only: copy a prefix-cache hit's stored K/V payloads
        into the request's slot so the skipped prefill positions hold
        numerically identical state (causal attention: prefix KV depends only
        on prefix tokens).  At bind time ``prefill_done`` is exactly the
        matched token count."""
        kv_pool = self.kv_pool
        bs = kv_pool.cfg.block_size
        n_matched = req.prefill_done // bs
        payloads = []
        for bid in kv_pool.tables.get(req.req_id, [])[:n_matched]:
            payload = kv_pool.payload(bid)
            assert payload is not None and payload is not PAGED_RESIDENT, (
                "dense engine prefix match requires parked payloads"
            )
            payloads.append(payload)
        if payloads:
            # one copy per cache tensor, not one per block
            for i, cache in enumerate(self.cache.values()):
                cache[:, slot, : n_matched * bs] = torch.cat(
                    [p[i] for p in payloads], dim=1)

    def capture_sealed(self, req: Request) -> None:
        """Make newly sealed (full, content-addressed) prompt blocks
        restorable by future prefix hits.  Dense layout: park device copies
        of the block's rows, enqueued on the stream after the round that
        wrote them (no host sync, even mid-pipeline).  Paged layout: the
        data already lives at the block's physical page, so a residency
        marker suffices."""
        kv_pool = self.kv_pool
        if kv_pool is None:
            return
        if self.cfg.paged_kv:
            for _idx, bid, _s, _e in kv_pool.take_newly_sealed(req.req_id):
                kv_pool.store_payload(bid, PAGED_RESIDENT)
            return
        slot = self.slot_of.get(req.req_id)
        if slot is None:
            return
        for _idx, bid, s, e in kv_pool.take_newly_sealed(req.req_id):
            kv_pool.store_payload(bid, tuple(
                c[:, slot, s:e].clone() for c in self.cache.values()))

    # -- one round ---------------------------------------------------------------
    def _bucket(self, c: int) -> int:
        for b in self.cfg.chunk_buckets:
            if c <= b:
                return b
        return self.cfg.chunk_buckets[-1]

    def _sync_block_tables(self, batch: ScheduledBatch) -> None:
        """Refresh scheduled requests' block-table rows from the pool with
        DIRTY-SLOT granularity: per-request tables only ever APPEND between
        binds, so the host mirror changes only when a row crossed a page,
        was bound or was released.  When any row changed, the whole (B,
        max_pages) table goes up in one small copy."""
        pool = self.kv_pool
        if self._owns_pool:
            for r, c in batch.prefill_chunks:
                pool.allocate(r.req_id, int(c))
            for r in batch.decode_reqs:
                pool.allocate(r.req_id, 1)
        for r in batch.decode_reqs + [q for q, _ in batch.prefill_chunks]:
            slot = self.slot_of[r.req_id]
            table = pool.tables.get(r.req_id, [])
            n = len(table)
            assert n <= self.max_pages, (
                f"req {r.req_id}: {n} blocks > {self.max_pages} pages"
            )
            seen = int(self._bt_len[slot])
            if slot in self._bt_dirty:
                self._bt_host[slot, :n] = table
                self._bt_host[slot, n:] = self._sink
            elif n > seen:
                self._bt_host[slot, seen:n] = table[seen:]
                self._bt_dirty.add(slot)
            self._bt_len[slot] = n
        if self._bt_dirty:
            self._copy_in(self.block_tables, self._bt_host)
            self._bt_dirty.clear()

    def _stage(self, batch: ScheduledBatch):
        """Host-side staging for one round: token ids, per-slot chunk
        lengths, and the two masks the step needs: which slots consume the
        device-resident ``last_token`` (decodes) and which slots' sampled
        token is meaningful this round (decodes + chunks that finish their
        prefill)."""
        B = self.cfg.n_slots
        max_chunk = max(
            [c for _, c in batch.prefill_chunks] + [1 if batch.decode_reqs else 0]
        )
        C = self._bucket(max_chunk)
        tokens = np.zeros((B, C), np.int32)
        chunk_lens = np.zeros((B,), np.int32)
        use_last = np.zeros((B,), np.bool_)
        sample_mask = np.zeros((B,), np.bool_)
        sampled: List[Tuple[Request, int]] = []

        for req in batch.decode_reqs:
            slot = self.slot_of[req.req_id]
            chunk_lens[slot] = 1
            if req.needs_replay:
                # first decode round after a restore: stage the last
                # delivered id from the host
                tokens[slot, 0] = req.output_tokens[-1]
                req.needs_replay = False
            else:
                use_last[slot] = True
            sample_mask[slot] = True
            sampled.append((req, slot))
        for req, c in batch.prefill_chunks:
            slot = self.slot_of[req.req_id]
            chunk = req.prompt_tokens[req.prefill_done : req.prefill_done + c]
            tokens[slot, : len(chunk)] = chunk
            chunk_lens[slot] = len(chunk)
            if req.remaining_prefill - c <= 0:  # prefill completes this round
                sample_mask[slot] = True
                sampled.append((req, slot))
        return tokens, chunk_lens, use_last, sample_mask, sampled

    def dispatch(self, batch: ScheduledBatch) -> InflightRound:
        """Stage and launch one round WITHOUT waiting for it: the step
        (forward + sampling + length update) is enqueued -- one replay of
        the bucket's graph, or eagerly -- while the caller goes back to
        scheduling.  The sampled-token readback (with the finite mask under
        ``nan_guard``) starts as an async device->host copy of the step's
        outputs, enqueued before any later round can overwrite them;
        ``drain`` collects it one round later."""
        tr = self.tracer
        if tr.on:
            span = tr.open("engine.dispatch", round=batch.round_idx)
            part = tr.open("engine.stage")
        tokens, chunk_lens, use_last, sample_mask, sampled = self._stage(batch)
        C = tokens.shape[1]
        if tr.on:
            keys = self._keys_read(batch)
            tr.close(part)
            part = tr.open("engine.upload")
        if self.cfg.paged_kv:
            self._sync_block_tables(batch)
        graph = None
        if self.cuda_graphs:
            # a bucket met before any warm-up is captured now, as jax.jit
            # compiles at the first call (before its inputs are copied in:
            # the capture runs an idle round on the same buffer)
            graph = self.graphs.get(C) or self.capture(C)
        # one copy for the round's four small arrays into the bucket's
        # fixed buffer (stream-ordered after the round that last read it)
        packed = self._copy_in(self._inputs(C), np.concatenate([
            tokens.reshape(-1), chunk_lens,
            use_last.astype(np.int32), sample_mask.astype(np.int32)]))
        events = None
        if tr.on:
            tr.close(part)
            part = tr.open("engine.replay")
            if self.device.type == "cuda":
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
        t_dispatch = time.perf_counter()
        if self._t_ready is not None:
            self.bubble_ms.append((t_dispatch - self._t_ready) * 1e3)
        moe = tr.on and self._moe_counts is not None
        if events is not None:
            events[0].record()
        if moe:
            moe_before = HostCopy(self._moe_counts.clone())
        out = graph.replay() if graph is not None else self._packed_step(packed, C)
        if events is not None:
            events[1].record()
        # (before the ids' copy, whose event the drain waits on)
        moe_counts = ((moe_before, HostCopy(self._moe_counts.clone()))
                      if moe else None)
        toks = HostCopy(out)
        self.bucket_rounds[C] = self.bucket_rounds.get(C, 0) + 1
        if tr.on:
            tr.close(part)
            tr.close(span, C=C, prefill_tokens=batch.prefill_tokens,
                     decode_tokens=batch.decode_tokens, sampled=len(sampled),
                     **keys)
        return InflightRound(toks=toks, sampled=sampled, t_dispatch=t_dispatch,
                             batch=batch, events=events, moe_counts=moe_counts)

    def drain(self, inflight: InflightRound) -> float:
        """Block until the round's sampled ids are host-side, then patch the
        REAL token values into the requests' bookkeeping (placeholders were
        recorded by ``on_batch_done`` while the round executed): delivered
        outputs, ``next_token``, and -- via ``patch_token`` -- any copy a
        preemption already folded into a recompute prompt.  Returns
        dispatch->drain wall ms (device time plus whatever host work it
        overlapped)."""
        tr = self.tracer
        if tr.on:
            span = tr.open("engine.drain", round=inflight.batch.round_idx)
            wait = tr.open("engine.drain.wait")
        toks, *finite = inflight.toks.numpy()
        self._t_ready = time.perf_counter()
        if tr.on:
            tr.close(wait)
        wall_ms = (self._t_ready - inflight.t_dispatch) * 1e3
        if finite:
            inflight.nonfinite = {
                req.req_id for req, slot in inflight.sampled
                if not finite[0][slot]
            }
        # sync-mode mirror (execute() discards the InflightRound): the serve
        # loop reads the quarantine set of the round it just executed here
        self.last_nonfinite = inflight.nonfinite
        # swap-out staging retires on the same one-round-late path: gathers
        # enqueued before this round's step are host-side by now (or the
        # event wait bounds it)
        self.finalize_swaps()
        for req, slot in inflight.sampled:
            tok = int(toks[slot])
            req.next_token = tok
            idx = inflight.out_index.get(req.req_id)
            if idx is not None:
                req.patch_token(idx, tok)
        if tr.on:
            # the readback waited for the copy queued after the graph on
            # the same stream: both events have completed
            attrs = ({} if inflight.events is None else
                     {"device_ms": inflight.events[0].elapsed_time(inflight.events[1])})
            if inflight.moe_counts is not None:
                before, after = (c.numpy() for c in inflight.moe_counts)
                (attrs["experts_read"], attrs["expert_rows"],
                 attrs["absent_choices"]) = (int(n) for n in after - before)
            tr.close(span, wall_ms=wall_ms, **attrs)
        return wall_ms

    def _keys_read(self, batch: ScheduledBatch) -> Dict[str, int]:
        """The keys the round's attention reads, summed over the layers, by
        kind: ``window_keys`` over the sliding-window layers, ``full_keys``
        over the others; and ``window_context_keys``, what the
        sliding-window layers would read without their windows.  A row with
        ``c`` keys cached that brings ``n`` reads the ``c + n`` keys of its
        context under full attention, and under a window ``W`` the ``min(c
        + n, W + n - 1)`` that its queries' windows cover."""
        rows = [(r.context_len - 1, 1) for r in batch.decode_reqs]
        rows += [(r.prefill_done, int(c)) for r, c in batch.prefill_chunks]
        mcfg = self.model_cfg
        keys = {"window_keys": 0, "full_keys": 0, "window_context_keys": 0}
        if mcfg.family == "ssm":
            return keys
        for l in range(0, mcfg.n_layers, mcfg.attn_every or 1):
            W = mcfg.window(l)
            if W:
                keys["window_keys"] += sum(min(c + n, W + n - 1)
                                           for c, n in rows)
                keys["window_context_keys"] += sum(c + n for c, n in rows)
            else:
                keys["full_keys"] += sum(c + n for c, n in rows)
        return keys

    def execute(self, batch: ScheduledBatch) -> float:
        """Synchronous round (``pipelined=False`` A/B path): dispatch and
        drain back-to-back; returns wall latency in ms."""
        return self.drain(self.dispatch(batch))


@dataclass
class ServeResult:
    report: LatencyReport
    requests: List[Request]
    rounds: int
    wall_s: float
    samples: Optional[Tuple[np.ndarray, np.ndarray]] = None
    outputs: Optional[Dict[int, List[int]]] = None
    memory: Optional[MemoryReport] = None     # KV pool lifecycle summary
    host_bubble_ms: Optional[List[float]] = None   # device-idle gap per round
    slo: Optional[SLOReport] = None           # per-tenant attainment gauges
    robustness: Optional["RobustnessReport"] = None  # chaos/fault summary


def compress_idle_gap(pending: List[Request], next_i: int, now: float) -> None:
    """Jump the idle gap to the next arrival by shifting ALL future arrivals
    by the same constant, so inter-arrival gaps — and therefore arrival-order
    and aging behavior — are preserved mid-run."""
    offset = now - pending[next_i].arrival_time
    for j in range(next_i, len(pending)):
        pending[j].arrival_time += offset


class ReplicaServer:
    """One replica's continuous-batching state machine: the body of
    ``serve()`` factored into admit/step/drain pieces so a multi-replica
    driver (``repro.disagg.DisaggregatedRouter``) can interleave several
    engines — each with its own scheduler and pool — inside one host loop,
    while single-replica ``serve()`` stays a thin wrapper.

    ``step(now)`` runs at most one scheduling round and reports what
    happened:
      * ``"round"``     — a batch was dispatched (pipelined) or executed
      * ``"drained"``   — progress was made by draining the in-flight round
      * ``"finalized"`` — pending swap-out copies were landed (no round ran)
      * ``"starved"``   — runnable work exists but nothing could be placed
      * ``"idle"``      — no queued or in-flight work at all

    Value-dependent stop tokens (``Request.stop_token``) are honored here,
    not in ``receive_token``: a pipelined engine learns token VALUES one
    round late, so the stop is applied at drain time — by which point the
    request may already be booked into the next, not-yet-dispatched round
    (unwound via ``scheduler.on_stop``, which also refunds the
    over-scheduled round's KV booking), preempted, or mid-handoff.  Greedy
    outputs stay bit-identical to the synchronous engine, which observes the
    same stop in the same round's ``on_batch_done``.
    """

    def __init__(
        self,
        scheduler: ChunkedPrefillScheduler,
        engine: TorchEngine,
        *,
        kv_pool: Optional[KVBlockPool] = None,
        collect_samples: bool = False,
        on_prefill_complete=None,
        on_stopped=None,
        name: str = "replica",
        tracer: Optional[Tracer] = None,
    ):
        self.sched = scheduler
        self.engine = engine
        # spans of this replica's loop, scheduler and engine (None: off)
        self.tracer = tracer or OFF
        scheduler.tracer = engine.tracer = self.tracer
        self.kv_pool = kv_pool
        self.collect_samples = collect_samples
        # multi-replica hook: called once per request in the round its
        # prefill completed (state DECODING, first token bookkept) — the
        # disaggregated router decides there whether to export the KV
        self.on_prefill_complete = on_prefill_complete
        # multi-replica hook: called after a value-dependent stop is applied
        # (scheduler.on_stop already ran) — the router chases a prefetched
        # handoff record to whatever pool it moved on to and unwinds it there
        self.on_stopped = on_stopped
        self.name = name
        self.pipelined = engine.cfg.pipelined
        self.inflight: Optional[InflightRound] = None
        self.rounds = 0
        self.outputs: Dict[int, List[int]] = {}
        # fault tolerance (repro.robustness): an attached injector fires
        # seeded chaos sites inside step(); fault_tolerant converts any
        # exception out of a round into a crash unwind + "error" status
        # instead of tearing down the serve loop
        self.injector = None
        self.fault_tolerant = False
        self.last_error: Optional[BaseException] = None
        self.crash_unwinds = 0
        self.crash_requeued = 0
        # local retry bound: a request requeued by _crash_cleanup more than
        # max_crash_retries times sheds terminally instead of cycling — on a
        # single replica there is no fleet to fail over to, and a repeating
        # crash site must not livelock the serve loop (None = unbounded)
        self.max_crash_retries: Optional[int] = None
        self._crash_retries: Dict[int, int] = {}
        self.crash_shed: List[Request] = []
        self.quarantined: List[Request] = []
        # torn-round bookkeeping for _crash_cleanup: the round being drained
        # (popped off self.inflight but not yet patched/delivered) and the
        # batch scheduled-but-not-yet-retired by on_batch_done
        self._draining: Optional[InflightRound] = None
        self._pending_batch: Optional[ScheduledBatch] = None
        self.feats: List[np.ndarray] = []
        self.lats: List[float] = []
        self.t_start = time.perf_counter()

        if kv_pool is not None:
            if scheduler.kv_pool is None:
                # the scheduler books blocks chunk-granularly inside schedule()
                scheduler.attach_kv_pool(kv_pool)
            engine.bind_kv_pool(kv_pool)
        # slots bind at first schedule and free at preemption, not admission
        scheduler.attach_slot_binder(engine.acquire_slot, releaser=engine.release)
        if scheduler.kv_pool is not None and scheduler.kv_booking:
            # preemption mode comes from the ENGINE config (it owns the
            # physical swap path); the deterministic cost model prices swap
            # bytes vs recompute FLOPs per victim
            scheduler.attach_swap(
                engine.swap_out, engine.swap_in,
                cost_model=CostModel(CostModelConfig(noise_std=0.0)),
                mode=engine.cfg.preemption_mode,
                restorer_tail=engine.swap_in_tail,
                payload_slicer=engine.slice_swap_payload,
            )
        # bubble accounting is per-serve: drop any history (and the
        # ready-stamp of a previous serve, which would read as one giant
        # inter-serve bubble)
        engine.bubble_ms = []
        engine._t_ready = None

    # -- clock ----------------------------------------------------------------
    def start(self, t_start: float) -> None:
        """Anchor this replica's clock (a multi-replica driver shares one)."""
        self.t_start = t_start

    def _now(self) -> float:
        return time.perf_counter() - self.t_start

    # -- intake ---------------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Admit one request: pool registration (tenant + prompt hashes
        only — the prefix-cache MATCH waits for first slot bind, so a parked
        backlog pins no cached blocks and no tenant quota) plus scheduler
        submission."""
        if self.kv_pool is not None:
            self.kv_pool.register_request(
                req.req_id, tenant=req.tenant,
                prompt_tokens=req.prompt_tokens, prompt_len=req.prompt_len,
            )
        if not self.sched.submit(req):         # admission-rejected: give back
            if self.kv_pool is not None:
                self.kv_pool.release(req.req_id)
        elif self.tracer.on:
            self.tracer.queue_open(req.req_id)

    def adopt_handoff(self, req: Request, rec, reg) -> None:
        """Decode-pool side of a cross-replica handoff: land the exported
        staging record in this replica's pool and enqueue the request.  The
        ordinary swap-restore path inside ``schedule()`` then binds a slot,
        re-charges the tenant's quota, scatters the payload, and resumes the
        request decode-only (``needs_replay`` stages its last delivered
        token) — no prefill chunk is ever scheduled for it here."""
        self.kv_pool.import_swap(req.req_id, rec, reg)
        self.sched.submit_handoff(req)

    # -- introspection ---------------------------------------------------------
    def has_work(self) -> bool:
        return self.sched.has_work()

    def has_inflight(self) -> bool:
        return self.inflight is not None

    def busy(self) -> bool:
        return (self.sched.has_work() or self.inflight is not None
                or self.engine.has_pending_swaps())

    def outstanding_work(self) -> int:
        """Tokens of runnable work currently on this replica (prefill left +
        decode left over queued/decoding requests) — the router's load key."""
        total = 0
        for r in self.sched.queue.requests():
            total += r.remaining_prefill + (r.max_new_tokens - r.generated)
        for r in self.sched._decoding.values():
            total += r.remaining_prefill + (r.max_new_tokens - r.generated)
        return total

    def tenant_outstanding(self, tenant: str) -> int:
        total = 0
        for r in list(self.sched.queue.requests()) + list(
                self.sched._decoding.values()):
            if r.tenant == tenant:
                total += r.remaining_prefill + (r.max_new_tokens - r.generated)
        return total

    # -- one scheduling round --------------------------------------------------
    def step(self, now: float) -> str:
        """Run one round, optionally under the fault boundary: chaos sites
        fire here and — when ``fault_tolerant`` — any exception out of the
        round (injected or real) is converted into a crash unwind plus an
        ``"error"`` status the health machinery consumes, instead of tearing
        down the whole serve loop."""
        if not self.tracer.on:
            return self._step_guarded(now)
        tr = self.tracer
        span = tr.open("serve.step")
        status = self._step_guarded(now)
        # a step that neither scheduled nor drained records nothing
        tr.close(span, drop_if_empty=True, status=status,
                 round=self.sched._round - 1 if status == "round" else -1)
        return status

    def _step_guarded(self, now: float) -> str:
        if self.injector is None and not self.fault_tolerant:
            return self._step_impl(now)
        try:
            inj = self.injector
            if inj is not None:
                spec = inj.fire("slow_round_ms", replica=self.name)
                if spec is not None:
                    time.sleep(max(spec.value, 0.0) / 1e3)
                inj.maybe_raise("replica_step_crash", replica=self.name)
            return self._step_impl(now)
        except Exception as e:  # noqa: BLE001 — the replica fault boundary
            if not self.fault_tolerant:
                raise
            self.last_error = e
            self._crash_cleanup()
            return "error"

    def _step_impl(self, now: float) -> str:
        sched, engine = self.sched, self.engine
        drained_eagerly = False
        if self.inflight is not None and self.inflight.toks.is_ready():
            # device already finished: drain before (not after) the next
            # schedule — tokens/timestamps stamp at true readiness and the
            # bubble metric doesn't hide idle time behind the overlap
            self._drain_inflight()
            drained_eagerly = True
        if not sched.has_work():
            if self.inflight is not None:
                self._drain_inflight()
                return "drained"
            if engine.has_pending_swaps():
                # an exported (handoff) request's gather can be the only
                # pending work on this replica — land it so the router can
                # move the staged record on
                engine.finalize_swaps()
                return "finalized"
            # an eager drain above counts as progress — it may have just
            # finalized an exported gather the router is waiting on, so
            # "idle" (a quiesce signal) would be premature this step
            return "drained" if drained_eagerly else "idle"

        # preemption victims' slots were already freed inside schedule() (the
        # releaser hook) — a victim may even have re-bound a fresh slot and
        # been rescheduled within the same round, so do NOT release here.
        # In pipelined mode this schedule overlaps the in-flight round.
        batch = sched.schedule(now)
        if batch.is_empty():
            if self.inflight is not None:
                self._drain_inflight()
                return "drained"
            if engine.has_pending_swaps():
                # nothing in flight to piggyback the staging drain on (e.g.
                # every runnable request is a SWAPPING victim): finalize now
                # so the next schedule() round can restore them
                engine.finalize_swaps()
                return "finalized"
            return "drained" if drained_eagerly else "starved"

        # the batch is booked and counted but not yet retired: a crash
        # anywhere before on_batch_done must strip it back out of the stats
        self._pending_batch = batch
        if self.injector is not None:
            for r in batch.decode_reqs:
                if self.injector.fire("nan_logits", replica=self.name,
                                      req_id=r.req_id) is not None:
                    engine.poison_kv(r)

        if self.pipelined:
            if self.inflight is not None:
                # round N-1's ids land BEFORE round N+1 stages anything that
                # could embed them (a preemption fold re-prefills delivered
                # tokens) — this is the pipeline's one-round visibility lag.
                # The just-scheduled batch rides along so a late stop can be
                # unwound from it before it dispatches.
                self._drain_inflight(pending_batch=batch)
            self.inflight = engine.dispatch(batch)
            wall_ms = None
        else:
            wall_ms = engine.execute(batch)
        if self.kv_pool is not None:
            # newly sealed (full, hashed) prompt blocks become restorable
            for r, _c in batch.prefill_chunks:
                engine.capture_sealed(r)
        if self.collect_samples:
            self.feats.append(batch.state.features())
            if wall_ms is not None:
                self.lats.append(wall_ms)
        self.rounds += 1

        now2 = self._now()
        sched.on_batch_done(batch, now2)       # releases finished KV refs
        self._pending_batch = None             # retired: charged and counted

        # sync-mode numerics quarantine: execute() drained inside the round,
        # so the finite mask is already host-visible.  Roll back the poisoned
        # token (its charge refunds), shed terminally, deliver the clean
        # prefix.  Pipelined mode does the same one round late, at drain.
        if not self.pipelined and engine.last_nonfinite:
            prefill_ids = {q.req_id for q, _ in batch.prefill_chunks}
            for r in batch.decode_reqs + [q for q, _ in batch.prefill_chunks]:
                if r.req_id not in engine.last_nonfinite:
                    continue
                if r.rollback_undrained(1):
                    sched.refund_rolled_back(
                        r, first_token=r.req_id in prefill_ids)
                sched.shed_request(r, reason="numerics")
                self.outputs[r.req_id] = list(r.output_tokens)
                self.quarantined.append(r)
                if self.on_stopped is not None:
                    self.on_stopped(self, r)

        if self.pipelined:
            # the placeholder each sampled request just received sits at the
            # tail of its output_tokens; drain() patches the real id there
            for req, _slot in self.inflight.sampled:
                self.inflight.out_index[req.req_id] = len(req.output_tokens) - 1
            # sampled ∩ prefill = chunks that completed their prefill this
            # round: their prefill_end_time re-stamps at drain
            self.inflight.prefill_ids = {r.req_id for r, _ in batch.prefill_chunks}

        for r in batch.decode_reqs + [q for q, _ in batch.prefill_chunks]:
            self.outputs.setdefault(r.req_id, [])
            if r.state == RequestState.FINISHED:
                if self.pipelined:
                    self.inflight.finished.append(r)
                else:
                    self.outputs[r.req_id] = list(r.output_tokens)
                engine.release(r)

        if not self.pipelined:
            # synchronous engine: token values are already real (execute()
            # drains internally), so stops and per-token timestamps apply in
            # the same round
            for r in batch.decode_reqs + [q for q, _ in batch.prefill_chunks]:
                if r.req_id in engine.last_nonfinite:
                    continue       # quarantined above: its token rolled back
                if r.remaining_prefill == 0 and r.output_tokens:
                    r.token_times.append(now2)
                if (r.stop_token is not None
                        and r.state == RequestState.DECODING
                        and r.output_tokens
                        and r.output_tokens[-1] == r.stop_token):
                    r.finish_stopped(now2)
                    self.outputs[r.req_id] = list(r.output_tokens)
                    sched.on_stop(r)
                    if self.on_stopped is not None:
                        self.on_stopped(self, r)

        if self.on_prefill_complete is not None:
            for r, _c in batch.prefill_chunks:
                if r.state == RequestState.DECODING and r.remaining_prefill == 0:
                    self.on_prefill_complete(self, r)
        return "round"

    # -- drain -----------------------------------------------------------------
    def _drain_inflight(self, pending_batch: Optional[ScheduledBatch] = None) -> None:
        inflight, self.inflight = self.inflight, None
        # visible to _crash_cleanup until this round is fully delivered: a
        # crash inside drain/stop processing must unwind it, not strand it
        self._draining = inflight
        wall_ms = self.engine.drain(inflight)
        if self.collect_samples:
            self.lats.append(wall_ms)
        tr = self.tracer
        if tr.on:
            span = tr.open("serve.deliver", round=inflight.batch.round_idx)
        # timestamps recorded against the placeholder `now` are re-stamped to
        # the moment the ids actually became host-visible — the earliest a
        # client could receive them — so pipelined LatencyReports are not
        # systematically understated vs the synchronous engine's
        now_v = self._now()
        # numerics quarantine FIRST: a request whose sampled logits were
        # non-finite must not stamp, deliver, or stop on the garbage id.  The
        # poisoned placeholder rolls back (charge refunded), the request
        # sheds terminally, and its clean delivered prefix is the output.
        for req, _slot in inflight.sampled:
            if req.req_id not in inflight.nonfinite:
                continue
            if req in inflight.finished:
                inflight.finished.remove(req)
            if req.rollback_undrained(1):
                self.sched.refund_rolled_back(
                    req, first_token=req.req_id in inflight.prefill_ids)
            self.sched.shed_request(
                req, reason="numerics", batch=pending_batch)
            self.outputs[req.req_id] = list(req.output_tokens)
            self.quarantined.append(req)
            if self.on_stopped is not None:
                self.on_stopped(self, req)
        for req, _slot in inflight.sampled:
            if req.req_id in inflight.nonfinite:
                continue
            if inflight.out_index.get(req.req_id) == 0:
                req.first_token_time = now_v
            if req.req_id in inflight.prefill_ids:
                req.prefill_end_time = now_v
            req.token_times.append(now_v)
        for r in inflight.finished:
            r.finish_time = now_v
            # patched ids are final only now — deliver them
            self.outputs[r.req_id] = list(r.output_tokens)
        # value-dependent stops, one round late: only now are the sampled ids
        # real.  A stopping request may meanwhile have been booked into the
        # next round (pending_batch — scheduled but not yet dispatched),
        # preempted to the queue, swap-staged, or exported for a handoff;
        # on_stop unwinds each of those (the over-scheduled round's KV
        # booking is refunded with the release).
        for req, _slot in inflight.sampled:
            if req.stop_token is None or req.state == RequestState.FINISHED:
                continue
            idx = inflight.out_index.get(req.req_id)
            if idx is None or req.output_tokens[idx] != req.stop_token:
                continue
            req.finish_stopped(now_v)
            self.outputs[req.req_id] = list(req.output_tokens)
            self.sched.on_stop(req, pending_batch)
            if self.on_stopped is not None:
                self.on_stopped(self, req)
        self._draining = None
        if tr.on:
            tr.close(span, tokens=sum(req.req_id not in inflight.nonfinite
                                      for req, _slot in inflight.sampled))

    # -- crash unwind ----------------------------------------------------------
    def _crash_cleanup(self) -> None:
        """A step crashed somewhere between scheduling and delivery: unwind
        the torn round(s) so this replica (or, after failover, its
        survivors) can carry on without leaking slots, KV blocks, or phantom
        VTC charges.

        Up to three torn artifacts can exist:
          * ``_draining``      — a round popped by ``_drain_inflight`` that
                                 crashed before its tokens were delivered,
          * ``self.inflight``  — a round dispatched but never drained,
          * ``_pending_batch`` — a batch scheduled (KV booked, stats counted)
                                 whose ``on_batch_done`` never ran.

        Undrained placeholder tokens roll back and their charge refunds (the
        values never became host-visible; greedy recompute regenerates them
        bit-identically).  Every involved live request is then evicted from
        the scheduler, folded via ``preempt()`` (at-most-once delivery), and
        re-queued locally.  Already-delivered requests are left alone."""
        torn: List[InflightRound] = []
        if self._draining is not None:
            torn.append(self._draining)
            self._draining = None
        if self.inflight is not None:
            torn.append(self.inflight)
            self.inflight = None
        pending = self._pending_batch
        self._pending_batch = None

        victims: Dict[int, Request] = {}
        for infl in torn:
            for req, _slot in infl.sampled:
                victims[req.req_id] = req
            for req in infl.finished:
                victims[req.req_id] = req
            if infl.batch is not None:
                for req in infl.batch.decode_reqs:
                    victims[req.req_id] = req
                for req, _c in infl.batch.prefill_chunks:
                    victims[req.req_id] = req
        if pending is not None:
            for req in pending.decode_reqs:
                victims[req.req_id] = req
            for req, _c in pending.prefill_chunks:
                victims[req.req_id] = req

        for infl in torn:
            for req, _slot in infl.sampled:
                if infl.out_index.get(req.req_id) is None:
                    continue   # crash hit before the placeholder bookkeeping
                if (req.state == RequestState.FINISHED
                        and self.outputs.get(req.req_id)):
                    continue   # fully delivered before the crash: irrevocable
                if req.rollback_undrained(1):
                    self.sched.refund_rolled_back(
                        req, first_token=req.req_id in infl.prefill_ids)

        for req in victims.values():
            if req.state == RequestState.FINISHED:
                continue       # delivered, stopped, or shed before the crash
            if (self.kv_pool is not None
                    and req.req_id not in self.kv_pool._reg
                    and self.kv_pool.swap_state(req.req_id) is None
                    and not self.kv_pool.tables.get(req.req_id)):
                # no longer owned here: the round that tore also completed
                # this request's prefill and the router exported its handoff
                # (export_swap popped the registration) before the crash.
                # Its placeholder rolled back above; the handoff pipeline (or
                # the router's failover retraction, if this replica is dying)
                # owns its fate now.
                continue
            k = self._crash_retries.get(req.req_id, 0) + 1
            self._crash_retries[req.req_id] = k
            if (self.max_crash_retries is not None
                    and k > self.max_crash_retries):
                self.sched.shed_request(
                    req, reason="replica_failure", batch=pending)
                self.outputs[req.req_id] = list(req.output_tokens)
                self.crash_shed.append(req)
                continue
            self.sched.evict_request(req, pending)
            req.preempt()
            if self.kv_pool is not None:
                self.kv_pool.register_request(
                    req.req_id, tenant=req.tenant,
                    prompt_tokens=req.prompt_tokens,
                    prompt_len=req.prompt_len,
                )
            self.sched.requeue_failed(req)
            self.crash_requeued += 1
        self.crash_unwinds += 1

    def finish(self) -> None:
        """End-of-serve cleanup: drain the last round and land any pending
        swap copies (no staging entry is left mid-flight at exit)."""
        if self.inflight is not None:
            self._drain_inflight()
        self.engine.finalize_swaps()


def serve(
    requests: List[Request],
    scheduler: ChunkedPrefillScheduler,
    engine: TorchEngine,
    *,
    kv_pool: Optional[KVBlockPool] = None,
    collect_samples: bool = False,
    realtime_arrivals: bool = False,
    max_rounds: int = 200_000,
    robustness=None,
    tracer: Optional[Tracer] = None,
) -> ServeResult:
    """Continuous-batching serve loop over real execution.

    Admission hands requests straight to the scheduler — an engine slot is
    bound only when the scheduler first commits a chunk (late binding, via
    the slot-binder hook), so queued or admission-delayed backlog can never
    pin slots.

    With ``EngineConfig(pipelined=True)`` (default) the loop runs as a
    two-stage pipeline: while the device executes round N, the host runs
    admission + ``schedule()`` (aging, VTC, KV booking, preemption) for
    round N+1 and drains round N's sampled ids as an async copy — round N's
    token VALUES become host-visible one round late, which is fine because
    round bookkeeping (chunk deliveries, length-capped termination) is
    value-independent and the values themselves are only needed for
    delivered outputs, stop-token termination, and preemption folds, all
    patched/applied at drain time before anything is staged from them.
    ``collect_samples`` latencies in pipelined mode are dispatch->drain
    walls (device time plus overlapped host work).

    The loop body lives in ``ReplicaServer`` (one replica's admit/step/drain
    state machine); this wrapper owns only arrival admission and idle-gap
    handling.  realtime_arrivals=False (default) admits requests by the
    engine's own clock (wall time since start), compressing idle gaps —
    deterministic and fast for tests; True sleeps to honor arrival times.
    ``tracer`` (``repro_torch.tracing``) records the loop's spans.
    """
    pending = sorted(requests, key=lambda r: r.arrival_time)
    for r in pending:
        assert r.prompt_tokens is not None, "attach_prompt_tokens() first"
    server = ReplicaServer(
        scheduler, engine, kv_pool=kv_pool, collect_samples=collect_samples,
        tracer=tracer,
    )
    if robustness is not None:
        # colocated fault tolerance: crash unwinds + NaN quarantine survive
        # in-place (there is no second replica to fail over to — replica
        # death/failover lives in the disaggregated router)
        server.fault_tolerant = True
        server.injector = robustness.make_injector()
        server.max_crash_retries = robustness.max_retries
    # the same health machine the fleet router runs, over the lone replica:
    # a persistent fault (a repeat-crash site, a wedged device) must not
    # spin the serve loop forever — once DEAD, remaining work sheds
    # terminally (exactly-once termination with no fleet to fail over to)
    health = (ReplicaHealth(robustness.health, "replica0")
              if robustness is not None else None)
    next_i = 0
    t_start = time.perf_counter()
    server.start(t_start)
    now = 0.0

    while server.rounds < max_rounds:
        now = time.perf_counter() - t_start
        while next_i < len(pending) and pending[next_i].arrival_time <= now:
            server.submit(pending[next_i])
            next_i += 1
        status = server.step(now)
        if health is not None:
            health.observe(status, busy=server.busy(),
                           error=server.last_error
                           if status == "error" else None)
            if health.is_dead:
                break
        if status == "idle":
            if next_i >= len(pending):
                break
            if realtime_arrivals:
                time.sleep(min(0.001, pending[next_i].arrival_time - now))
            else:
                compress_idle_gap(pending, next_i, now)
        elif status == "starved":
            time.sleep(0.0005)

    if health is not None and health.is_dead:
        # the lone replica died: every request not already terminal sheds.
        # Submitted requests unwind their bookings through the scheduler;
        # unarrived backlog never registered anything and just marks shed.
        for i, r in enumerate(pending):
            if r.state == RequestState.FINISHED:
                continue
            if i < next_i:
                scheduler.shed_request(r, reason="replica_failure")
            else:
                r.shed_reason = "replica_failure"
                r.state = RequestState.FINISHED
            server.outputs[r.req_id] = list(r.output_tokens)
            server.crash_shed.append(r)

    server.finish()
    now = time.perf_counter() - t_start

    samples = (
        (np.stack(server.feats), np.asarray(server.lats))
        if collect_samples and server.feats else None
    )
    return ServeResult(
        report=summarize(requests, makespan=now),
        requests=requests,
        rounds=server.rounds,
        wall_s=now,
        samples=samples,
        outputs=server.outputs,
        memory=(
            summarize_memory(kv_pool, scheduler.stats) if kv_pool is not None else None
        ),
        host_bubble_ms=list(engine.bubble_ms),
        slo=(
            summarize_slo(requests, scheduler.fairness.registry)
            if scheduler.fairness is not None else None
        ),
        robustness=(
            summarize_robustness(
                FailoverStats(), injector=server.injector,
                quarantined=len(server.quarantined),
                crash_unwinds=server.crash_unwinds,
                crash_shed=len(server.crash_shed),
            )
            if robustness is not None else None
        ),
    )
