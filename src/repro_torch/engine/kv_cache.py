"""Paged KV-cache memory subsystem (vLLM-style block lifecycle).

The pool manages fixed-size token blocks per request; on TPU the backing
store is a preallocated HBM tensor, here the accounting layer is shared by
the simulator (features + admission control) and the CPU engine (which backs
requests with per-request arrays but books blocks through the same pool, so
LPRS sees identical memory features in both modes).

Beyond flat accounting, the pool implements the full KV lifecycle:

* **Refcounted blocks** — a physical block may back several requests at once
  (prefix sharing); it returns to circulation only when the last reference
  drops.
* **Hash-based prefix cache** — full *prompt* blocks are content-addressed by
  a chained hash ``h_i = H(h_{i-1}, tokens_i)`` (so a block's identity pins
  the entire prefix before it, not just its own tokens).  When the last
  reference to a hashed block drops the block is parked in an LRU of
  *evictable* cached blocks instead of the free list: a later request whose
  prompt shares the block-aligned prefix re-acquires it with
  ``match_prefix`` and skips the corresponding prefill compute.
* **Per-tenant quotas** — each tenant may be capped to a block budget;
  allocation and prefix acquisition charge the requesting tenant, release
  refunds it.  A shared physical block is charged to every request holding a
  reference (conservative logical accounting: quotas bound what a tenant can
  *pin*, not a fair-division of physical residency).
* **Payload store** — the real engine parks the actual K/V arrays of sealed
  blocks host-side so a prefix hit restores numerically identical KV state
  into a fresh slot (causal attention: prefix KV depends only on the prefix).
* **Swap staging store** — a preemption victim's KV can be *swapped out* to a
  host-side staging entry instead of discarded: ``swap_out`` moves the
  request's whole table into a ``_SwapRecord`` (device blocks freed, tenant
  quota refunded), ``swap_in`` later rebuilds the table from fresh blocks
  (quota re-charged) and hands the staged payload back for the device
  restore.  The record carries the block lifecycle state: ``SWAPPING`` while
  the device→host gather is still in flight (the scheduler must not restore
  — or even re-bind — the victim yet), ``SWAPPED_OUT`` once the payload is
  host-resident.  Blocks referenced by live tables are implicitly
  ``RESIDENT``.
* **Managed host tier** — the staging store is a real second cache level,
  not an unbounded spill area: a ``HostTier`` byte budget
  (``host_max_bytes``) is charged at swap-out and released at
  restore/drop/export.  When a reservation does not fit, the pool evicts
  its oldest staged records (stage-time LRU) — the evicted victim is
  *demoted to recompute*: the scheduler notices the record vanished and
  folds the request via ``Request.preempt()``, so nothing ever leaks, it
  just re-prefills.  Opt-in ``host_kv_dtype="int8"`` stores host pages
  quantized (per-page-per-head absmax scales, fused into the swap
  kernels), roughly halving the bytes a staged token charges.  Records can
  also be *shrunk to their decode-hot tail* (``shrink_swap_to_tail``) so a
  fragmented pool restores the last ``k`` blocks decode-resumable and only
  re-prefills the evicted prefix (``swap_in_tail``).  One ``HostTier`` may
  be shared by several pools and the cross-replica handoff store, closing
  one byte ledger over the whole host footprint.

Invariant (``check_invariants``):  ``free + evictable + referenced ==
n_blocks``; refcounts are never negative; every table entry references a
live block; tenant charges sum to the table sizes; every live request's
tokens are tracked by exactly one of {block table, swap staging entry},
never both; swapped tokens pin no device blocks and no tenant quota.
"""
from __future__ import annotations

import enum
import math
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class KVQuotaExceeded(MemoryError):
    """Allocation refused because the tenant's KV block quota is exhausted
    (the pool itself may still have free blocks)."""


# Payload sentinel for the paged engine: the sealed block's K/V still live in
# the engine's physical page at this block id, so a prefix hit needs no
# host-side copy — the marker only proves residency to ``require_payload``
# matches.  (A block id is recycled only after eviction removes its hash, so
# a matchable block's page content is always intact.)
PAGED_RESIDENT = "paged-resident"


class BlockState(enum.Enum):
    """Lifecycle of a request's KV data relative to device memory.  Blocks in
    a live table are RESIDENT; a swap record is SWAPPING while the
    device→host gather is in flight and SWAPPED_OUT once the payload is
    host-side (only then may the request be restored)."""

    RESIDENT = "resident"
    SWAPPING = "swapping"
    SWAPPED_OUT = "swapped_out"


@dataclass
class _SwapRecord:
    """One swapped-out request's host-side staging entry: its logical KV
    length, how many device blocks a restore must re-allocate, and the
    gathered K/V payload (``None`` for accounting-only users like the
    simulator, or while the async gather has not drained yet)."""

    tokens: int                       # stored KV length at swap-out
    n_blocks: int                     # device blocks the restore re-allocates
    tenant: str = "default"
    state: BlockState = BlockState.SWAPPING
    payload: object = None            # engine K/V arrays once the copy drains
    # cross-replica handoff: an imported record's restored prompt blocks are
    # content-addressed on THIS pool at swap-in, so later placement probes
    # (``probe_prefix``) see the prefix as resident here
    seal_on_restore: bool = False
    # host-tier accounting: bytes this record charges against the HostTier
    # budget (0 for accounting-only pools with bytes_per_token == 0)
    nbytes: int = 0
    # payload stored as INT8 pages + per-page-per-head scales (host_kv_dtype)
    quantized: bool = False
    # partial swap-in: > 0 marks a record shrunk to its decode-hot tail —
    # only blocks [tail_start_blocks, n_blocks) remain staged; the prefix
    # must be re-prefilled before ``swap_in_tail`` appends the tail
    tail_start_blocks: int = 0


@dataclass
class HostTierStats:
    """Byte ledger of the host staging tier.  Closes every step:
    ``put_bytes - freed_bytes == resident_bytes`` and, with a budget set,
    ``resident_bytes <= max_bytes`` always."""

    put_bytes: int = 0                # Σ bytes ever charged
    freed_bytes: int = 0              # Σ bytes ever released
    resident_bytes: int = 0           # currently charged
    peak_bytes: int = 0               # high-water mark of resident_bytes
    evictions: int = 0                # staged records evicted, all causes
    swap_evictions: int = 0           # ... evicted to fit a new swap-out
    handoff_evictions: int = 0        # ... evicted to fit a handoff import


class HostTier:
    """Byte-budgeted host staging tier shared by swap records and (optionally)
    the cross-replica handoff store.  The tier itself only keeps the ledger;
    *what* to evict is the owning pool's call (stage-time LRU over its own
    records) — reservations must therefore be gated by the caller
    (``host_can_stage``) so ``charge`` never has to fail halfway through a
    swap-out."""

    def __init__(self, max_bytes: Optional[int] = None):
        assert max_bytes is None or max_bytes >= 0
        self.max_bytes = max_bytes
        self.stats = HostTierStats()

    def can_fit(self, nbytes: int) -> bool:
        return (self.max_bytes is None
                or self.stats.resident_bytes + nbytes <= self.max_bytes)

    def charge(self, nbytes: int) -> None:
        assert nbytes >= 0
        assert self.can_fit(nbytes), (
            f"host tier over budget: {self.stats.resident_bytes} + {nbytes} "
            f"> {self.max_bytes} (caller must gate on host_can_stage)"
        )
        st = self.stats
        st.put_bytes += nbytes
        st.resident_bytes += nbytes
        st.peak_bytes = max(st.peak_bytes, st.resident_bytes)

    def release(self, nbytes: int) -> None:
        st = self.stats
        assert 0 <= nbytes <= st.resident_bytes, (
            f"host tier ledger underflow: release {nbytes} of "
            f"{st.resident_bytes} resident"
        )
        st.freed_bytes += nbytes
        st.resident_bytes -= nbytes

    def note_eviction(self, cause: str) -> None:
        self.stats.evictions += 1
        field_name = f"{cause}_evictions"
        setattr(self.stats, field_name,
                getattr(self.stats, field_name) + 1)

    def check_invariants(self) -> None:
        st = self.stats
        assert st.resident_bytes >= 0, "negative host-tier residency"
        assert st.put_bytes - st.freed_bytes == st.resident_bytes, (
            f"host tier ledger drift: put {st.put_bytes} - freed "
            f"{st.freed_bytes} != resident {st.resident_bytes}"
        )
        if self.max_bytes is not None:
            assert st.resident_bytes <= self.max_bytes, (
                f"host tier over budget: {st.resident_bytes} > {self.max_bytes}"
            )


@dataclass
class KVPoolConfig:
    n_blocks: int = 4096
    block_size: int = 16              # tokens per block
    bytes_per_token: int = 0          # 2 * L * H_kv * hd * dtype_bytes
    hbm_capacity_mb: float = 16 * 1024.0
    param_mb: float = 0.0
    enable_prefix_cache: bool = False
    # bounds on the *evictable* prefix-cache LRU (refcount-0 cached blocks):
    # None = unbounded (cache grows until demand reclaims it)
    cache_max_blocks: Optional[int] = None   # capacity cap on parked blocks
    cache_ttl_s: Optional[float] = None      # evict blocks idle longer than this
    # host staging tier: byte budget over staged swap records (None =
    # unbounded, the pre-tier behavior); reservations past the budget evict
    # the oldest staged records, demoting their victims to recompute
    host_max_bytes: Optional[int] = None
    # "auto" stages pages in the device dtype; "int8" quantizes host pages
    # (per-page-per-head absmax scales) — a staged token charges roughly
    # half the bytes against host_max_bytes
    host_kv_dtype: str = "auto"


@dataclass
class KVPoolStats:
    lookups: int = 0                  # match_prefix calls
    hit_blocks: int = 0               # cached blocks re-acquired
    miss_blocks: int = 0              # full prompt blocks that missed
    hit_tokens: int = 0               # prefill tokens skipped via the cache
    evictions: int = 0                # cached blocks evicted, all causes
    demand_evictions: int = 0         # ... reclaimed for new allocations
    capacity_evictions: int = 0       # ... trimmed by cache_max_blocks
    ttl_evictions: int = 0            # ... expired by cache_ttl_s
    sealed_blocks: int = 0            # blocks that became cache-addressable
    swap_outs: int = 0                # requests swapped out to host staging
    swap_ins: int = 0                 # requests restored from host staging
    swapped_out_tokens: int = 0       # Σ tokens moved device -> host
    swapped_in_tokens: int = 0        # Σ tokens moved host -> device
    handoff_exports: int = 0          # staged records exported to another pool
    handoff_imports: int = 0          # staged records imported from another pool
    partial_swap_ins: int = 0         # tail-only restores (partial swap-in)
    tail_tokens_restored: int = 0     # Σ tokens restored via swap_in_tail

    @property
    def hit_rate(self) -> float:
        """Block-level cache hit rate over all prefix lookups."""
        total = self.hit_blocks + self.miss_blocks
        return self.hit_blocks / total if total else 0.0


@dataclass
class _Registration:
    """Submit-time metadata the prefix cache needs for one request."""

    tenant: str = "default"
    prompt_len: int = 0
    block_hashes: List[int] = field(default_factory=list)  # full prompt blocks
    sealed: int = 0                   # prompt blocks already content-addressed
    newly_sealed: List[Tuple[int, int, int, int]] = field(default_factory=list)
    # (block_index, block_id, start_token, end_token) since last take_newly_sealed


class KVBlockPool:
    def __init__(self, cfg: KVPoolConfig):
        self.cfg = cfg
        self.free_blocks: List[int] = list(range(cfg.n_blocks - 1, -1, -1))
        self.tables: Dict[int, List[int]] = {}     # req_id -> block ids
        self.lens: Dict[int, int] = {}             # req_id -> tokens stored
        # block metadata (only for non-free blocks)
        self._ref: Dict[int, int] = {}             # block_id -> refcount
        self._hash_of: Dict[int, int] = {}         # block_id -> content hash
        self._payload: Dict[int, object] = {}      # block_id -> engine KV arrays
        # prefix cache: content hash -> block id; LRU over refcount-0 members
        self._cache_index: Dict[int, int] = {}
        self._evictable: "OrderedDict[int, int]" = OrderedDict()  # block_id -> hash
        self._parked_at: Dict[int, float] = {}     # block_id -> park clock (TTL)
        self._now = 0.0                            # advanced by the scheduler
        # host-side swap staging: req_id -> _SwapRecord (disjoint from tables).
        # Insertion order == stage-time order: the dict doubles as the host
        # tier's eviction LRU (oldest staged record evicts first).
        self._swap: Dict[int, _SwapRecord] = {}
        # host tier: private by default; attach_host_tier shares one budget
        # across several pools and the handoff store
        self.host = HostTier(cfg.host_max_bytes)
        self._host_shared = False     # attach_host_tier replaced it
        self._host_charged = 0        # bytes THIS pool holds in the tier
        # per-request registration + per-tenant accounting
        self._reg: Dict[int, _Registration] = {}
        self._tenant_used: Dict[str, int] = {}     # tenant -> charged blocks
        self._tenant_quota: Dict[str, int] = {}    # tenant -> max blocks (absent = inf)
        self.stats = KVPoolStats()

    # -- registration / prefix cache ------------------------------------------
    @staticmethod
    def _chain_hashes(tokens, block_size: int) -> List[int]:
        """Chained content hashes over the full (block-aligned) prompt blocks."""
        hashes: List[int] = []
        prev = 0
        for i in range(len(tokens) // block_size):
            prev = hash((prev, tuple(tokens[i * block_size : (i + 1) * block_size])))
            hashes.append(prev)
        return hashes

    def register_request(
        self,
        req_id: int,
        *,
        tenant: str = "default",
        prompt_tokens=None,
        prompt_len: int = 0,
    ) -> None:
        """Record submit-time metadata (tenant for quota charging; prompt
        block hashes for the prefix cache).  Idempotent per request."""
        reg = self._reg.get(req_id)
        if reg is None:
            reg = _Registration(tenant=tenant, prompt_len=prompt_len)
            self._reg[req_id] = reg
        reg.tenant = tenant
        if prompt_len:
            reg.prompt_len = prompt_len
        if self.cfg.enable_prefix_cache and prompt_tokens is not None:
            reg.prompt_len = reg.prompt_len or len(prompt_tokens)
            reg.block_hashes = self._chain_hashes(prompt_tokens, self.cfg.block_size)

    def tenant_of(self, req_id: int) -> str:
        reg = self._reg.get(req_id)
        return reg.tenant if reg is not None else "default"

    def match_prefix(self, req_id: int, *, require_payload: bool = False) -> int:
        """Acquire the longest cached chain of the request's prompt blocks.

        Matched blocks are refcounted into the request's table and the
        request's stored length jumps past them — the caller then skips the
        corresponding prefill compute.  Always leaves at least one token of
        prompt uncached (the final-token logits must be computed to start
        decoding).  Returns the number of prompt tokens covered.
        """
        reg = self._reg.get(req_id)
        if reg is None or not reg.block_hashes or self.tables.get(req_id):
            return 0
        self.stats.lookups += 1
        bs = self.cfg.block_size
        matched: List[int] = []
        for h in reg.block_hashes:
            bid = self._cache_index.get(h)
            if bid is None or (require_payload and bid not in self._payload):
                break
            matched.append(bid)
        # never cover the whole prompt: the last token's logits start decode
        while matched and len(matched) * bs >= reg.prompt_len:
            matched.pop()
        # quota: matched blocks pin memory for this tenant too
        quota = self._tenant_quota.get(reg.tenant)
        if quota is not None:
            headroom = max(0, quota - self._tenant_used.get(reg.tenant, 0))
            matched = matched[:headroom]
        self.stats.hit_blocks += len(matched)
        self.stats.miss_blocks += len(reg.block_hashes) - len(matched)
        if not matched:
            return 0
        for bid in matched:
            self._ref[bid] = self._ref.get(bid, 0) + 1
            self._evictable.pop(bid, None)      # referenced again: not evictable
            self._parked_at.pop(bid, None)
        self.tables[req_id] = list(matched)
        self.lens[req_id] = len(matched) * bs
        reg.sealed = len(matched)               # shared blocks are already sealed
        self._tenant_used[reg.tenant] = (
            self._tenant_used.get(reg.tenant, 0) + len(matched)
        )
        self.stats.hit_tokens += len(matched) * bs
        return len(matched) * bs

    def submit_request(self, req, *, require_payload: bool = False) -> int:
        """Admission hook: register + prefix-match one ``Request``; on a hit
        the request's ``prefill_done`` jumps past the cached tokens so the
        scheduler only sees the residual prefill work."""
        self.register_request(
            req.req_id,
            tenant=req.tenant,
            prompt_tokens=req.prompt_tokens,
            prompt_len=req.prompt_len,
        )
        matched = self.match_prefix(req.req_id, require_payload=require_payload)
        if matched > 0:
            req.prefill_done = matched
        return matched

    # -- quotas ---------------------------------------------------------------
    def set_tenant_quota(self, tenant: str, max_blocks: Optional[int]) -> None:
        if max_blocks is None:
            self._tenant_quota.pop(tenant, None)
        else:
            self._tenant_quota[tenant] = int(max_blocks)

    def tenant_quota(self, tenant: str) -> Optional[int]:
        return self._tenant_quota.get(tenant)

    def tenant_used_blocks(self, tenant: str) -> int:
        return self._tenant_used.get(tenant, 0)

    def blocks_by_tenant(self) -> Dict[str, int]:
        return {t: n for t, n in self._tenant_used.items() if n > 0}

    def quota_headroom_blocks(self, tenant: str) -> float:
        quota = self._tenant_quota.get(tenant)
        if quota is None:
            return math.inf
        return max(0, quota - self._tenant_used.get(tenant, 0))

    # -- alloc/free -----------------------------------------------------------
    def blocks_needed(self, req_id: int, new_tokens: int) -> int:
        cur = self.lens.get(req_id, 0)
        have = len(self.tables.get(req_id, []))
        need = math.ceil((cur + new_tokens) / self.cfg.block_size)
        return max(0, need - have)

    def allocatable_blocks(self) -> int:
        """Free blocks plus cached blocks nobody references (reclaimable)."""
        return len(self.free_blocks) + len(self._evictable)

    def can_allocate(self, req_id: int, new_tokens: int,
                     tenant: Optional[str] = None) -> bool:
        need = self.blocks_needed(req_id, new_tokens)
        if need > self.allocatable_blocks():
            return False
        return need <= self.quota_headroom_blocks(tenant or self.tenant_of(req_id))

    def quota_blocked(self, req_id: int, new_tokens: int,
                      tenant: Optional[str] = None) -> bool:
        """True when the tenant quota (not pool space) is the binding limit."""
        need = self.blocks_needed(req_id, new_tokens)
        return need > self.quota_headroom_blocks(tenant or self.tenant_of(req_id))

    def max_new_tokens(self, req_id: int, tenant: Optional[str] = None) -> int:
        """How many new tokens this request could allocate right now, given
        pool space, reclaimable cache, and its tenant's quota headroom."""
        bs = self.cfg.block_size
        cur = self.lens.get(req_id, 0)
        have = len(self.tables.get(req_id, []))
        slack = have * bs - cur
        headroom = min(
            self.allocatable_blocks(),
            self.quota_headroom_blocks(tenant or self.tenant_of(req_id)),
        )
        return int(slack + headroom * bs)

    def _evict_one(self, reason: str = "demand") -> None:
        bid, h = self._evictable.popitem(last=False)    # LRU
        self._parked_at.pop(bid, None)
        self._cache_index.pop(h, None)
        self._hash_of.pop(bid, None)
        self._payload.pop(bid, None)
        self._ref.pop(bid, None)
        self.free_blocks.append(bid)
        self.stats.evictions += 1
        setattr(self.stats, f"{reason}_evictions",
                getattr(self.stats, f"{reason}_evictions") + 1)

    # -- cache bounds (TTL / capacity) ----------------------------------------
    def advance_clock(self, now: float) -> None:
        """Move the pool's clock forward (the scheduler calls this every
        round) and expire cached blocks older than ``cache_ttl_s``.  The LRU
        order equals park-time order, so expiry walks the front only."""
        if now > self._now:
            self._now = now
        ttl = self.cfg.cache_ttl_s
        if ttl is None:
            return
        while self._evictable:
            oldest = next(iter(self._evictable))
            if self._now - self._parked_at.get(oldest, self._now) <= ttl:
                break
            self._evict_one(reason="ttl")

    def _enforce_cache_capacity(self) -> None:
        cap = self.cfg.cache_max_blocks
        if cap is None:
            return
        while len(self._evictable) > cap:
            self._evict_one(reason="capacity")

    def _pop_block(self) -> int:
        if not self.free_blocks:
            self._evict_one()
        return self.free_blocks.pop()

    def allocate(self, req_id: int, new_tokens: int,
                 tenant: Optional[str] = None) -> List[int]:
        t = tenant if tenant is not None else self.tenant_of(req_id)
        if req_id not in self._reg:
            self._reg[req_id] = _Registration(tenant=t)
        need = self.blocks_needed(req_id, new_tokens)
        if need > self.allocatable_blocks():
            raise MemoryError(
                f"KV pool exhausted: need {need} blocks, have "
                f"{self.allocatable_blocks()} (free {len(self.free_blocks)} "
                f"+ evictable {len(self._evictable)})"
            )
        if need > self.quota_headroom_blocks(t):
            raise KVQuotaExceeded(
                f"tenant {t!r} KV quota exhausted: need {need} blocks, quota "
                f"{self._tenant_quota.get(t)}, used {self._tenant_used.get(t, 0)}"
            )
        got = [self._pop_block() for _ in range(need)]
        for bid in got:
            self._ref[bid] = 1
        self.tables.setdefault(req_id, []).extend(got)
        self.lens[req_id] = self.lens.get(req_id, 0) + new_tokens
        if need:
            self._tenant_used[t] = self._tenant_used.get(t, 0) + need
        self._seal(req_id)
        return got

    def _seal(self, req_id: int) -> None:
        """Content-address prompt blocks that just became full, making them
        matchable by future requests (while still referenced)."""
        if not self.cfg.enable_prefix_cache:
            return
        reg = self._reg.get(req_id)
        if reg is None or not reg.block_hashes:
            return
        bs = self.cfg.block_size
        table = self.tables.get(req_id, [])
        filled = self.lens.get(req_id, 0)
        n_sealable = min(len(reg.block_hashes), filled // bs, len(table))
        for i in range(reg.sealed, n_sealable):
            bid, h = table[i], reg.block_hashes[i]
            if h in self._cache_index:
                # identical content already addressable (shared or duplicate):
                # leave the index pointing at the first copy
                reg.sealed = i + 1
                continue
            self._cache_index[h] = bid
            self._hash_of[bid] = h
            reg.sealed = i + 1
            reg.newly_sealed.append((i, bid, i * bs, (i + 1) * bs))
            self.stats.sealed_blocks += 1

    def take_newly_sealed(self, req_id: int) -> List[Tuple[int, int, int, int]]:
        """Drain (block_index, block_id, start_tok, end_tok) records for
        blocks sealed since the last call — the engine captures their KV
        payloads from its slot cache."""
        reg = self._reg.get(req_id)
        if reg is None or not reg.newly_sealed:
            return []
        out, reg.newly_sealed = reg.newly_sealed, []
        return out

    # -- payloads (real-engine KV reuse) ---------------------------------------
    def store_payload(self, block_id: int, payload: object) -> None:
        if block_id in self._hash_of:      # only cache-addressable blocks
            self._payload[block_id] = payload

    def payload(self, block_id: int) -> Optional[object]:
        return self._payload.get(block_id)

    def release(self, req_id: int, *, keep_registration: bool = False) -> None:
        """Drop all of a request's references.  Idempotent.  Cached (hashed)
        blocks whose refcount reaches zero are parked in the eviction LRU;
        unhashed blocks return to the free list.  ``keep_registration=True``
        (preemption) retains tenant + prompt hashes for the recompute pass."""
        blocks = self.tables.pop(req_id, [])
        self.lens.pop(req_id, None)
        reg = self._reg.get(req_id)
        if blocks and reg is not None:
            used = self._tenant_used.get(reg.tenant, 0) - len(blocks)
            if used > 0:
                self._tenant_used[reg.tenant] = used
            else:
                self._tenant_used.pop(reg.tenant, None)
        for bid in blocks:
            ref = self._ref.get(bid, 0) - 1
            assert ref >= 0, f"double-free of block {bid}"
            if ref > 0:
                self._ref[bid] = ref
                continue
            h = self._hash_of.get(bid)
            if h is not None and self.cfg.enable_prefix_cache:
                self._ref[bid] = 0
                self._evictable[bid] = h       # most-recently used end
                self._evictable.move_to_end(bid)
                self._parked_at[bid] = self._now
                self._enforce_cache_capacity()
            else:
                self._ref.pop(bid, None)
                self._hash_of.pop(bid, None)
                self._payload.pop(bid, None)
                self.free_blocks.append(bid)
        if reg is not None:
            if keep_registration:
                reg.sealed = 0
                reg.newly_sealed = []
            else:
                self._reg.pop(req_id, None)

    def reset(self) -> None:
        """Bring an idle pool back to its just-built state, for a run that
        must not carry into the next one (a profiling run before the serve
        it tunes): the cached prefix blocks are freed, since the next run
        would hit on them, and the counters, the clock and the free list
        start again.  A host tier shared with other pools keeps its ledger;
        a private one is emptied with the pool."""
        assert not self.tables and not self._swap, (
            "reset() of a pool with live or staged requests")
        assert not self._host_charged
        self.free_blocks = list(range(self.cfg.n_blocks - 1, -1, -1))
        for d in (self._ref, self._hash_of, self._payload, self._cache_index,
                  self._evictable, self._parked_at, self._reg,
                  self._tenant_used):
            d.clear()
        self._now = 0.0
        self.stats = KVPoolStats()
        if not self._host_shared:
            self.host = HostTier(self.cfg.host_max_bytes)

    # -- host staging tier ------------------------------------------------------
    def attach_host_tier(self, tier: HostTier) -> None:
        """Share one ``HostTier`` budget with other pools / the handoff
        store.  Must happen before anything is staged here (the private
        tier's charges cannot be migrated)."""
        assert self._host_charged == 0 and not self._swap, (
            "attach_host_tier after records were staged"
        )
        self.host = tier
        self._host_shared = True

    def host_bytes_for(self, tokens: int) -> int:
        """Bytes a staged record of this many tokens charges the host tier.
        INT8 staging halves the payload (the per-page scales are small
        against the page itself and are folded into the estimate)."""
        nb = tokens * self.cfg.bytes_per_token
        if self.cfg.host_kv_dtype == "int8":
            nb //= 2
        return nb

    def host_can_stage(self, tokens: int) -> bool:
        """True when a swap-out of this many tokens can be staged after
        evicting every one of THIS pool's own records if need be.  Bytes
        charged by co-tenants of a shared tier (other pools, the handoff
        store) are not evictable from here."""
        if self.host.max_bytes is None:
            return True
        nbytes = self.host_bytes_for(tokens)
        pinned = self.host.stats.resident_bytes - self._host_charged
        return nbytes <= self.host.max_bytes - pinned

    def _host_evict_oldest(self, cause: str) -> int:
        """Evict the oldest staged record (stage-time LRU) to make host
        room.  The evicted request is DEMOTED: its KV is gone from both
        tiers, so the scheduler folds it via ``Request.preempt()`` when it
        notices the record vanished — a recompute, never a leak.  Returns
        the demoted req_id."""
        assert self._swap, "host eviction from an empty staging store"
        req_id = next(iter(self._swap))
        rec = self._swap.pop(req_id)
        self.host.release(rec.nbytes)
        self._host_charged -= rec.nbytes
        self.host.note_eviction(cause)
        return req_id

    def _host_reserve(self, nbytes: int, *, cause: str = "swap") -> None:
        while not self.host.can_fit(nbytes) and self._swap:
            self._host_evict_oldest(cause)
        self.host.charge(nbytes)      # asserts fit: callers gate on
        self._host_charged += nbytes  # host_can_stage first

    def _host_release(self, rec: _SwapRecord) -> None:
        self.host.release(rec.nbytes)
        self._host_charged -= rec.nbytes

    # -- swap-out preemption (host staging) ------------------------------------
    def swap_out(self, req_id: int, *, ready: bool = False) -> _SwapRecord:
        """Move a request's KV accounting from its block table to a host-side
        staging record: device blocks are released (shared/hashed blocks
        follow the normal refcount/park path — the staged payload covers the
        FULL stored length, so a restore never depends on the cache), tenant
        quota is refunded, and the request becomes decode-resumable instead
        of prefill-restart.

        The record starts in ``SWAPPING`` (the engine's async device→host
        gather is in flight; ``finish_swap_out`` flips it) unless
        ``ready=True`` (accounting-only callers — the simulator — have no
        real copy to wait for).  ``reg.sealed`` is kept: the prompt is
        unchanged, so already-indexed prefix blocks stay valid; only
        ``newly_sealed`` capture records are dropped (their blocks are no
        longer engine-readable)."""
        table = self.tables.get(req_id)
        assert table, f"swap_out of req {req_id} with no blocks"
        assert req_id not in self._swap, f"req {req_id} already swapped"
        tokens = self.lens.get(req_id, 0)
        nbytes = self.host_bytes_for(tokens)
        # reserve host bytes FIRST (may demote older staged victims); the
        # new record is not in _swap yet, so it can never evict itself
        self._host_reserve(nbytes, cause="swap")
        rec = _SwapRecord(
            tokens=tokens,
            n_blocks=len(table),
            tenant=self.tenant_of(req_id),
            state=BlockState.SWAPPED_OUT if ready else BlockState.SWAPPING,
            nbytes=nbytes,
            quantized=self.cfg.host_kv_dtype == "int8",
        )
        reg = self._reg.get(req_id)
        sealed = reg.sealed if reg is not None else 0
        self.release(req_id, keep_registration=True)
        if reg is not None:
            reg.sealed = sealed          # prompt unchanged: hashes still valid
        self._swap[req_id] = rec
        self.stats.swap_outs += 1
        self.stats.swapped_out_tokens += tokens
        return rec

    def finish_swap_out(self, req_id: int, payload: object = None) -> None:
        """The async gather drained: attach the host payload and mark the
        record restorable (``SWAPPED_OUT``)."""
        rec = self._swap.get(req_id)
        assert rec is not None, f"finish_swap_out of unswapped req {req_id}"
        self.finalize_record(rec, payload)

    @staticmethod
    def finalize_record(rec: _SwapRecord, payload: object = None) -> None:
        """Finalize a staging record DIRECTLY, wherever it currently lives.
        Under handoff PREFETCH a SWAPPING record may already have been
        exported into the ``KVHandoffStore`` — or imported by a destination
        pool — before its gather drains; the source engine holds the record
        object and finalizes it here, and the destination's ``swap_ready``
        gate turns true the moment the payload is host-side."""
        if payload is not None:
            rec.payload = payload
        rec.state = BlockState.SWAPPED_OUT

    def swap_state(self, req_id: int) -> Optional[BlockState]:
        """``None`` when the request is not swapped (its blocks, if any, are
        RESIDENT); otherwise the staging record's lifecycle state."""
        rec = self._swap.get(req_id)
        return rec.state if rec is not None else None

    def swap_ready(self, req_id: int) -> bool:
        rec = self._swap.get(req_id)
        return rec is not None and rec.state == BlockState.SWAPPED_OUT

    def swap_tokens(self, req_id: int) -> int:
        rec = self._swap.get(req_id)
        return rec.tokens if rec is not None else 0

    def swapped_requests(self) -> List[int]:
        return list(self._swap)

    def can_swap_in(self, req_id: int, tenant: Optional[str] = None) -> bool:
        """True when the staged payload is host-resident AND the pool + the
        tenant's quota can back the restore right now."""
        rec = self._swap.get(req_id)
        if rec is None or rec.state != BlockState.SWAPPED_OUT:
            return False
        need = rec.n_blocks - rec.tail_start_blocks
        if need > self.allocatable_blocks():
            return False
        return need <= self.quota_headroom_blocks(
            tenant or self.tenant_of(req_id)
        )

    def swap_in(self, req_id: int,
                tenant: Optional[str] = None) -> Tuple[List[int], object]:
        """Restore a swapped-out request: allocate fresh device blocks
        (re-charging the tenant's quota), rebuild its table/length, drop the
        staging record, and return ``(new_block_ids, payload)`` so the engine
        can scatter the staged K/V into the new pages.  Restored blocks are
        private (refcount 1, not re-sealed): already-indexed prefix blocks
        keep pointing at their original — possibly still cached — copies."""
        rec = self._swap.get(req_id)
        assert rec is not None, f"swap_in of unswapped req {req_id}"
        assert rec.state == BlockState.SWAPPED_OUT, (
            f"req {req_id} swap still in flight ({rec.state})"
        )
        assert rec.tail_start_blocks == 0, (
            f"req {req_id} shrunk to tail: restore via swap_in_tail"
        )
        t = tenant if tenant is not None else rec.tenant
        if rec.n_blocks > self.allocatable_blocks():
            raise MemoryError(
                f"KV pool exhausted on swap-in: need {rec.n_blocks} blocks, "
                f"have {self.allocatable_blocks()}"
            )
        if rec.n_blocks > self.quota_headroom_blocks(t):
            raise KVQuotaExceeded(
                f"tenant {t!r} KV quota exhausted on swap-in: need "
                f"{rec.n_blocks} blocks, quota {self._tenant_quota.get(t)}, "
                f"used {self._tenant_used.get(t, 0)}"
            )
        got = [self._pop_block() for _ in range(rec.n_blocks)]
        for bid in got:
            self._ref[bid] = 1
        assert not self.tables.get(req_id), "swap_in over a live table"
        self.tables[req_id] = list(got)
        self.lens[req_id] = rec.tokens
        self._tenant_used[t] = self._tenant_used.get(t, 0) + rec.n_blocks
        self._swap.pop(req_id)
        self._host_release(rec)
        self.stats.swap_ins += 1
        self.stats.swapped_in_tokens += rec.tokens
        if rec.seal_on_restore:
            # imported handoff: content-address the restored prompt blocks so
            # this pool's prefix index reflects what is now resident here —
            # placement locality probes rely on it.  (No payload marker is
            # stored: engine-side prefix matches require one, so a restore
            # can never silently alias an imported block.)
            self._seal(req_id)
        return got, rec.payload

    def drop_swap(self, req_id: int) -> None:
        """Discard a staging record without restoring (finished/cancelled
        victim, or a caller falling back to recompute).  Idempotent."""
        rec = self._swap.pop(req_id, None)
        if rec is not None:
            self._host_release(rec)

    # -- partial swap-in (decode-hot tail) -------------------------------------
    def swap_tail_start(self, req_id: int) -> int:
        """0 for a whole-record stage; otherwise the block index the staged
        payload starts at (the prefix before it must be re-prefilled)."""
        rec = self._swap.get(req_id)
        return rec.tail_start_blocks if rec is not None else 0

    def shrink_swap_to_tail(self, req_id: int, tail_start_blocks: int,
                            payload_slicer=None) -> None:
        """Shrink a staged record to its decode-hot tail: blocks
        ``[tail_start_blocks, n_blocks)`` stay staged, the prefix bytes are
        released from the host tier, and the owning request — which the
        caller has folded via ``Request.preempt()`` — re-prefills the
        prefix chunk-by-chunk before ``swap_in_tail`` appends the tail.
        ``payload_slicer(payload, tail_start_blocks, n_blocks)`` trims the
        engine arrays (accounting-only users pass None)."""
        rec = self._swap.get(req_id)
        assert rec is not None, f"shrink of unswapped req {req_id}"
        assert rec.state == BlockState.SWAPPED_OUT, (
            f"req {req_id} shrink while swap in flight ({rec.state})"
        )
        assert rec.tail_start_blocks == 0, f"req {req_id} already shrunk"
        assert 0 < tail_start_blocks < rec.n_blocks, (
            f"tail split {tail_start_blocks} outside (0, {rec.n_blocks})"
        )
        freed = min(
            rec.nbytes,
            self.host_bytes_for(tail_start_blocks * self.cfg.block_size),
        )
        self.host.release(freed)
        self._host_charged -= freed
        rec.nbytes -= freed
        rec.tail_start_blocks = tail_start_blocks
        if payload_slicer is not None and rec.payload is not None:
            rec.payload = payload_slicer(
                rec.payload, tail_start_blocks, rec.n_blocks)

    def swap_in_tail(self, req_id: int,
                     tenant: Optional[str] = None) -> Tuple[List[int], object]:
        """Complete a partial restore: the request has re-prefilled exactly
        the evicted prefix (``tail_start_blocks`` full blocks), so append
        fresh device blocks for the staged tail and hand back the trimmed
        payload for the engine scatter.  The request's stored length jumps
        to the record's full length — positions align because the prefix
        re-prefill was clipped to the block-exact split point."""
        rec = self._swap.get(req_id)
        assert rec is not None, f"swap_in_tail of unswapped req {req_id}"
        assert rec.state == BlockState.SWAPPED_OUT, (
            f"req {req_id} swap still in flight ({rec.state})"
        )
        d = rec.tail_start_blocks
        assert d > 0, f"req {req_id} not shrunk: restore via swap_in"
        bs = self.cfg.block_size
        table = self.tables.get(req_id, [])
        assert len(table) == d and self.lens.get(req_id, 0) == d * bs, (
            f"req {req_id} tail restore off the split: holds {len(table)} "
            f"blocks / {self.lens.get(req_id, 0)} tokens, split at {d} blocks"
        )
        need = rec.n_blocks - d
        t = tenant if tenant is not None else rec.tenant
        if need > self.allocatable_blocks():
            raise MemoryError(
                f"KV pool exhausted on tail swap-in: need {need} blocks, "
                f"have {self.allocatable_blocks()}"
            )
        if need > self.quota_headroom_blocks(t):
            raise KVQuotaExceeded(
                f"tenant {t!r} KV quota exhausted on tail swap-in: need "
                f"{need} blocks, quota {self._tenant_quota.get(t)}, "
                f"used {self._tenant_used.get(t, 0)}"
            )
        got = [self._pop_block() for _ in range(need)]
        for bid in got:
            self._ref[bid] = 1
        self.tables[req_id].extend(got)
        self.lens[req_id] = rec.tokens
        self._tenant_used[t] = self._tenant_used.get(t, 0) + need
        self._swap.pop(req_id)
        self._host_release(rec)
        tail_tokens = rec.tokens - d * bs
        self.stats.swap_ins += 1
        self.stats.partial_swap_ins += 1
        self.stats.swapped_in_tokens += tail_tokens
        self.stats.tail_tokens_restored += tail_tokens
        return got, rec.payload

    # -- cross-replica KV handoff (disaggregated prefill/decode pools) ---------
    def export_swap(self, req_id: int, *, allow_inflight: bool = False
                    ) -> Tuple[_SwapRecord, "_Registration"]:
        """Detach a host-staged record from this pool for another pool to
        ``import_swap``: the disaggregated handoff path.  By default the
        record must be SWAPPED_OUT (payload host-resident); the PREFETCH
        path passes ``allow_inflight=True`` to move a still-SWAPPING record
        early — the source engine holds the record object and attaches the
        payload via ``finalize_record`` when the gather drains, and the
        destination's restore stays gated on ``swap_ready``.  Either way the
        request's registration leaves with the record, so this pool retains
        no trace of the request."""
        rec = self._swap.get(req_id)
        assert rec is not None, f"export_swap of unswapped req {req_id}"
        assert allow_inflight or rec.state == BlockState.SWAPPED_OUT, (
            f"req {req_id} export while swap in flight ({rec.state})"
        )
        assert not self.tables.get(req_id), (
            f"req {req_id} exported while holding a live table"
        )
        del self._swap[req_id]           # validate first: a rejected export
        self._host_release(rec)          # the handoff store re-charges the
        reg = self._reg.pop(req_id, None)       # (shared) tier on put; a
        self.stats.handoff_exports += 1         # rejected export leaves the
        return rec, reg                         # pool intact

    def import_swap(self, req_id: int, rec: _SwapRecord,
                    reg: Optional["_Registration"] = None) -> None:
        """Adopt a record exported from another pool's ``export_swap``: it
        lands in this pool's staging store exactly as a local swap-out would
        have, so the ordinary ``swap_in``/restore path resumes the request
        decode-only — zero re-prefilled tokens.  A PREFETCHED record may
        still be SWAPPING (source gather in flight): it is adoptable because
        every restore path gates on ``swap_ready``, which turns true only
        when the source engine finalizes the record.  The source
        registration (tenant + prompt block hashes) carries over so quota
        charging and prefix sealing work on this side of the link."""
        assert req_id not in self._swap, f"req {req_id} already staged here"
        assert not self.tables.get(req_id), (
            f"req {req_id} imported over a live table"
        )
        if reg is not None:
            fresh = _Registration(
                tenant=reg.tenant, prompt_len=reg.prompt_len,
                block_hashes=list(reg.block_hashes),
            )
            self._reg[req_id] = fresh
        # the adopted record charges THIS pool's host tier (with a shared
        # tier the store's take() released the same bytes, so it fits by
        # construction; a private tier may demote older local records)
        self._host_reserve(rec.nbytes, cause="handoff")
        rec.seal_on_restore = self.cfg.enable_prefix_cache
        self._swap[req_id] = rec
        self.stats.handoff_imports += 1

    def probe_prefix(self, prompt_tokens) -> int:
        """Non-acquiring placement probe: how many leading prompt tokens are
        content-addressed on THIS pool right now (cached or still referenced).
        Unlike ``match_prefix`` nothing is refcounted, charged, or moved in
        the LRU — routers call this per candidate replica to score KV
        locality before deciding where a request's decode should land."""
        if not self.cfg.enable_prefix_cache or prompt_tokens is None:
            return 0
        matched = 0
        for h in self._chain_hashes(prompt_tokens, self.cfg.block_size):
            if h not in self._cache_index:
                break
            matched += 1
        return matched * self.cfg.block_size

    def resident_tokens(self, req_id: int) -> int:
        """Tokens of this request's context that are already materialized on
        (or one restore round away from) this pool: blocks it holds, a
        host-staged swap record, or — for a cold request — its longest
        indexed prompt prefix.  The scheduler's cache-aware aging credit
        scores queue candidates with this."""
        held = self.lens.get(req_id, 0)
        rec = self._swap.get(req_id)
        if rec is not None:
            # quantized-resident counts in full: an int8 page restores a
            # usable token exactly like an fp one, so the cache-aware aging
            # credit (and SLO victim ranking through it) prices both tiers
            # the same.  A tail-shrunk record contributes its staged tail on
            # top of the re-prefilled prefix the request already holds.
            if rec.tail_start_blocks > 0:
                return held + rec.tokens - rec.tail_start_blocks * self.cfg.block_size
            return rec.tokens
        if held:
            return held
        reg = self._reg.get(req_id)
        if reg is None or not reg.block_hashes:
            return 0
        matched = 0
        for h in reg.block_hashes:
            if h not in self._cache_index:
                break
            matched += 1
        return matched * self.cfg.block_size

    # -- accounting (LPRS features) --------------------------------------------
    @property
    def used_blocks(self) -> int:
        """Blocks pinned by live references (evictable cache not counted:
        it is reclaimable on demand, like the free list)."""
        return self.cfg.n_blocks - len(self.free_blocks) - len(self._evictable)

    @property
    def cached_blocks(self) -> int:
        """Refcount-0 blocks retained only by the prefix cache."""
        return len(self._evictable)

    @property
    def swapped_out_blocks(self) -> int:
        """Device blocks the currently-swapped requests will re-allocate on
        restore (their data is host-side; no device blocks are pinned now).
        Tail-shrunk records only re-allocate their staged tail."""
        return sum(rec.n_blocks - rec.tail_start_blocks
                   for rec in self._swap.values())

    @property
    def used_mb(self) -> float:
        return self.used_blocks * self.cfg.block_size * self.cfg.bytes_per_token / 2**20

    @property
    def free_mb(self) -> float:
        return self.allocatable_blocks() * self.cfg.block_size * self.cfg.bytes_per_token / 2**20

    @property
    def allocated_mb(self) -> float:
        return self.cfg.param_mb + self.used_mb

    @property
    def reserved_mb(self) -> float:
        return self.cfg.hbm_capacity_mb

    def utilization(self) -> float:
        return self.used_blocks / max(self.cfg.n_blocks, 1)

    # -- invariants (property tests) -------------------------------------------
    def check_invariants(self) -> None:
        referenced = {bid for t in self.tables.values() for bid in t}
        assert referenced.isdisjoint(self.free_blocks), "table entry on free list"
        assert referenced.isdisjoint(self._evictable), "table entry marked evictable"
        n_accounted = len(self.free_blocks) + len(self._evictable) + len(referenced)
        assert n_accounted == self.cfg.n_blocks, (
            f"block conservation violated: free {len(self.free_blocks)} + "
            f"evictable {len(self._evictable)} + referenced {len(referenced)} "
            f"!= {self.cfg.n_blocks}"
        )
        for bid, ref in self._ref.items():
            assert ref >= 0, f"negative refcount on block {bid}"
        for bid in referenced:
            holders = sum(1 for t in self.tables.values() if bid in t)
            assert self._ref.get(bid, 0) == holders, (
                f"block {bid}: refcount {self._ref.get(bid, 0)} != holders {holders}"
            )
        # block-table invariants (the paged engine addresses physical pages
        # straight through these tables):
        bs = self.cfg.block_size
        for req_id, table in self.tables.items():
            # every live token maps into exactly one physical block slot
            assert self.lens.get(req_id, 0) <= len(table) * bs, (
                f"req {req_id}: {self.lens.get(req_id, 0)} tokens live in "
                f"{len(table)} blocks of {bs}"
            )
            # a table never references the same physical block twice
            assert len(set(table)) == len(table), (
                f"req {req_id}: duplicate physical block in table {table}"
            )
        for bid in referenced:
            # a physical block appears in multiple live tables only while
            # sealed (content-addressed prefix sharing); private blocks are
            # exclusively owned
            if self._ref.get(bid, 0) > 1:
                assert bid in self._hash_of, (
                    f"block {bid} shared by {self._ref[bid]} tables but not sealed"
                )
        # swap-staging invariants: a request's tokens live in exactly one of
        # {block table, staging entry} — never both (a tail-shrunk record
        # splits block-exactly: the table holds the re-prefilled prefix, the
        # record the staged tail, disjoint by position); a staged entry
        # always carries real tokens and a positive restore size
        for req_id, rec in self._swap.items():
            if rec.tail_start_blocks > 0:
                assert 0 < rec.tail_start_blocks < rec.n_blocks, (
                    f"req {req_id} tail split {rec.tail_start_blocks} outside "
                    f"(0, {rec.n_blocks})"
                )
                assert len(self.tables.get(req_id, ())) <= rec.tail_start_blocks, (
                    f"req {req_id} re-prefilled past the tail split: "
                    f"{len(self.tables.get(req_id, ()))} blocks held, "
                    f"split at {rec.tail_start_blocks}"
                )
                assert self.lens.get(req_id, 0) <= rec.tail_start_blocks * bs, (
                    f"req {req_id} prefix length {self.lens.get(req_id, 0)} "
                    f"past the tail split token {rec.tail_start_blocks * bs}"
                )
            else:
                assert not self.tables.get(req_id), (
                    f"req {req_id} swapped AND holding a live table"
                )
                assert req_id not in self.lens, (
                    f"req {req_id} swapped AND holding a device length"
                )
            assert rec.tokens > 0 and rec.n_blocks > 0, (
                f"req {req_id} empty swap record {rec}"
            )
            assert rec.tokens <= rec.n_blocks * bs, (
                f"req {req_id} swap record overfull: {rec.tokens} tokens in "
                f"{rec.n_blocks} blocks of {bs}"
            )
            assert rec.nbytes >= 0, f"req {req_id} negative staged bytes"
        # host-tier ledger: this pool's records account exactly for its
        # charges; the tier's own ledger closes (and respects the budget)
        assert self._host_charged == sum(
            rec.nbytes for rec in self._swap.values()
        ), (
            f"host charge drift: pool holds {self._host_charged} bytes, "
            f"records sum to {sum(r.nbytes for r in self._swap.values())}"
        )
        self.host.check_invariants()
        assert self._host_charged <= self.host.stats.resident_bytes, (
            "pool charged more than the tier holds"
        )
        # cache-bound invariants: parked set == evictable set; capacity holds
        assert set(self._parked_at) == set(self._evictable), "stamp/LRU drift"
        if self.cfg.cache_max_blocks is not None:
            assert len(self._evictable) <= self.cfg.cache_max_blocks
        by_tenant: Dict[str, int] = {}
        for req_id, table in self.tables.items():
            t = self.tenant_of(req_id)
            by_tenant[t] = by_tenant.get(t, 0) + len(table)
        for t, n in by_tenant.items():
            assert self._tenant_used.get(t, 0) == n, (
                f"tenant {t!r} charge {self._tenant_used.get(t, 0)} != held {n}"
            )


def pool_for_model(cfg_model, *, n_blocks: int = 8192, block_size: int = 16,
                   hbm_mb: float = 16 * 1024.0,
                   enable_prefix_cache: bool = False,
                   cache_max_blocks: Optional[int] = None,
                   cache_ttl_s: Optional[float] = None,
                   host_max_bytes: Optional[int] = None,
                   host_kv_dtype: str = "auto") -> KVBlockPool:
    """Size bytes_per_token from a ModelConfig (attention layers only)."""
    hd = cfg_model.resolved_head_dim
    if cfg_model.attn_every:
        n_attn = sum(1 for l in range(cfg_model.n_layers) if l % cfg_model.attn_every == 0)
    elif cfg_model.family == "ssm":
        n_attn = 0
    else:
        n_attn = cfg_model.n_layers
    bpt = 2 * n_attn * cfg_model.n_kv_heads * hd * 2  # k+v, bf16
    param_mb = cfg_model.param_count() * 2 / 2**20
    return KVBlockPool(
        KVPoolConfig(
            n_blocks=n_blocks,
            block_size=block_size,
            bytes_per_token=max(bpt, 2),
            hbm_capacity_mb=hbm_mb,
            param_mb=param_mb,
            enable_prefix_cache=enable_prefix_cache,
            cache_max_blocks=cache_max_blocks,
            cache_ttl_s=cache_ttl_s,
            host_max_bytes=host_max_bytes,
            host_kv_dtype=host_kv_dtype,
        )
    )
