"""Cross-replica KV handoff staging and the handoff/colocate cost model.

A disaggregated deployment splits prefill and decode onto separate engine
replicas (separate schedulers, slots, and KV pools).  The migration unit is
the host-side swap staging record the swap-preemption subsystem already
produces: at prefill completion the source engine gathers the request's pages
into a contiguous staging tensor (``TorchEngine.swap_out``), the async copy
drains on the pipelined one-round-late path, and the SWAPPED_OUT record —
payload, block-table shape, tenant, prompt hashes — is detached from the
source pool (``export_swap``) into the ``KVHandoffStore`` here, then adopted
by the chosen decode pool (``import_swap``).  The decode scheduler restores
it through the ordinary swap-in path, so the request resumes DECODE-ONLY:
zero prefill tokens are ever scheduled on the decode side.

While staged here, a request's KV lives in exactly ONE place: not the source
pool (export popped it), not the destination (import has not run).  The
store is therefore a first-class location in the exactly-one-location
invariant the property tests check.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass
class HandoffStats:
    staged: int = 0            # records entered the store
    delivered: int = 0         # records adopted by a decode pool
    dropped: int = 0           # killed mid-handoff (late stop): staging discarded
    expired: int = 0           # TTL reaped (never adopted within handoff_ttl_s)
    colocated: int = 0         # prefill-completions the cost model kept local
    bytes_moved: int = 0       # Σ payload bytes delivered across the link
    prefetched: int = 0        # records adopted while the source gather was
                               # still in flight (DisaggConfig.prefetch)
    # byte-exact staging ledger: put - take - drop - expire == resident
    put_bytes: int = 0
    taken_bytes: int = 0
    dropped_bytes: int = 0
    expired_bytes: int = 0
    resident_bytes: int = 0


@dataclass
class _Entry:
    rec: object
    reg: object
    src: str
    nbytes: int
    t_put: float


class KVHandoffStore:
    """Host-side staging ground for in-flight cross-replica handoffs.

    Entries are keyed by req_id and hold the exported ``(_SwapRecord,
    _Registration)`` pair plus the source replica's name.  The store owns the
    record between ``export_swap`` on the source pool and ``import_swap`` on
    the destination — the only window in which neither pool accounts for the
    request's KV.

    A record adopted by nobody (destination dead or stalled) would pin its
    host bytes forever; ``ttl_s`` bounds that: ``expire(now)`` reaps records
    older than the TTL and the byte ledger keeps ``put - take - drop -
    expire == resident`` exact at every step.

    With a ``host_tier`` attached (the managed host byte budget the KV pools
    stage against), every entry charges the SAME tier the pools do — a
    record in flight between replicas occupies host memory exactly once:
    ``export_swap`` releases the source pool's charge, ``put`` re-charges it
    here (net zero on a shared tier), ``take`` releases it for the
    destination's ``import_swap`` reservation.  Callers gate oversized puts
    with ``can_stage`` (colocate instead); ``charge`` itself asserts fit.
    """

    def __init__(self, ttl_s: Optional[float] = None, host_tier=None):
        self.ttl_s = ttl_s
        self.host = host_tier
        self._entries: Dict[int, _Entry] = {}
        self.stats = HandoffStats()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, req_id: int) -> bool:
        return req_id in self._entries

    def req_ids(self) -> List[int]:
        return list(self._entries)

    def src_of(self, req_id: int) -> Optional[str]:
        e = self._entries.get(req_id)
        return e.src if e is not None else None

    @staticmethod
    def record_bytes(rec, bytes_per_token: int = 0) -> int:
        """Host bytes a record occupies: the pool's exact stage-time charge
        when present (INT8 staging halves it), else the caller's full-width
        estimate (accounting-only records carry ``nbytes == 0``)."""
        nb = getattr(rec, "nbytes", 0)
        return nb if nb else rec.tokens * max(bytes_per_token, 0)

    def can_stage(self, nbytes: int) -> bool:
        """True when the host tier (if any) can take ``nbytes`` more — the
        router's colocate-fallback gate for oversized handoffs."""
        return self.host is None or self.host.can_fit(nbytes)

    def put(self, req_id: int, rec, reg, *, src: str = "?",
            bytes_per_token: int = 0, now: float = 0.0) -> None:
        assert req_id not in self._entries, f"req {req_id} already staged"
        nbytes = self.record_bytes(rec, bytes_per_token)
        if self.host is not None:
            self.host.charge(nbytes)   # asserts fit: callers gate can_stage
        self._entries[req_id] = _Entry(rec, reg, src, nbytes, now)
        self.stats.staged += 1
        self.stats.bytes_moved += nbytes
        self.stats.put_bytes += nbytes
        self.stats.resident_bytes += nbytes

    def take(self, req_id: int) -> Tuple[object, object]:
        """Hand the staged record to a destination pool (delivery)."""
        e = self._entries.pop(req_id)
        if self.host is not None:
            self.host.release(e.nbytes)
        self.stats.delivered += 1
        self.stats.taken_bytes += e.nbytes
        self.stats.resident_bytes -= e.nbytes
        return e.rec, e.reg

    def drop(self, req_id: int) -> None:
        """Discard a staged record whose request died mid-handoff."""
        e = self._entries.pop(req_id, None)
        if e is not None:
            if self.host is not None:
                self.host.release(e.nbytes)
            self.stats.dropped += 1
            self.stats.dropped_bytes += e.nbytes
            self.stats.resident_bytes -= e.nbytes

    def expire(self, now: float, ttl_s: Optional[float] = None) -> List[int]:
        """Reap records staged longer than the TTL; returns the reaped ids so
        the router can re-route their (no longer decode-resumable) requests."""
        ttl = self.ttl_s if ttl_s is None else ttl_s
        if ttl is None:
            return []
        reaped = [rid for rid, e in self._entries.items()
                  if now - e.t_put > ttl]
        for rid in reaped:
            e = self._entries.pop(rid)
            if self.host is not None:
                self.host.release(e.nbytes)
            self.stats.expired += 1
            self.stats.expired_bytes += e.nbytes
            self.stats.resident_bytes -= e.nbytes
        return reaped

    def staged_tokens(self, req_id: int) -> int:
        e = self._entries.get(req_id)
        return e.rec.tokens if e is not None else 0

    def check_invariants(self) -> None:
        """At quiesce the store must be empty (every exported record was
        delivered, dropped, or expired) and the byte ledger must balance."""
        s = self.stats
        assert (s.put_bytes - s.taken_bytes - s.dropped_bytes
                - s.expired_bytes == s.resident_bytes), (
            f"handoff byte ledger off: put={s.put_bytes} taken={s.taken_bytes}"
            f" dropped={s.dropped_bytes} expired={s.expired_bytes}"
            f" resident={s.resident_bytes}")
        assert s.resident_bytes == sum(e.nbytes for e in self._entries.values())
        assert not self._entries, (
            f"handoff store leaked staged records: {sorted(self._entries)}"
        )


@dataclass(frozen=True)
class HandoffCostConfig:
    """Deterministic per-request handoff-vs-colocate pricing.

    Handing off pays the KV transfer twice over the host link (source gather
    →host, host→destination scatter) plus fixed launch costs; staying
    colocated pays chunked-prefill interference on every remaining decode
    token — on a prefill-pool replica each decode round shares its batch with
    prefill chunks, the contention disaggregation exists to remove (the
    c_mix term of the serving cost model).
    """

    link_ms_per_mb: float = 0.05      # ~20 GB/s effective host link
    link_fixed_ms: float = 0.2        # per transfer launch (paid twice)
    # expected extra latency per decode token executed on a prefill-busy
    # replica: c_mix_ms x typical prefill tokens co-batched per round
    contention_ms_per_token: float = 0.004


class HandoffCostModel:
    """Decides, per prefill completion, whether exporting the KV beats
    keeping the decode colocated with the prefill pool."""

    def __init__(self, cfg: Optional[HandoffCostConfig] = None,
                 *, min_handoff_tokens: int = 0):
        self.cfg = cfg or HandoffCostConfig()
        self.min_handoff_tokens = min_handoff_tokens

    def handoff_cost_ms(self, kv_tokens: int, bytes_per_token: int) -> float:
        mb = kv_tokens * max(bytes_per_token, 0) / 2**20
        return 2 * (self.cfg.link_fixed_ms + self.cfg.link_ms_per_mb * mb)

    def colocated_cost_ms(self, remaining_decode_tokens: int) -> float:
        return self.cfg.contention_ms_per_token * max(remaining_decode_tokens, 0)

    def should_handoff(self, kv_tokens: int, remaining_decode_tokens: int,
                       bytes_per_token: int) -> bool:
        """Short prompts with short decodes stay colocated (moving their KV
        costs more than the contention it avoids); everything past the floor
        moves when the transfer amortizes over the remaining decode."""
        if kv_tokens < self.min_handoff_tokens:
            return False
        return (
            self.handoff_cost_ms(kv_tokens, bytes_per_token)
            <= self.colocated_cost_ms(remaining_decode_tokens)
        )


class AlwaysHandoff:
    """Degenerate policy: every prefill completion migrates (subject only to
    the token floor).  The parity tests use it so each request exercises the
    full export/import path."""

    def __init__(self, min_handoff_tokens: int = 0):
        self.min_handoff_tokens = min_handoff_tokens

    def should_handoff(self, kv_tokens: int, remaining_decode_tokens: int,
                       bytes_per_token: int) -> bool:
        return kv_tokens >= self.min_handoff_tokens
