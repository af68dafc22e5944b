"""Disaggregated prefill/decode serving: pool-of-replicas router with
cross-replica KV handoff.

Topology: ``n_prefill`` replicas admit and chunk-prefill new requests;
``n_decode`` replicas run steady-state decode.  Each replica is a full
(scheduler, engine, pool) stack driven as a ``ReplicaServer`` inside ONE
host loop — the router interleaves ``step()`` calls, so a single process
serves the whole fleet deterministically (the real deployment would run one
process per replica; nothing here depends on co-residency except the test
harness's determinism).

Handoff lifecycle (all on the pipelined one-round-late path):
  1. a request completes its prefill on a prefill replica; the round's
     ``on_prefill_complete`` hook asks the cost policy handoff-vs-colocate
  2. handoff: the source engine gathers the KV into a staging tensor
     (async device→host copy), the scheduler forgets the request
     (``export_request``), and the request parks WAITING/swapped
  3. when the copy drains (source drain finalizes it — the same drain that
     patches the request's first REAL token, so the decode side never stages
     a placeholder), the record leaves the source pool (``export_swap``)
     through the ``KVHandoffStore`` into the chosen decode pool
     (``import_swap``)
  4. the decode scheduler restores it via the ordinary swap-in path —
     decode-resumable, ``needs_replay`` staging the delivered first token —
     so ZERO prefill tokens are ever scheduled on the decode side
Placement is KV-locality- and load-aware: prefer the decode replica already
holding the longest shared prefix (``probe_prefix``), tie-break by
per-tenant then total outstanding work.  With fairness configured all
replicas share ONE VirtualTokenCounter, so a tenant's service aggregates
across the fleet — fanning out buys no extra share (anti-laundering).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.request import Request, RequestState
from repro_torch.core.scheduler import ChunkedPrefillScheduler, SchedulerConfig
from repro_torch.disagg.handoff import (
    AlwaysHandoff, HandoffCostConfig, HandoffCostModel, KVHandoffStore,
)
from repro_torch.engine.engine import (
    EngineConfig, ReplicaServer, TorchEngine, compress_idle_gap,
)
from repro_torch.engine.kv_cache import pool_for_model
from repro_torch.engine.metrics import (
    LatencyReport, MemoryReport, RobustnessReport, SLOReport, summarize,
    summarize_memory, summarize_robustness, summarize_slo,
)
from repro_torch.robustness import FailoverStats, ReplicaHealth, RobustnessConfig


@dataclass
class DisaggConfig:
    n_prefill: int = 1
    n_decode: int = 1
    # prompts whose KV is shorter than this never migrate (floor under any
    # cost policy — moving a tiny prefix is pure overhead)
    min_handoff_tokens: int = 0
    # None: every completion past the floor migrates (AlwaysHandoff).  A
    # HandoffCostConfig prices transfer bytes against colocated contention
    # per request, keeping short-prompt/short-decode requests local.
    cost: Optional[HandoffCostConfig] = None
    # Prefetch: start the decode-side import while the source gather is still
    # draining — the record (still SWAPPING) moves source pool → store →
    # decode pool in the SAME pump that observed the prefill completion,
    # instead of parking in ``_pending`` until ``swap_ready``.  The decode
    # restore stays correct because ``_try_restore`` gates on ``swap_ready``,
    # which only flips once the source drain finalizes the (shared) record.
    # Late stops are unwound through ``ReplicaServer.on_stopped``.
    prefetch: bool = True
    # Fault tolerance: None (default) leaves every path bit-identical to the
    # fault-oblivious router.  Set, it wires replica health tracking, crash
    # unwinding, failover re-placement with bounded retries, handoff TTLs,
    # and (optionally) a seeded chaos injector into the fleet.
    robustness: Optional[RobustnessConfig] = None


@dataclass
class DisaggResult:
    report: LatencyReport
    requests: List[Request]
    rounds: int                         # Σ scheduling rounds over the fleet
    wall_s: float
    outputs: Dict[int, List[int]]
    replica_rounds: List[int]           # per replica (prefill pool first)
    handoffs: int                       # records delivered across the link
    dropped_handoffs: int               # killed mid-handoff
    colocated: int                      # completions the cost policy kept local
    bytes_moved: int
    memory: Optional[List[MemoryReport]] = None
    slo: Optional[SLOReport] = None     # fleet-wide per-tenant attainment
    robustness: Optional[RobustnessReport] = None   # failover/chaos summary


class DisaggregatedRouter:
    """Fronts a prefill pool and a decode pool of ``ReplicaServer``s.

    Admission goes to the least-loaded prefill replica; handoffs drain
    through ``pump()``; ``serve_disagg`` drives the whole fleet.
    """

    def __init__(
        self,
        prefill: List[ReplicaServer],
        decode: List[ReplicaServer],
        cfg: Optional[DisaggConfig] = None,
        store: Optional[KVHandoffStore] = None,
    ):
        assert prefill, "need at least one prefill replica"
        assert decode, "need at least one decode replica"
        self.cfg = cfg or DisaggConfig()
        self.prefill = list(prefill)
        self.decode = list(decode)
        self.store = store if store is not None else KVHandoffStore()
        if self.cfg.cost is not None:
            self.policy = HandoffCostModel(
                self.cfg.cost, min_handoff_tokens=self.cfg.min_handoff_tokens)
        else:
            self.policy = AlwaysHandoff(self.cfg.min_handoff_tokens)
        # (request, source replica): exported, gather not yet host-resident
        self._pending: List[Tuple[Request, ReplicaServer]] = []
        for rs in self.prefill:
            rs.on_prefill_complete = self._maybe_handoff
            rs.on_stopped = self._on_source_stop

        # -- fault tolerance (cfg.robustness) ---------------------------------
        rcfg = self.cfg.robustness
        self.rstats = FailoverStats()
        self.health: Dict[str, ReplicaHealth] = {}
        self.dead: set = set()                    # replica names declared DEAD
        self._retries: Dict[int, int] = {}        # req_id -> failover retries
        self._retry_queue: List[Tuple[float, Request]] = []   # (ready_at, req)
        self._stalled: Dict[int, Request] = {}    # staged-in-store, stalled
        self._handoff_src: Dict[int, str] = {}    # rid -> source of a prefetch
        self.injector = None
        if rcfg is not None:
            self.injector = rcfg.make_injector()
            for rs in self.replicas:
                rs.injector = self.injector
                rs.fault_tolerant = True
                rs.max_crash_retries = rcfg.max_retries
                self.health[rs.name] = ReplicaHealth(rcfg.health, rs.name)
            if rcfg.handoff_ttl_s is not None and self.store.ttl_s is None:
                self.store.ttl_s = rcfg.handoff_ttl_s

    @property
    def replicas(self) -> List[ReplicaServer]:
        return self.prefill + self.decode

    @property
    def live_prefill(self) -> List[ReplicaServer]:
        return [rs for rs in self.prefill if rs.name not in self.dead]

    @property
    def live_decode(self) -> List[ReplicaServer]:
        return [rs for rs in self.decode if rs.name not in self.dead]

    @property
    def live_replicas(self) -> List[ReplicaServer]:
        return [rs for rs in self.replicas if rs.name not in self.dead]

    def pending_work(self) -> bool:
        """Router-held work a quiesce check must wait on: in-flight exports,
        stalled store entries (their TTL will reap them), delayed retries."""
        return bool(self._pending or self._stalled or self._retry_queue)

    # -- admission -------------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Admit to the least-loaded LIVE prefill replica (outstanding
        prefill + decode tokens; replica index breaks ties
        deterministically).  Graceful degradation: with the prefill pool
        emptied by failures, new work colocates on the decode pool; with the
        whole fleet dead it sheds terminally."""
        pool = self.live_prefill
        if not pool:
            pool = self.live_decode
            if not pool:
                self._shed_failed(req)
                return
            self.rstats.colocated_fallbacks += 1
        best = min(range(len(pool)),
                   key=lambda i: (pool[i].outstanding_work(), i))
        pool[best].submit(req)

    # -- handoff: source side --------------------------------------------------
    def _maybe_handoff(self, server: ReplicaServer, req: Request) -> None:
        """Prefill just completed on ``server``.  Export the KV unless the
        cost policy keeps the decode colocated."""
        kv_tokens = server.kv_pool.lens.get(req.req_id, 0)
        remaining = req.max_new_tokens - req.generated
        if not self.policy.should_handoff(
                kv_tokens, remaining, server.kv_pool.cfg.bytes_per_token):
            self.store.stats.colocated += 1
            return
        if not self.live_decode:
            # graceful degradation: the decode pool is gone — keep the decode
            # colocated on the prefill replica instead of exporting into a
            # store nobody can adopt from
            self.store.stats.colocated += 1
            self.rstats.colocated_fallbacks += 1
            return
        if (self.injector is not None and self.injector.fire(
                "swap_gather_fail", replica=server.name,
                req_id=req.req_id) is not None):
            # the gather failed BEFORE any pool state moved: cleanest
            # possible fallback — the request simply decodes colocated
            self.store.stats.colocated += 1
            self.rstats.colocated_fallbacks += 1
            self.rstats.note(f"swap_gather_fail req {req.req_id}: colocated")
            return
        if (server.kv_pool.swap_state(req.req_id) is not None
                or not server.kv_pool.host_can_stage(kv_tokens)
                or not self._store_can_stage(server, kv_tokens)):
            # no host budget for the transfer (the tier is pinned by bytes
            # this pool cannot evict) or a stale staging record: decode
            # colocated — no tier reservation may ever assert
            self.store.stats.colocated += 1
            self.rstats.colocated_fallbacks += 1
            return
        # gather + async device→host copy + slot release + SWAPPING record —
        # the engine still holds the slot here, so swap_out must precede the
        # scheduler export (which only drops bookkeeping, never pool state)
        server.engine.swap_out(req)
        server.sched.export_request(req)
        req.handoff()
        self._pending.append((req, server))

    def _store_can_stage(self, src: ReplicaServer, kv_tokens: int) -> bool:
        """True when the handoff store can charge this record's bytes.  On a
        tier SHARED with the source pool the move is net zero (``export``
        releases exactly what ``put`` charges), so only a store with its own
        budget needs the headroom check."""
        if self.store.host is None or self.store.host is src.kv_pool.host:
            return True
        return self.store.can_stage(src.kv_pool.host_bytes_for(kv_tokens))

    # -- handoff: delivery -----------------------------------------------------
    def pump(self, now: float = 0.0) -> int:
        """Move handoffs: source pool → store → chosen decode pool.

        Without prefetch a record waits in ``_pending`` until the source
        gather has drained (``swap_ready``); with prefetch it is exported
        immediately (``allow_inflight``) and adopted while still SWAPPING —
        the decode scheduler cannot restore it early because ``_try_restore``
        gates on ``swap_ready``, and the source drain finalizes the shared
        record in place wherever it lives.  A request that died while its
        copy was in flight (a value-dependent stop applied at the source
        drain — which already dropped the staging record via ``on_stop``) is
        discarded without touching any pool.

        With robustness configured the pump also drains the failover retry
        queue (backoff expiry), reaps TTL-expired store entries (stalled
        handoffs fall back to re-prefill), and fires the in-transfer chaos
        sites: ``handoff_drop`` (payload lost → re-prefill), ``handoff_stall``
        (record parks in the store until the TTL reaps it), and ``host_oom``
        (no staging memory → the decode stays colocated on the source).
        Returns handoffs delivered."""
        # delayed failover retries whose backoff elapsed re-enter the fleet
        if self._retry_queue:
            due = [r for t, r in self._retry_queue if t <= now]
            self._retry_queue = [(t, r) for t, r in self._retry_queue
                                 if t > now]
            for req in due:
                self._submit_requeued(req)
        # TTL: staged-but-never-adopted records are reaped; their requests
        # lose decode-resumability and retry through the re-prefill path
        for rid in self.store.expire(now):
            self.rstats.expired_handoffs += 1
            req = self._stalled.pop(rid, None)
            if req is not None and req.state != RequestState.FINISHED:
                self.rstats.note(f"handoff of req {rid} expired: re-prefill")
                self._requeue(req, now)
        if self._stalled and self.store.ttl_s is None:
            # no TTL configured to ever reap a stalled record: fail fast to
            # re-prefill instead of wedging the fleet behind it
            for rid, req in list(self._stalled.items()):
                del self._stalled[rid]
                self.store.drop(rid)
                self._requeue(req, now)

        moved = 0
        still: List[Tuple[Request, ReplicaServer]] = []
        for req, src in self._pending:
            if req.state == RequestState.FINISHED:
                # killed mid-handoff: on_stop cleaned the source pool; make
                # the cleanup idempotent here in case the stop landed through
                # a path that did not (nothing may leak)
                src.kv_pool.drop_swap(req.req_id)
                src.kv_pool.release(req.req_id)
                self.store.stats.dropped += 1
                continue
            if src.kv_pool.swap_state(req.req_id) is None:
                # the host tier demoted the record while the handoff was
                # pending: its KV is gone from every tier — re-prefill on a
                # survivor (a recompute, never a leak)
                self.store.stats.dropped += 1
                self.rstats.note(
                    f"handoff req {req.req_id} host-demoted: re-prefill")
                self._requeue(req, now)
                continue
            ready = src.kv_pool.swap_ready(req.req_id)
            if not ready and not self.cfg.prefetch:
                still.append((req, src))      # gather still in flight
                continue
            if (self.injector is not None and self.injector.fire(
                    "handoff_drop", replica=src.name,
                    req_id=req.req_id) is not None):
                # the staged payload was lost in transfer: discard it and
                # fall back to re-prefill on a survivor (bounded retries)
                src.kv_pool.drop_swap(req.req_id)
                src.kv_pool.release(req.req_id)
                self.store.stats.dropped += 1
                self.rstats.note(f"handoff_drop req {req.req_id}: re-prefill")
                self._requeue(req, now)
                continue
            if (self.injector is not None and self.injector.fire(
                    "host_oom", replica=src.name,
                    req_id=req.req_id) is not None):
                # no host staging memory for the transfer: the record stays
                # in the source pool and the request decodes colocated —
                # still decode-resumable, zero re-prefill
                req.handoffs -= 1            # never left the replica
                src.sched.submit_handoff(req)
                self.store.stats.colocated += 1
                self.rstats.colocated_fallbacks += 1
                self.rstats.note(f"host_oom req {req.req_id}: colocated")
                continue
            if not self._store_can_stage(
                    src, src.kv_pool.swap_tokens(req.req_id)):
                # the store's private budget filled while the gather drained:
                # keep the decode colocated — still decode-resumable from
                # the source pool's record
                req.handoffs -= 1
                src.sched.submit_handoff(req)
                self.store.stats.colocated += 1
                self.rstats.colocated_fallbacks += 1
                continue
            rec, reg = src.kv_pool.export_swap(
                req.req_id, allow_inflight=not ready)
            self.store.put(req.req_id, rec, reg, src=src.name,
                           bytes_per_token=src.kv_pool.cfg.bytes_per_token,
                           now=now)
            if (self.injector is not None and self.injector.fire(
                    "handoff_stall", replica=src.name,
                    req_id=req.req_id) is not None):
                # the transfer wedged mid-flight: the record sits in the
                # store until the TTL reaps it (or the run quiesces it)
                self._stalled[req.req_id] = req
                self.rstats.note(f"handoff_stall req {req.req_id}: parked")
                continue
            dst = self._place(req)
            if not ready:
                self.store.stats.prefetched += 1
                # a prefetched record's payload still lives on the source
                # engine: remember the dependency so source death retracts it
                self._handoff_src[req.req_id] = src.name
            dst.adopt_handoff(req, *self.store.take(req.req_id))
            moved += 1
        self._pending = still
        return moved

    def _on_source_stop(self, server: ReplicaServer, req: Request) -> None:
        """A late (value-dependent) stop landed at the source drain for a
        request whose staged KV may already have been PREFETCHED onward.
        ``on_stop`` cleaned the source pool; this hook chases the record to
        wherever the pump moved it.  A delivered-then-dropped record counts
        as dropped, not delivered, so ``delivered + dropped`` still equals
        the number of handoffs attempted."""
        rid = req.req_id
        if any(r.req_id == rid for r, _ in self._pending):
            return                    # not exported yet: pump() cleans it up
        if rid in self.store:
            self.store.drop(rid)      # exported, not yet adopted
            return
        for rs in self.decode:
            # adopted but not restored: staged record, no live block table
            if (rs.kv_pool.swap_state(rid) is not None
                    and not rs.kv_pool.tables.get(rid)):
                rs.sched.retract_handoff(req)
                self.store.stats.delivered -= 1
                self.store.stats.dropped += 1
                return

    def _place(self, req: Request,
               candidates: Optional[List[ReplicaServer]] = None
               ) -> ReplicaServer:
        """Decode placement: longest resident shared prefix first (restoring
        next to cached KV makes future prefix hits free and keeps one
        tenant's conversation tree on one replica), then per-tenant
        outstanding work (spread a heavy tenant's decodes), then total load,
        then replica index.  Only LIVE replicas are ever candidates."""
        pool = candidates if candidates is not None else self.live_decode
        assert pool, "placement over an empty replica pool"

        def key(i: int):
            rs = pool[i]
            locality = rs.kv_pool.probe_prefix(req.prompt_tokens)
            return (-locality, rs.tenant_outstanding(req.tenant),
                    rs.outstanding_work(), i)
        return pool[min(range(len(pool)), key=key)]

    # -- fault tolerance -------------------------------------------------------
    def after_step(self, rs: ReplicaServer, status: str, now: float) -> None:
        """Feed one step's status into the replica's health machine; a
        HEALTHY/SUSPECT → DEAD transition triggers failover immediately."""
        h = self.health.get(rs.name)
        if h is None or h.is_dead:
            return
        err = rs.last_error if status == "error" else None
        h.observe(status, busy=rs.busy(), error=err)
        if h.is_dead:
            self.fail_replica(rs, now)

    def fail_replica(self, rs: ReplicaServer, now: float) -> None:
        """Replica death: evacuate everything it owns onto survivors.

        Durability model: death means the replica's device/serve loop is
        gone, NOT the host's memory — host-resident staging payloads
        (``swap_ready`` records) survive and re-place decode-resumable with
        ZERO re-prefilled tokens.  A still-SWAPPING record's payload needed
        the dead engine's drain to materialize, so it is lost: its request
        retries through the ``preempt()`` re-prefill fold (at-most-once
        delivery — tokens already streamed are folded, never re-emitted).
        Every retry is bounded by ``max_retries``; past it the request sheds
        terminally with ``shed_reason="replica_failure"``."""
        if rs.name in self.dead:
            return
        alive_before = len(self.live_replicas)
        self.dead.add(rs.name)
        self.rstats.replicas_died += 1
        h = self.health.get(rs.name)
        self.rstats.note(
            f"{rs.name} declared dead"
            + (f" ({h.last_error!r})" if h is not None and h.last_error else "")
        )

        # 1. unwind any torn round the dead replica still holds (rounds
        # dispatched or mid-drain when health gave up on it)
        if (rs.inflight is not None or rs._draining is not None
                or rs._pending_batch is not None):
            rs._crash_cleanup()

        pool = rs.kv_pool
        bpt = pool.cfg.bytes_per_token

        # 2. in-flight exports sourced at the dead replica
        still: List[Tuple[Request, ReplicaServer]] = []
        for req, src in self._pending:
            if src is not rs:
                still.append((req, src))
                continue
            if req.state == RequestState.FINISHED:
                pool.drop_swap(req.req_id)
                pool.release(req.req_id)
                self.store.stats.dropped += 1
                continue
            if pool.swap_ready(req.req_id):
                rec, reg = pool.export_swap(req.req_id)
                self._replace_staged(req, rec, reg, now, bpt)
            else:
                pool.drop_swap(req.req_id)
                pool.release(req.req_id)
                self.store.stats.dropped += 1
                self._requeue(req, now)
        self._pending = still

        # 3. every request the dead scheduler still owns: staged-and-ready
        # records re-place decode-resumable; everything else re-prefills
        owned = list(rs.sched.queue.requests()) + list(
            rs.sched._decoding.values())
        for req in owned:
            if req.state == RequestState.FINISHED:
                continue
            if pool.swap_ready(req.req_id):
                rs.sched.export_request(req)
                rec, reg = pool.export_swap(req.req_id)
                self._replace_staged(req, rec, reg, now, bpt)
            else:
                rs.sched.evict_request(req)
                self._requeue(req, now)

        # 4. live replicas holding PREFETCHED records whose payload needed
        # the dead source engine's drain: the gather will never finalize, so
        # retract the adoption and re-prefill
        for dec in self.live_replicas:
            for rid, src_name in list(self._handoff_src.items()):
                if src_name != rs.name:
                    continue
                if (dec.kv_pool.swap_state(rid) is None
                        or dec.kv_pool.swap_ready(rid)
                        or dec.kv_pool.tables.get(rid)):
                    continue
                victim = next((r for r in dec.sched.queue.requests()
                               if r.req_id == rid), None)
                if victim is None:
                    continue
                dec.sched.retract_handoff(victim)
                self._handoff_src.pop(rid, None)
                self.store.stats.delivered -= 1
                self.store.stats.dropped += 1
                self._requeue(victim, now)

        # 5. capacity loss: surviving schedulers' SLO trackers learn the
        # slower per-round cost NOW instead of over the EWMA window
        rcfg = self.cfg.robustness
        alive_after = max(len(self.live_replicas), 1)
        if rcfg is not None and rcfg.slo_capacity and alive_after:
            factor = alive_before / alive_after
            for live in self.live_replicas:
                if live.sched.slo is not None:
                    live.sched.slo.scale_round_cost(factor)

    def _replace_staged(self, req: Request, rec, reg, now: float,
                        bpt: int) -> None:
        """Re-place a recovered (host-resident) staging record on a
        survivor: the request resumes decode-resumable — zero re-prefilled
        tokens — through the ordinary handoff adopt/restore path."""
        self.store.put(req.req_id, rec, reg, src="failover",
                       bytes_per_token=bpt, now=now)
        if req.remaining_prefill > 0:
            candidates = self.live_prefill or self.live_decode
        else:
            candidates = self.live_decode or self.live_prefill
        if not candidates:
            self.store.drop(req.req_id)
            self._shed_failed(req)
            return
        dst = self._place(req, candidates)
        dst.adopt_handoff(req, *self.store.take(req.req_id))
        self.rstats.failovers += 1
        self.rstats.recovered_resumable += 1

    def _requeue(self, req: Request, now: float) -> None:
        """Re-prefill retry path: fold delivered tokens into the prompt
        (at-most-once delivery — greedy recompute regenerates the identical
        continuation) and retry on a survivor, bounded by ``max_retries``
        with exponential backoff."""
        rcfg = self.cfg.robustness
        k = self._retries.get(req.req_id, 0) + 1
        self._retries[req.req_id] = k
        self.rstats.retries += 1
        if rcfg is not None and k > rcfg.max_retries:
            self._shed_failed(req)
            return
        req.preempt()
        self.rstats.requeued_reprefill += 1
        base = rcfg.backoff_base_s if rcfg is not None else 0.0
        if base > 0:
            self._retry_queue.append((now + base * (2 ** (k - 1)), req))
        else:
            self._submit_requeued(req)

    def _submit_requeued(self, req: Request) -> None:
        """Route a retry to the least-loaded live prefill replica (falling
        back to the decode pool under degradation).  Admission is NOT re-run
        — the request was admitted once; a failure must not double-charge
        its tenant's token bucket."""
        targets = self.live_prefill
        if not targets:
            targets = self.live_decode
            if not targets:
                self._shed_failed(req)
                return
            self.rstats.colocated_fallbacks += 1
        best = min(targets, key=lambda rs: (rs.outstanding_work(), rs.name))
        best.kv_pool.register_request(
            req.req_id, tenant=req.tenant,
            prompt_tokens=req.prompt_tokens, prompt_len=req.prompt_len,
        )
        best.sched.requeue_failed(req)
        self.rstats.failovers += 1

    def _shed_failed(self, req: Request) -> None:
        """Terminal shed after retries (or the whole fleet) are exhausted:
        the request ends FINISHED with ``shed_reason="replica_failure"`` —
        counted, never silently lost."""
        req.shed_reason = "replica_failure"
        req.state = RequestState.FINISHED
        req.swapped = False
        self.rstats.shed_replica_failure += 1
        self.rstats.note(f"req {req.req_id} shed after replica failures")

    # -- invariants ------------------------------------------------------------
    def kv_locations(self, req_id: int) -> int:
        """How many places account for this request's KV right now: replica
        pools (live table or staged swap record) plus the handoff store.
        Live requests must always total exactly one."""
        n = 0
        for rs in self.replicas:
            pool = rs.kv_pool
            if pool.tables.get(req_id) or pool.swap_state(req_id) is not None:
                n += 1
        if req_id in self.store:
            n += 1
        return n

    def check_invariants(self) -> None:
        for rs in self.replicas:
            rs.kv_pool.check_invariants()
        self.store.check_invariants()


def build_disagg(
    model_cfg,
    *,
    cfg: Optional[DisaggConfig] = None,
    engine_cfg: Optional[EngineConfig] = None,
    sched_cfg: Optional[SchedulerConfig] = None,
    n_blocks: int = 512,
    block_size: int = 16,
    prefix_cache: bool = True,
    warmup: bool = False,
    host_max_bytes: Optional[int] = None,
    host_kv_dtype: str = "auto",
    params=None,
    device="cuda",
) -> DisaggregatedRouter:
    """Construct a whole fleet: per-replica engines (sharing ONE set of
    parameters — every replica must hold identical weights for a handoff to
    be exact), pools, and schedulers.  With fairness configured, one shared
    VirtualTokenCounter spans all schedulers (VTC anti-laundering).

    The replicas are ``TorchEngine``s on ``device`` (one card for the whole
    fleet; ``"cpu"`` runs the plain path).  ``params`` is the weight set they
    share; by default the first replica's own seeded init.

    ``host_max_bytes`` caps ONE host tier shared by every replica pool AND
    the handoff store — in-flight records charge the same budget staged
    ones do, so the fleet's host footprint is bounded end to end.
    ``host_kv_dtype="int8"`` stages quantized pages everywhere (handoffs
    ride the fused quantizing gather / dequantizing scatter)."""
    cfg = cfg or DisaggConfig()
    engine_cfg = engine_cfg or EngineConfig()
    sched_cfg = sched_cfg or SchedulerConfig()
    shared_vtc = None
    if sched_cfg.fairness is not None:
        from repro_torch.tenancy import make_shared_vtc

        shared_vtc = make_shared_vtc(sched_cfg.fairness)
    tier = None
    if host_max_bytes is not None:
        from repro_torch.engine.kv_cache import HostTier

        tier = HostTier(host_max_bytes)
    replicas: List[ReplicaServer] = []
    for i in range(cfg.n_prefill + cfg.n_decode):
        role = "prefill" if i < cfg.n_prefill else "decode"
        engine = TorchEngine(model_cfg, engine_cfg, params=params,
                             device=device)
        params = engine.params             # replicas share one weight set
        pool = pool_for_model(
            model_cfg, n_blocks=n_blocks, block_size=block_size,
            enable_prefix_cache=prefix_cache, host_kv_dtype=host_kv_dtype,
        )
        if tier is not None:
            pool.attach_host_tier(tier)
        sched = ChunkedPrefillScheduler(sched_cfg, kv_pool=pool,
                                        shared_vtc=shared_vtc)
        rs = ReplicaServer(sched, engine, kv_pool=pool,
                           name=f"{role}{i if role == 'prefill' else i - cfg.n_prefill}")
        if warmup:
            # handoff moves KV through the swap gather/scatter kernels on
            # every replica regardless of preemption mode — prewarm them
            engine.warmup(include_swap=True)
        replicas.append(rs)
    return DisaggregatedRouter(
        replicas[: cfg.n_prefill], replicas[cfg.n_prefill:], cfg,
        store=KVHandoffStore(host_tier=tier) if tier is not None else None,
    )


def serve_disagg(
    requests: List[Request],
    router: DisaggregatedRouter,
    *,
    max_rounds: int = 200_000,
) -> DisaggResult:
    """Drive the fleet to completion: admit arrivals to the prefill pool,
    round-robin one ``step()`` per replica per sweep, pump handoffs, and
    compress idle gaps exactly like single-replica ``serve`` (one shared
    clock across the fleet keeps aging/VTC comparable between replicas)."""
    pending = sorted(requests, key=lambda r: r.arrival_time)
    for r in pending:
        assert r.prompt_tokens is not None, "attach_prompt_tokens() first"
    next_i = 0
    t_start = time.perf_counter()
    for rs in router.replicas:
        rs.start(t_start)
    now = 0.0
    sweeps = 0
    while sweeps < max_rounds:
        sweeps += 1
        now = time.perf_counter() - t_start
        while next_i < len(pending) and pending[next_i].arrival_time <= now:
            router.submit(pending[next_i])
            next_i += 1
        statuses = []
        for rs in router.replicas:
            if rs.name in router.dead:
                continue
            status = rs.step(now)
            statuses.append(status)
            router.after_step(rs, status, now)
        moved = router.pump(now)
        # "error" counts as progress: the crash cleanup / failover just
        # requeued work that the next sweep will schedule
        progress = moved > 0 or any(
            s in ("round", "drained", "finalized", "error") for s in statuses)
        # quiesce is judged AFTER the pump, against live replica state — a
        # status computed before the pump is stale the moment a handoff
        # lands: the delivering sweep read the decode replica as "idle", yet
        # it now holds restorable work
        if (not progress and not router.pending_work()
                and not any(rs.busy() for rs in router.live_replicas)):
            if next_i >= len(pending):
                break
            compress_idle_gap(pending, next_i, now)
        elif not progress:
            time.sleep(0.0005)    # starved fleet: blocked on device/copies
    for rs in router.live_replicas:
        rs.finish()
    router.pump(now)              # a finish() drain can land a final gather
    now = time.perf_counter() - t_start

    outputs: Dict[int, List[int]] = {}
    # prefill replicas first so a handed-off request's decode-side (complete)
    # output wins over the source's prefill-era placeholder entry
    for rs in router.prefill + router.decode:
        outputs.update(rs.outputs)
    if router.cfg.robustness is not None:
        # under failover a request may retry on ANY replica, so pool order no
        # longer encodes freshness — the Request object is the authority (its
        # delivered tokens survive preempt folds and replica moves)
        for r in requests:
            if r.output_tokens:
                outputs[r.req_id] = list(r.output_tokens)
    stats = router.store.stats
    return DisaggResult(
        report=summarize(requests, makespan=now),
        requests=requests,
        rounds=sum(rs.rounds for rs in router.replicas),
        wall_s=now,
        outputs=outputs,
        replica_rounds=[rs.rounds for rs in router.replicas],
        handoffs=stats.delivered,
        dropped_handoffs=stats.dropped,
        colocated=stats.colocated,
        bytes_moved=stats.bytes_moved,
        memory=[
            summarize_memory(rs.kv_pool, rs.sched.stats)
            for rs in router.replicas
        ],
        # attainment is a property of the request set, not a replica: one
        # fleet-wide report against the prefill pool's registry (all replicas
        # share the tenant specs via the common FairnessConfig)
        slo=(
            summarize_slo(requests, router.prefill[0].sched.fairness.registry)
            if router.prefill and router.prefill[0].sched.fairness is not None
            else None
        ),
        robustness=(
            summarize_robustness(
                router.rstats,
                injector=router.injector,
                quarantined=sum(len(rs.quarantined) for rs in router.replicas),
                crash_unwinds=sum(rs.crash_unwinds for rs in router.replicas),
                crash_shed=sum(len(rs.crash_shed) for rs in router.replicas),
            )
            if router.cfg.robustness is not None
            else None
        ),
    )
