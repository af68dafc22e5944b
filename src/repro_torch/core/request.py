"""Request model and lifecycle for chunked-prefill serving.

State machine:  WAITING -> PREFILLING -> DECODING -> FINISHED
A request may bounce between WAITING and PREFILLING across rounds (it returns
to the prefill queue with updated priority after each chunk, per §3.1.3).
"""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import List, Optional

_req_counter = itertools.count()


class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"


@dataclass
class Request:
    prompt_len: int
    max_new_tokens: int
    arrival_time: float = 0.0
    req_id: int = field(default_factory=lambda: next(_req_counter))
    tenant: str = "default"
    prompt_tokens: Optional[List[int]] = None      # real-engine mode

    # progress
    state: RequestState = RequestState.WAITING
    prefill_done: int = 0
    generated: int = 0
    output_tokens: List[int] = field(default_factory=list)

    # timestamps (set by the engine/simulator clock)
    prefill_end_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    # scheduling accounting
    rounds_scheduled: int = 0
    chunks: List[int] = field(default_factory=list)
    preemptions: int = 0
    folded_tokens: int = 0      # generated tokens folded into the prompt by preempt()
    # token id the executor sampled this round, delivered by the next
    # receive_token (real engine sets it; the simulator leaves 0 — it has no
    # token values).  Matters beyond reporting: preempt() folds delivered
    # tokens into the prompt, so recompute must re-prefill the REAL ids.
    next_token: int = 0
    # swap-out preemption: the victim's KV was staged host-side instead of
    # discarded, so it re-enters the queue decode-resumable (progress kept)
    swapped: bool = False
    swap_preemptions: int = 0
    # cross-replica disaggregation: prefill-complete handoffs taken (the KV
    # left one replica's pool through the handoff store and re-entered
    # another's; not a preemption — nothing is recomputed or discarded)
    handoffs: int = 0
    # optional EOS id: generation terminates when the sampled token equals
    # it (value-dependent stop; None = length-capped only).  The simulator
    # has no token values, so it must leave this None.
    stop_token: Optional[int] = None
    stopped: bool = False       # finished via stop_token, not the length cap
    # host-visibility timestamps of each delivered token (serve loops stamp
    # these at drain time); consecutive gaps are the inter-token latencies
    token_times: List[float] = field(default_factory=list)
    # set by resume(): the engine's device-resident last_token lane was lost
    # with the old slot, so the first post-restore decode round must stage
    # the last delivered token id from the host instead of consuming it
    needs_replay: bool = False
    # SLO load shedding: the request was retired WITHOUT service completion
    # because its deadline was projected infeasible ("admission" at submit,
    # "deadline" from the queue).  Shed requests are FINISHED with
    # finish_time None — they count in the shed attainment bucket, never as
    # violations.
    shed_reason: Optional[str] = None

    @property
    def remaining_prefill(self) -> int:
        return self.prompt_len - self.prefill_done

    @property
    def context_len(self) -> int:
        # folded tokens live inside prefill_done after a preemption recompute;
        # subtracting them keeps the physical KV length exact
        return self.prefill_done + self.generated - self.folded_tokens

    @property
    def is_prefill(self) -> bool:
        return self.state in (RequestState.WAITING, RequestState.PREFILLING)

    def receive_chunk(self, c: int) -> None:
        assert 0 < c <= self.remaining_prefill, (c, self.remaining_prefill)
        self.prefill_done += c
        self.chunks.append(c)
        self.rounds_scheduled += 1
        self.state = (
            RequestState.DECODING if self.remaining_prefill == 0 else RequestState.PREFILLING
        )

    def preempt(self) -> None:
        """Evicted under KV pressure: the request's blocks were freed, so its
        context must be recomputed from scratch.  Tokens already generated
        were delivered (streamed) and are folded into the prompt — recompute
        re-prefills prompt + generated tokens (vLLM recompute semantics), so
        decode resumes conditioned on the full delivered context."""
        assert self.state in (
            RequestState.WAITING, RequestState.PREFILLING, RequestState.DECODING,
        ), self.state
        unfolded = self.generated - self.folded_tokens
        if unfolded > 0:
            self.prompt_len += unfolded
            if self.prompt_tokens is not None:
                self.prompt_tokens = (
                    list(self.prompt_tokens) + list(self.output_tokens[self.folded_tokens:])
                )
            self.folded_tokens = self.generated
        self.state = RequestState.WAITING
        self.prefill_done = 0
        self.preemptions += 1
        # a recompute rebuilds everything, including the last token's KV —
        # the prefill-completing round samples normally, nothing to replay
        self.swapped = False
        self.needs_replay = False

    def swap_preempt(self) -> None:
        """Evicted under KV pressure with its KV *staged host-side* instead
        of discarded: progress (``prefill_done``/``generated``) is kept and
        nothing is folded into the prompt — the request re-enters the queue
        decode-resumable, costing one restore round rather than a full
        recompute prefill."""
        assert self.state in (
            RequestState.WAITING, RequestState.PREFILLING, RequestState.DECODING,
        ), self.state
        self.state = RequestState.WAITING
        self.swapped = True
        self.preemptions += 1
        self.swap_preemptions += 1

    def handoff(self) -> None:
        """Prefill completed on one replica and the KV is being exported for
        a decode replica to import: same decode-resumable bookkeeping as
        ``swap_preempt`` (progress kept, nothing folded), but counted as a
        handoff — migrating at the prefill/decode boundary is a placement
        decision, not a preemption."""
        assert self.state == RequestState.DECODING, self.state
        assert self.remaining_prefill <= 0, "handoff before prefill completed"
        self.state = RequestState.WAITING
        self.swapped = True
        self.handoffs += 1

    def resume(self) -> None:
        """Swap-in completed: the staged KV is device-resident again.  A
        fully-prefilled victim rejoins the decode set (its next decode round
        must replay the last delivered token id — the device-resident
        ``last_token`` lane died with the old slot); a mid-prefill victim
        stays WAITING and simply continues chunking over the restored KV."""
        assert self.swapped, "resume() of a request that was never swapped"
        self.swapped = False
        if self.remaining_prefill <= 0:
            self.state = RequestState.DECODING
            self.needs_replay = True

    def patch_token(self, i: int, tok: int) -> None:
        """Pipelined engines deliver token VALUES one round late: the round's
        bookkeeping (``receive_token``) runs against a placeholder while the
        device round executes, and the real id is patched in here once the
        async host copy drains.  If a preemption already folded the
        placeholder into the prompt (recompute semantics), the folded copy is
        fixed too — folded token ``i`` lives at prompt position
        ``original_prompt_len + i`` and the fold always happens before the
        re-prefill of that position is staged."""
        self.output_tokens[i] = tok
        if i < self.folded_tokens and self.prompt_tokens is not None:
            self.prompt_tokens[self.prompt_len - self.folded_tokens + i] = tok

    def finish_stopped(self, now: float = 0.0) -> None:
        """Value-dependent termination: the last delivered token matched
        ``stop_token``.  Serve loops call this when the real id becomes
        host-visible — which in a pipelined engine is one round AFTER the
        length bookkeeping ran (the request may even have been preempted,
        swapped out, or scheduled again in between)."""
        assert self.state != RequestState.FINISHED
        self.state = RequestState.FINISHED
        self.stopped = True
        self.swapped = False
        self.needs_replay = False
        self.finish_time = now

    def rollback_undrained(self, n: int = 1) -> int:
        """Crash/quarantine unwind: discard the last ``n`` UNDRAINED output
        tokens — placeholders a pipelined round booked via ``receive_token``
        whose values never became host-visible (the round crashed before its
        drain, or the drain read non-finite garbage).  Only undrained tokens
        may be rolled back: delivered tokens are streamed and irrevocable
        (at-most-once delivery); the caller re-executes the rolled-back
        positions via greedy recompute, which regenerates identical values.
        Reverts a same-round length-cap finish.  Returns how many tokens were
        actually popped."""
        assert n >= 0
        popped = 0
        for _ in range(n):
            if self.generated <= self.folded_tokens:
                break  # everything left was folded (delivered + re-prefilled)
            self.output_tokens.pop()
            self.generated -= 1
            popped += 1
        if popped and self.state == RequestState.FINISHED and not self.stopped:
            self.state = RequestState.DECODING
            self.finish_time = None
        if popped and self.generated == 0:
            self.first_token_time = None
        # token_times stay untouched: stamps exist only for DRAINED tokens,
        # and rollback by construction touches only undrained ones
        return popped

    def receive_token(self, tok: int = 0, now: float = 0.0) -> None:
        assert self.state == RequestState.DECODING
        self.generated += 1
        self.output_tokens.append(tok)
        if self.first_token_time is None:
            self.first_token_time = now
        if self.generated >= self.max_new_tokens:
            self.state = RequestState.FINISHED
            self.finish_time = now

    # metrics -----------------------------------------------------------------
    def e2e_latency(self) -> Optional[float]:
        return None if self.finish_time is None else self.finish_time - self.arrival_time

    def ttft(self) -> Optional[float]:
        return (
            None
            if self.first_token_time is None
            else self.first_token_time - self.arrival_time
        )

    def prefill_e2e(self) -> Optional[float]:
        return (
            None
            if self.prefill_end_time is None
            else self.prefill_end_time - self.arrival_time
        )
