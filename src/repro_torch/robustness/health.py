"""Replica health state machine: HEALTHY → SUSPECT → DEAD, with probation.

Driven entirely from the ``ReplicaServer.step`` status protocol — the same
strings the serve loops already use for quiesce detection — so health needs
no side channel: ``"error"`` (a caught step exception) counts against the
replica, any productive status (``"round"``/``"drained"``/``"finalized"``)
counts toward recovery, and a replica that keeps reporting ``"starved"``
while holding work is treated as missing progress.

Transitions:

    HEALTHY --[suspect_after consecutive errors]--> SUSPECT
    SUSPECT --[probation consecutive clean rounds]--> HEALTHY
    SUSPECT --[dead_after total consecutive errors]--> DEAD   (terminal)

SUSPECT replicas keep serving what they own but receive no new placements;
DEAD triggers router failover and is never revisited.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional, Tuple

_PROGRESS = ("round", "drained", "finalized")


class HealthState(enum.Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    DEAD = "dead"


@dataclass(frozen=True)
class HealthConfig:
    suspect_after: int = 1   # consecutive step errors before SUSPECT
    dead_after: int = 3      # consecutive step errors before DEAD
    probation: int = 2       # consecutive clean productive steps to recover
    stall_after: int = 0     # consecutive starved-while-busy steps counted as
    #                          one error (0 disables missed-progress detection)

    def __post_init__(self):
        if not (1 <= self.suspect_after <= self.dead_after):
            raise ValueError("need 1 <= suspect_after <= dead_after")
        if self.probation < 1:
            raise ValueError("probation must be >= 1")


class ReplicaHealth:
    def __init__(self, cfg: Optional[HealthConfig] = None, name: str = "?"):
        self.cfg = cfg or HealthConfig()
        self.name = name
        self.state = HealthState.HEALTHY
        self.consecutive_errors = 0
        self.clean_streak = 0
        self.starved_streak = 0
        self.errors_total = 0
        self.transitions: List[Tuple[HealthState, HealthState]] = []
        self.last_error: Optional[BaseException] = None

    # -- observations --------------------------------------------------------
    def observe(self, status: str, *, busy: bool = False,
                error: Optional[BaseException] = None) -> HealthState:
        """Feed one step's status; returns the (possibly new) state."""
        if self.state is HealthState.DEAD:
            return self.state
        if status == "error":
            self.last_error = error
            self._on_error()
            return self.state
        if status in _PROGRESS:
            self.starved_streak = 0
            self._on_clean()
        elif status == "starved" and busy and self.cfg.stall_after > 0:
            self.starved_streak += 1
            if self.starved_streak >= self.cfg.stall_after:
                self.starved_streak = 0
                self._on_error()
        # "idle" is neutral: an empty replica is neither failing nor recovering
        return self.state

    def _on_error(self) -> None:
        self.errors_total += 1
        self.consecutive_errors += 1
        self.clean_streak = 0
        if self.consecutive_errors >= self.cfg.dead_after:
            self._transition(HealthState.DEAD)
        elif self.consecutive_errors >= self.cfg.suspect_after:
            self._transition(HealthState.SUSPECT)

    def _on_clean(self) -> None:
        self.consecutive_errors = 0
        if self.state is HealthState.SUSPECT:
            self.clean_streak += 1
            if self.clean_streak >= self.cfg.probation:
                self._transition(HealthState.HEALTHY)
        else:
            self.clean_streak = 0

    def _transition(self, to: HealthState) -> None:
        if to is self.state:
            return
        self.transitions.append((self.state, to))
        self.state = to
        self.clean_streak = 0

    # -- queries -------------------------------------------------------------
    @property
    def is_dead(self) -> bool:
        return self.state is HealthState.DEAD

    @property
    def accepts_work(self) -> bool:
        """Only HEALTHY replicas receive new placements; SUSPECT ones drain."""
        return self.state is HealthState.HEALTHY
