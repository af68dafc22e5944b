"""Tenant registry and fairness configuration.

A *tenant* is the multi-tenant unit of fairness: an API client, an
organization, or a traffic class.  The paper's Aging policy is fair across
REQUESTS; the tenancy subsystem layers fairness across TENANTS on top of it
(FairBatching / VTC-style), so one heavy client cannot starve the rest even
when every individual request is aged correctly.

``TenantSpec`` carries the per-tenant knobs: a weight (proportional share of
service), an optional token-bucket rate limit (tokens/s + burst), and
optional TTFT/E2E latency SLOs (reported always; enforced by the scheduler
when ``SchedulerConfig.slo`` is set).  ``TenantRegistry`` resolves specs at
runtime and — by default — auto-registers unknown tenants with weight 1 so
untagged traffic keeps working.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

DEFAULT_TENANT = "default"


@dataclass(frozen=True)
class TenantSpec:
    name: str
    weight: float = 1.0                    # proportional service share (>0)
    rate_tokens_per_s: float = 0.0         # token-bucket rate; 0 = unlimited
    burst_tokens: float = 0.0              # bucket depth; 0 = 2x rate
    # latency SLOs.  Reporting gauges always; with ``SchedulerConfig.slo``
    # set they additionally DRIVE the scheduler (deadline-aware LPRS,
    # SLO-weighted victim selection, APC protection, load shedding).
    ttft_slo_s: Optional[float] = None     # time-to-first-token target
    e2e_slo_s: Optional[float] = None      # end-to-end completion target
    # KV-cache quota as a fraction of the block pool this tenant may PIN at
    # once (None = unlimited).  Enforced by KVBlockPool at allocation and at
    # prefix-cache acquisition; over-quota chunks are deferred or trigger
    # same-tenant preemption, never other tenants'.
    kv_quota_frac: Optional[float] = None

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0")
        if self.rate_tokens_per_s < 0 or self.burst_tokens < 0:
            raise ValueError(f"tenant {self.name!r}: negative rate/burst")
        if self.kv_quota_frac is not None and not (0.0 < self.kv_quota_frac <= 1.0):
            raise ValueError(
                f"tenant {self.name!r}: kv_quota_frac must be in (0, 1]"
            )

    @property
    def effective_burst(self) -> float:
        if self.burst_tokens > 0:
            return self.burst_tokens
        return 2.0 * self.rate_tokens_per_s


@dataclass(frozen=True)
class FairnessConfig:
    """Switchboard for the tenancy subsystem (``SchedulerConfig.fairness``).

    ``None`` (the default on SchedulerConfig) disables the subsystem entirely:
    the scheduler keeps the paper's single-level prefill queue, byte-identical
    behavior.
    """

    tenants: Tuple[TenantSpec, ...] = ()
    auto_register: bool = True             # unknown tenants get weight-1 specs
    # VTC charge weights: decode tokens cost more than prefill tokens per
    # token (memory-bound vs compute-bound), mirroring the VTC paper's
    # (w_p, w_q) = (1, 2) default.
    prefill_charge_weight: float = 1.0
    decode_charge_weight: float = 2.0
    # token-bucket admission control:
    #   * deprioritize — admit, but serve the tenant last until the window ends
    #   * reject       — refuse over-budget requests outright (hard quota)
    #   * queue        — delay the request until the bucket refills (the
    #                    ROADMAP's "delay instead of deprioritize/reject")
    admission: bool = True
    admission_policy: str = "deprioritize"  # "deprioritize" | "reject" | "queue"
    penalty_window_s: float = 2.0           # deprioritization window length

    def __post_init__(self):
        if self.admission_policy not in ("deprioritize", "reject", "queue"):
            raise ValueError(f"unknown admission_policy {self.admission_policy!r}")
        names = [t.name for t in self.tenants]
        if len(names) != len(set(names)):
            raise ValueError("duplicate tenant names in FairnessConfig")


class TenantRegistry:
    """Name -> TenantSpec resolution with optional auto-registration."""

    def __init__(self, specs: Tuple[TenantSpec, ...] = (), *, auto_register: bool = True):
        self._specs: Dict[str, TenantSpec] = {s.name: s for s in specs}
        self.auto_register = auto_register

    def register(self, spec: TenantSpec) -> None:
        self._specs[spec.name] = spec

    def get(self, name: str) -> TenantSpec:
        spec = self._specs.get(name)
        if spec is None:
            spec = TenantSpec(name=name)
            if self.auto_register:
                self._specs[name] = spec
        return spec

    def weight(self, name: str) -> float:
        return self.get(name).weight

    def weights(self) -> Dict[str, float]:
        return {n: s.weight for n, s in self._specs.items()}

    def names(self) -> Tuple[str, ...]:
        return tuple(self._specs)

    def __contains__(self, name: str) -> bool:
        return name in self._specs

    def __iter__(self) -> Iterator[TenantSpec]:
        return iter(self._specs.values())

    def __len__(self) -> int:
        return len(self._specs)
