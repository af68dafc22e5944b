"""Weighted Virtual Token Counter (VTC) — per-tenant service accounting.

Each tenant carries a *virtual service* counter u_t.  When the engine
executes a batch, every tenant is charged for the tokens it actually
received:

    u_t += (w_p * prefill_tokens + w_q * decode_tokens) / weight_t

The inter-tenant scheduler always serves the backlogged tenant with the
LOWEST virtual service, which converges to weighted max-min fair service
(tenant t receives service proportional to weight_t while backlogged).

Charging happens post-execution (``ChunkedPrefillScheduler.on_batch_done``)
so the counter reflects tokens actually delivered — a chunk trimmed or
blocked by APC is never charged.

The *lift* rule (``on_activate``) prevents idle-credit banking: a tenant
that was idle re-enters at ``max(own, min over active tenants)`` instead of
keeping a stale low counter that would let it monopolize the engine to
"catch up" on service it never queued for.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional

from repro_torch.tenancy.tenants import TenantRegistry


@dataclass
class TenantService:
    """Raw (unweighted) accounting for one tenant, for reports/invariants."""

    prefill_tokens: int = 0
    decode_tokens: int = 0
    charges: int = 0                       # number of charge events
    lifted: float = 0.0                    # total virtual service added by lifts

    @property
    def actual_tokens(self) -> int:
        return self.prefill_tokens + self.decode_tokens


class VirtualTokenCounter:
    def __init__(
        self,
        registry: TenantRegistry,
        *,
        prefill_weight: float = 1.0,
        decode_weight: float = 2.0,
    ):
        self.registry = registry
        self.prefill_weight = prefill_weight
        self.decode_weight = decode_weight
        self._virtual: Dict[str, float] = {}
        self._service: Dict[str, TenantService] = {}

    # -- accounting -----------------------------------------------------------
    def charge(self, tenant: str, prefill_tokens: int, decode_tokens: int) -> float:
        """Charge executed tokens; returns the virtual-service increment."""
        if prefill_tokens < 0 or decode_tokens < 0:
            raise ValueError("negative token charge")
        if prefill_tokens == 0 and decode_tokens == 0:
            return 0.0
        w = self.registry.weight(tenant)
        inc = (
            self.prefill_weight * prefill_tokens
            + self.decode_weight * decode_tokens
        ) / w
        self._virtual[tenant] = self._virtual.get(tenant, 0.0) + inc
        svc = self._service.setdefault(tenant, TenantService())
        svc.prefill_tokens += prefill_tokens
        svc.decode_tokens += decode_tokens
        svc.charges += 1
        return inc

    def refund(self, tenant: str, prefill_tokens: int = 0,
               decode_tokens: int = 0) -> float:
        """Refund charged tokens whose work was DISCARDED before delivery (a
        crashed round's undrained placeholders, a quarantined non-finite
        sample).  The inverse of ``charge``: the tenant's virtual service and
        raw counters both come back down, keeping fleet-wide charge equal to
        executed-and-surviving work.  Never use it for delivered tokens —
        streamed output is irrevocable and its service was really rendered."""
        if prefill_tokens < 0 or decode_tokens < 0:
            raise ValueError("negative token refund")
        if prefill_tokens == 0 and decode_tokens == 0:
            return 0.0
        w = self.registry.weight(tenant)
        dec = (
            self.prefill_weight * prefill_tokens
            + self.decode_weight * decode_tokens
        ) / w
        self._virtual[tenant] = self._virtual.get(tenant, 0.0) - dec
        svc = self._service.setdefault(tenant, TenantService())
        svc.prefill_tokens -= prefill_tokens
        svc.decode_tokens -= decode_tokens
        assert svc.prefill_tokens >= 0 and svc.decode_tokens >= 0, (
            f"refund exceeds charged service for tenant {tenant!r}"
        )
        return dec

    def on_activate(self, tenant: str, active: Iterable[str]) -> None:
        """Lift a (re)activating tenant's counter to the active floor.

        ``active`` is the set of tenants currently holding queued or running
        work, EXCLUDING ``tenant`` itself.  With no active peers there is no
        service to be fair against and the counter is left untouched.
        """
        floor: Optional[float] = None
        for t in active:
            if t == tenant:
                continue
            v = self._virtual.get(t, 0.0)
            floor = v if floor is None else min(floor, v)
        if floor is None:
            return
        own = self._virtual.get(tenant, 0.0)
        if floor > own:
            self._service.setdefault(tenant, TenantService()).lifted += floor - own
            self._virtual[tenant] = floor

    # -- views ---------------------------------------------------------------
    def virtual_service(self, tenant: str) -> float:
        return self._virtual.get(tenant, 0.0)

    def service(self, tenant: str) -> TenantService:
        return self._service.get(tenant, TenantService())

    def actual_tokens(self, tenant: str) -> int:
        return self.service(tenant).actual_tokens

    def tenants(self) -> Iterable[str]:
        return self._virtual.keys()

    def total_actual_tokens(self) -> int:
        return sum(s.actual_tokens for s in self._service.values())

    def total_prefill_tokens(self) -> int:
        return sum(s.prefill_tokens for s in self._service.values())

    def total_decode_tokens(self) -> int:
        return sum(s.decode_tokens for s in self._service.values())

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {
            t: {
                "virtual": self._virtual.get(t, 0.0),
                "prefill_tokens": s.prefill_tokens,
                "decode_tokens": s.decode_tokens,
                "lifted": s.lifted,
            }
            for t, s in self._service.items()
        }
