"""Per-tenant SLO engine for the serve stack.

Counterpart of ``enterprise_warp_tpu/serve/slo.py`` (host arithmetic,
the same figures and events). Tenants declare objectives in the
paramfile ``serve:`` line::

    serve: slo_p95_ms=250 slo_success=0.99 slo_p95_ms.gold=100 \
           slo_window=256

(``admission.parse_serve_config`` parses the tokens; bare keys set
the ``default`` objective, ``.<tenant>`` suffixes override per
tenant; ``slo_window`` sizes the ring). The engine tracks each
tenant's last-``window`` terminal outcomes in fixed-shape host rings
(:class:`~..utils.telemetry.RingWindow`: no growing host state, no
device work, nothing on the dispatch hot path) and derives, SRE-style:

- **burn rate** = observed bad fraction / allowed bad fraction (a
  ``p95_ms`` objective allows 5% over-threshold; a ``success``
  objective ``s`` allows ``1 - s`` failures). Burn 1.0 = consuming
  error budget exactly as fast as the objective grants it; > 1.0 =
  on track to breach.
- **error-budget remaining** = ``1 - burn`` (negative when the
  window already violates the objective).

Gauges (``slo_burn_rate{tenant=,slo=}``,
``slo_budget_remaining{tenant=,slo=}``, ``slo_observed_p95_ms`` /
``slo_observed_success{tenant=}``) land in the process registry and
therefore flow through the OpenMetrics textfile/HTTP exporters
(``utils/metricsexport.py``) unchanged. Breaches are edge-triggered
typed ``slo_breach`` events (emitted on the transition into
``burn > 1``, re-armed when the window recovers) so a stream fold
counts episodes, not samples.

An *outcome* is one terminal request disposition: a completion
(success iff it met its deadline, when it had one), a deadline shed,
or a quarantine (both failures, observed at their elapsed wall).
Admission rejections never enter the window — a request that never
entered the queue consumed no serving capacity and carries no
latency. The driver's ``slo_config`` event makes the stream
self-describing, so ``tools/observatory.py`` recomputes the same
figures from ``events.jsonl`` alone.

Everything is master-gated by ``EWT_TELEMETRY`` at the edges: the
gauges are no-ops and the emit callback is an inert recorder when
telemetry is off, so a disabled run leaves no SLO artifacts.
"""

from __future__ import annotations

from ..utils import telemetry
from ..utils.telemetry import RingWindow

__all__ = ["SLOEngine", "DEFAULT_WINDOW", "OBJECTIVE_KEYS",
           "burn_rate"]

#: default per-tenant outcome-window length (ring capacity)
DEFAULT_WINDOW = 256

#: the objective vocabulary the paramfile surface accepts
#: (``slo_<key>=`` / ``slo_<key>.<tenant>=`` tokens)
OBJECTIVE_KEYS = ("p95_ms", "success")


def burn_rate(bad: int, n: int, allowed_frac: float) -> float:
    """SRE burn rate: observed bad fraction over the allowed bad
    fraction. ``allowed_frac`` is clamped away from zero so a 100%
    objective degrades to "any failure burns hard" instead of a
    division crash."""
    if n <= 0:
        return 0.0
    return (bad / n) / max(float(allowed_frac), 1e-9)


class _TenantState:
    """One tenant's fixed-shape outcome windows + breach latches."""

    __slots__ = ("lat", "ok", "breached")

    def __init__(self, window: int):
        self.lat = RingWindow(window)
        self.ok = RingWindow(window)
        self.breached: dict = {}     # slo name -> currently breached


class SLOEngine:
    """See module docstring. ``objectives`` maps tenant name (or
    ``"default"``) to ``{"p95_ms": float, "success": float}``; a
    tenant's effective objective is its own entry layered over the
    default."""

    def __init__(self, objectives: dict | None = None,
                 window: int = DEFAULT_WINDOW):
        self.objectives = {str(t): dict(o)
                           for t, o in (objectives or {}).items()}
        self.window = max(int(window), 1)
        self._tenants: dict[str, _TenantState] = {}
        self.breach_count = 0

    @classmethod
    def from_config(cls, cfg):
        """Build from ``parse_serve_config``'s ``slo`` kwarg:
        ``{"objectives": {...}, "window": N}`` (both optional).
        Returns None for an empty/None config — the driver carries no
        engine at all then."""
        if not cfg:
            return None
        objectives = cfg.get("objectives") or {}
        if not objectives:
            return None
        return cls(objectives,
                   window=cfg.get("window", DEFAULT_WINDOW))

    # ------------------------- objectives -------------------------- #
    def objective_for(self, tenant: str) -> dict:
        """Effective objective for ``tenant``: its own keys layered
        over ``default`` (empty dict = nothing declared)."""
        eff = dict(self.objectives.get("default", {}))
        eff.update(self.objectives.get(str(tenant), {}))
        return eff

    def _state(self, tenant: str) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            st = self._tenants[tenant] = _TenantState(self.window)
        return st

    # ------------------------- observation ------------------------- #
    def observe(self, tenant, elapsed_ms, ok, emit=None):
        """Fold one terminal outcome into the tenant's window, update
        the gauges, and emit an edge-triggered ``slo_breach`` event
        through ``emit`` (a ``RunRecorder.event``-shaped callable)
        when a burn rate crosses 1. Host arithmetic only."""
        tenant = str(tenant)
        obj = self.objective_for(tenant)
        if not obj:
            return None
        st = self._state(tenant)
        st.lat.push(float(elapsed_ms))
        st.ok.push(1.0 if ok else 0.0)
        verdict = self._evaluate(tenant, st, obj)
        reg = telemetry.registry()
        for slo, v in verdict.items():
            reg.gauge("slo_burn_rate", tenant=tenant,
                      slo=slo).set(v["burn_rate"])
            reg.gauge("slo_budget_remaining", tenant=tenant,
                      slo=slo).set(v["budget_remaining"])
            was = st.breached.get(slo, False)
            now = bool(v["burn_rate"] > 1.0)
            st.breached[slo] = now
            if now and not was:
                self.breach_count += 1
                if emit is not None:
                    emit("slo_breach", tenant=tenant, slo=slo,
                         objective=v["objective"],
                         observed=v["observed"],
                         burn_rate=round(v["burn_rate"], 4),
                         window_n=st.lat.n)
        if "p95_ms" in obj:
            reg.gauge("slo_observed_p95_ms", tenant=tenant).set(
                st.lat.quantile(0.95))
        if "success" in obj:
            reg.gauge("slo_observed_success", tenant=tenant).set(
                st.ok.mean())
        return verdict

    def _evaluate(self, tenant, st, obj) -> dict:
        """Burn rates over the CURRENT window contents. A ``p95_ms``
        objective burns on the fraction of outcomes over the
        threshold (allowed 5%); ``success`` burns on the failure
        fraction (allowed ``1 - s``)."""
        out = {}
        n = st.lat.n
        if "p95_ms" in obj and n:
            thr = float(obj["p95_ms"])
            bad = int((st.lat.values() > thr).sum())
            b = burn_rate(bad, n, 0.05)
            out["p95_ms"] = {
                "objective": thr,
                "observed": st.lat.quantile(0.95),
                "burn_rate": b, "budget_remaining": 1.0 - b}
        if "success" in obj and n:
            target = float(obj["success"])
            bad = int(n - st.ok.values().sum())
            b = burn_rate(bad, n, 1.0 - target)
            out["success"] = {
                "objective": target,
                "observed": st.ok.mean(),
                "burn_rate": b, "budget_remaining": 1.0 - b}
        return out

    # ------------------------- reporting --------------------------- #
    def summary(self) -> dict:
        """JSON-ready roll-up: per-tenant burn/budget/observed plus
        the episode count — folded into ``ServeDriver.summary()``."""
        tenants = {}
        for tenant, st in sorted(self._tenants.items()):
            obj = self.objective_for(tenant)
            verdict = self._evaluate(tenant, st, obj)
            tenants[tenant] = {
                "window_n": st.lat.n,
                "objectives": obj,
                "slo": {k: {kk: (round(vv, 4)
                                 if isinstance(vv, float) else vv)
                            for kk, vv in v.items()}
                        for k, v in verdict.items()},
                "breached": {k: bool(b)
                             for k, b in st.breached.items()},
            }
        return {"window": self.window,
                "breach_episodes": self.breach_count,
                "tenants": tenants}
