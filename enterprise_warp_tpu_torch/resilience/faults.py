"""Deterministic fault injection.

Counterpart of ``enterprise_warp_tpu/resilience/faults.py``: the same
plan schema, kinds and site names, so one plan drives either package.
Named injection sites are threaded through the port: ``pt.dispatch``,
``pt.ckpt``, ``pt.chain``, ``pt.nonfinite``, ``hmc.dispatch``,
``hmc.ckpt``, ``hmc.nonfinite``, ``nested.iteration``, ``nested.ckpt``,
``nested.nonfinite``, ``kernel.health``, ``psr.quarantine``,
``cli.per_pulsar``, ``ckpt.verify``, ``io.atomic_json``, ``events.flush``
and ``data.audit`` (the reference's probe-ladder and serving sites have
no counterpart yet). A *fault plan* — ``EWT_FAULT_PLAN=<json>`` or a
programmatic :class:`FaultPlan` — decides which occurrence of a site
misbehaves and how::

    {"faults": [
        {"site": "pt.dispatch", "kind": "error", "at": 2},
        {"site": "pt.ckpt",     "kind": "kill",  "at": 1},
        {"site": "pt.dispatch", "kind": "hang",  "at": 4, "hang_s": 60},
        {"site": "events.flush","kind": "kill",  "at": 3, "frac": 0.4},
        {"site": "io.atomic_json", "kind": "torn", "where": "mask_stats"}
    ]}

- ``site`` — the site name (exact match); ``at`` — the 1-based occurrence
  of that site in this process (omitted: every occurrence); ``count`` —
  consecutive occurrences from ``at`` (default 1); ``where`` — a substring
  filter on the site's string context (a write's path);
- ``kind`` — ``error`` (raise :class:`InjectedFault`, a transient
  dispatch error the supervisor retries), ``hang`` (sleep ``hang_s``
  inside the supervised region; the watchdog turns it into a
  ``DispatchHang``), ``nonfinite`` (returned: the caller poisons its
  committed output with a NaN), ``kill`` (SIGKILL; at a write site the
  caller first writes ``frac`` of its payload), ``torn`` (at a write site:
  truncate the payload to ``frac`` and go on).

Without a plan :func:`fire` is one ``is None`` check. With one, every
triggered fault counts ``fault_injected{site=}``, is recorded by the
flight recorder and (except ``kill``) lands as a ``fault`` event.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from dataclasses import dataclass, field

__all__ = ["FaultSpec", "FaultPlan", "InjectedFault", "fire", "plan",
           "install_plan", "torn_bytes", "kill_now"]


class InjectedFault(RuntimeError):
    """A fault-plan ``error`` injection: stands in for a transient
    dispatch/transport error (the retryable class)."""

    def __init__(self, site: str, occurrence: int):
        # "transport" keeps the supervisor's transient classifier
        # treating an injected error as what it simulates
        super().__init__(
            f"injected dispatch fault at site {site!r} "
            f"(occurrence {occurrence}; simulated transient "
            f"transport error)")
        self.site = site
        self.occurrence = occurrence


_KINDS = ("error", "hang", "nonfinite", "kill", "torn")


@dataclass
class FaultSpec:
    """One scheduled fault (see module docstring for field semantics)."""

    site: str
    kind: str
    at: int | None = None
    count: int = 1
    where: str | None = None
    hang_s: float = 3600.0
    frac: float = 0.5
    fired: int = 0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (one of {_KINDS})")

    def matches(self, occurrence: int, ctx: dict) -> bool:
        if self.at is not None and not (
                self.at <= occurrence < self.at + self.count):
            return False
        if self.where is not None:
            return any(self.where in v for v in ctx.values()
                       if isinstance(v, str))
        return True


@dataclass
class FaultPlan:
    """A parsed fault schedule plus per-site occurrence counters."""

    faults: list[FaultSpec] = field(default_factory=list)
    _counts: dict = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    @classmethod
    def from_json(cls, obj) -> "FaultPlan":
        if isinstance(obj, str):
            obj = json.loads(obj)
        if isinstance(obj, dict):
            entries = obj.get("faults", [])
        else:
            entries = obj          # bare list of fault dicts
        faults = []
        for e in entries:
            e = dict(e)
            at = e.pop("at", None)
            spec = FaultSpec(
                site=str(e.pop("site")), kind=str(e.pop("kind")),
                at=(int(at) if at is not None else None),
                count=int(e.pop("count", 1)),
                where=e.pop("where", None),
                hang_s=float(e.pop("hang_s", 3600.0)),
                frac=float(e.pop("frac", 0.5)))
            if e:
                raise ValueError(f"unknown fault-plan keys: {sorted(e)}")
            faults.append(spec)
        return cls(faults=faults)

    def occurrences(self, site: str) -> int:
        """How many times ``site`` has fired so far in this process."""
        return self._counts.get(site, 0)

    def check(self, site: str, ctx: dict) -> "FaultSpec | None":
        """Count one occurrence of ``site`` and return the matching
        spec, if any (the action itself is taken by :func:`fire`)."""
        with self._lock:
            n = self._counts.get(site, 0) + 1
            self._counts[site] = n
        for spec in self.faults:
            if spec.site == site and spec.matches(n, ctx):
                spec.fired += 1
                return spec
        return None


# False = env not yet consulted; None = consulted, no plan (inert).
_PLAN: "FaultPlan | None | bool" = False


def plan() -> "FaultPlan | None":
    """The process-wide fault plan (lazily parsed from
    ``EWT_FAULT_PLAN``), or None when fault injection is inert."""
    global _PLAN
    if _PLAN is False:
        raw = os.environ.get("EWT_FAULT_PLAN")
        _PLAN = FaultPlan.from_json(raw) if raw else None
    return _PLAN


def install_plan(p) -> "FaultPlan | None":
    """Install a programmatic plan (a :class:`FaultPlan`, a plan dict/
    list/JSON string, or None to disarm). Resets all site counters —
    tests use this to rearm between cases."""
    global _PLAN
    _PLAN = p if (p is None or isinstance(p, FaultPlan)) \
        else FaultPlan.from_json(p)
    return _PLAN


def kill_now(spec=None):
    """The ``kill`` action: SIGKILL this process — no atexit handlers,
    no flush, no goodbye. The crash artifacts (torn writes, missing
    run_end, stale checkpoints) are the point."""
    os.kill(os.getpid(), signal.SIGKILL)


def torn_bytes(spec: FaultSpec, data):
    """Truncate a write payload per ``spec.frac`` (at least one byte
    shorter than the original, at least zero). Accepts str or bytes
    and returns the same type."""
    n = min(int(len(data) * spec.frac), max(len(data) - 1, 0))
    return data[:n]


def _announce(spec: FaultSpec, site: str, occurrence: int, ctx: dict):
    """Telemetry/forensics for one triggered fault. ``kill`` skips the
    event-stream write (its artifact is the crash itself); everything
    else lands as a ``fault`` event so a chaos campaign and
    ``tools/report.py`` can account for every injection."""
    from ..utils import telemetry
    from ..utils.flightrec import flight_recorder
    from ..utils.logging import get_logger

    telemetry.registry().counter("fault_injected", site=site).inc()
    flight_recorder().record("fault_injected", site=site,
                             kind=spec.kind, occurrence=occurrence)
    get_logger("ewt.faults").warning(
        "fault plan: injecting %r at site %r (occurrence %d)",
        spec.kind, site, occurrence)
    if spec.kind != "kill":
        rec = telemetry.active_recorder()
        if rec is not None:
            rec.event("fault", site=site, kind=spec.kind,
                      occurrence=occurrence,
                      **{k: v for k, v in ctx.items()
                         if isinstance(v, (str, int, float, bool))})
            # forensic record: must survive a kill that lands before
            # the next interval flush (a later fault in the same plan
            # often IS that kill). No-op at the events.flush site
            # itself (the recorder's re-entrancy guard).
            rec.flush()


def fire(site: str, write: bool = False, **ctx) -> "FaultSpec | None":
    """The injection point. Inert (one ``is None`` check) without a
    plan. With a plan: count this occurrence of ``site``; if a spec
    matches, announce it and act —

    - ``error``: raise :class:`InjectedFault`;
    - ``hang``: sleep ``hang_s`` here, then return None (the watchdog
      is expected to have given up long before the sleep ends);
    - ``kill``: SIGKILL immediately — unless ``write=True``, in which
      case the spec is returned and the caller performs the
      partial-write-then-kill sequence (:func:`torn_bytes` +
      :func:`kill_now`);
    - ``nonfinite`` / ``torn``: return the spec for the caller to act
      on (poison an eval / truncate a payload).
    """
    p = _PLAN if _PLAN is not False else plan()
    if p is None:
        return None
    spec = p.check(site, ctx)
    if spec is None:
        return None
    _announce(spec, site, p.occurrences(site), ctx)
    if spec.kind == "error":
        raise InjectedFault(site, p.occurrences(site))
    if spec.kind == "hang":
        time.sleep(spec.hang_s)
        return None
    if spec.kind == "kill" and not write:
        kill_now(spec)
    return spec
