"""Admission control for the serving front door.

Counterpart of ``enterprise_warp_tpu/serve/admission.py`` (host numpy,
the same reason strings):

- **typed rejections** — :class:`Rejection` (a ``ValueError``) with a
  machine-readable ``reason`` (``unknown_model`` / ``bad_dtype`` /
  ``bad_shape`` / ``nonfinite`` / ``prior_support`` / ``queue_full`` /
  ``tenant_quota`` / ``model_quarantined``), raised AT SUBMIT so a
  malformed or over-quota job fails fast in the submitter's stack frame,
  never mid-drain inside an evaluation;
- **theta validation** — :func:`validate_thetas` coerces once
  (float64, 2-D), then checks finiteness and the model's prior box
  support (host numpy against the registered bounds — no device round
  trip at admission time);
- **weighted fair-share draining** — :func:`fair_share_order`
  interleaves a drain snapshot across tenants (FIFO within a tenant,
  weighted round-robin across them) so a greedy tenant's burst cannot
  starve everyone else. Reordering is SAFE under the fixed-serve-width
  contract: at one width a row's result is bit-independent of
  co-batched content (``packer.py``), so packing order changes latency,
  never answers;
- **paramfile surface** — :func:`parse_serve_config` parses the
  ``serve:`` paramfile line (``max_queue=64 tenant_quota=8
  default_deadline_ms=5000 weight.gold=4``) into ServeDriver kwargs.
"""

from __future__ import annotations

from collections import deque

import numpy as np

__all__ = ["Rejection", "UnknownModel", "validate_thetas",
           "prior_bounds", "fair_share_order", "parse_serve_config",
           "quarantine_reason"]

#: the machine-readable rejection vocabulary (``serve_rejected`` event
#: ``reason`` field + ``serve_rejected{reason=}`` counter labels)
REASONS = ("unknown_model", "bad_dtype", "bad_shape", "nonfinite",
           "prior_support", "queue_full", "tenant_quota",
           "model_quarantined")


def quarantine_reason(like):
    """Why a likelihood must not be served, or None when it is clean
    (the numerical-integrity plane, ``resilience/integrity.py``): a
    pulsar whose
    ingestion audit verdict is ``quarantine``, or a likelihood an
    escalation ladder explicitly marked (``like.quarantined = True``),
    is rejected at the serving door — a known-corrupt model must not
    answer tenant traffic."""
    if getattr(like, "quarantined", False):
        return "likelihood marked quarantined by the health ladder"
    dq = getattr(getattr(like, "psr", None), "dq_report", None)
    if dq is not None and getattr(dq, "verdict", None) == "quarantine":
        return (f"pulsar {getattr(like.psr, 'name', '?')!r} carries a "
                "quarantine-verdict ingestion audit")
    return None


class Rejection(ValueError):
    """A typed admission rejection: the request never entered the
    queue. ``reason`` is one of :data:`REASONS`; ``detail`` is the
    human sentence; ``rid`` is filled in by the driver before the
    rejection is recorded and re-raised."""

    def __init__(self, reason: str, detail: str, rid: str | None = None):
        if reason not in REASONS:
            raise ValueError(f"unknown rejection reason {reason!r}")
        super().__init__(detail)
        self.reason = reason
        self.detail = detail
        self.rid = rid


class UnknownModel(Rejection, KeyError):
    """Submit against an unregistered model. Subclasses ``KeyError``
    too: that is what the pre-admission driver raised, and callers
    keying on it must keep working."""

    def __init__(self, detail: str, rid: str | None = None):
        Rejection.__init__(self, "unknown_model", detail, rid)


def prior_bounds(like):
    """Host-side prior support box of a likelihood: ``(lo, hi)``
    float64 arrays, ±inf where a parameter's prior exposes no
    ``lo``/``hi`` (unbounded — the support check passes it through).
    None when the likelihood exposes no ``params`` (psr-less test
    doubles serve without a support check)."""
    params = getattr(like, "params", None)
    if not params:
        return None
    ndim = len(params)
    lo = np.full(ndim, -np.inf)
    hi = np.full(ndim, np.inf)
    for i, p in enumerate(params):
        pr = getattr(p, "prior", None)
        if pr is not None and hasattr(pr, "lo") and hasattr(pr, "hi"):
            lo[i] = float(pr.lo)
            hi[i] = float(pr.hi)
    return lo, hi


def validate_thetas(thetas, ndim: int, model: str, bounds=None):
    """Coerce and validate one job's thetas at admission. Returns the
    validated ``(n, ndim)`` float64 array or raises a typed
    :class:`Rejection` (reason ``bad_dtype`` / ``bad_shape`` /
    ``nonfinite`` / ``prior_support``)."""
    try:
        arr = np.asarray(thetas, dtype=np.float64)
    except (TypeError, ValueError) as exc:
        raise Rejection(
            "bad_dtype",
            f"job thetas are not coercible to float64: {exc}") from exc
    arr = np.atleast_2d(arr)
    if arr.ndim != 2:
        raise Rejection(
            "bad_shape",
            f"job thetas have rank {arr.ndim}, expected a (n, ndim) "
            "batch")
    if arr.shape[0] == 0:
        raise Rejection("bad_shape", "job carries zero theta rows")
    if arr.shape[1] != int(ndim):
        raise Rejection(
            "bad_shape",
            f"job thetas have {arr.shape[1]} dims, model {model!r} "
            f"expects {ndim}")
    finite = np.isfinite(arr)
    if not finite.all():
        n_bad = int((~finite).any(axis=1).sum())
        raise Rejection(
            "nonfinite",
            f"{n_bad} of {arr.shape[0]} theta row(s) contain "
            "non-finite values")
    if bounds is not None:
        lo, hi = bounds
        outside = (arr < lo) | (arr > hi)
        if outside.any():
            n_bad = int(outside.any(axis=1).sum())
            raise Rejection(
                "prior_support",
                f"{n_bad} of {arr.shape[0]} theta row(s) fall outside "
                f"the prior support of model {model!r}")
    return arr


def fair_share_order(requests, weights=None):
    """Weighted fair-share drain order: FIFO within a tenant, weighted
    round-robin across tenants (tenant order = first appearance in the
    snapshot, so the result is deterministic). Each cycle grants
    tenant ``t`` up to ``weights.get(t, 1)`` requests. A greedy
    tenant's burst drains one share per cycle instead of monopolizing
    the front of the queue."""
    if not requests:
        return []
    weights = weights or {}
    order: list = []
    by_tenant: dict = {}
    for r in requests:
        q = by_tenant.get(r.tenant)
        if q is None:
            q = by_tenant[r.tenant] = deque()
            order.append(r.tenant)
        q.append(r)
    out: list = []
    while len(out) < len(requests):
        for tenant in order:
            q = by_tenant[tenant]
            share = max(int(weights.get(tenant, 1)), 1)
            for _ in range(share):
                if not q:
                    break
                out.append(q.popleft())
    return out


def parse_serve_config(value):
    """Parse the paramfile ``serve:`` line into ServeDriver kwargs.

    Flat-paramfile-friendly ``key=value`` tokens (the line is
    whitespace-split by the parser, so the tokens may arrive as a
    list)::

        serve: max_queue=64 tenant_quota=8 default_deadline_ms=5000 \
               weight.gold=4 weight.bronze=1 \
               slo_p95_ms=250 slo_success=0.99 slo_p95_ms.gold=100 \
               slo_window=256

    ``weight.<tenant>=<w>`` tokens collect into ``tenant_weights``.
    The SLO surface: ``slo_p95_ms=`` /
    ``slo_success=`` declare the default per-tenant objectives, a
    ``.<tenant>`` suffix overrides them for one tenant, and
    ``slo_window=`` sizes the outcome ring — all collected into the
    driver's ``slo`` kwarg (``serve/slo.py:SLOEngine``). Returns
    ``{}`` for None/empty."""
    if value is None:
        return {}
    tokens = (list(value) if isinstance(value, (list, tuple))
              else str(value).split())
    out: dict = {}
    for tok in tokens:
        tok = str(tok).strip().rstrip(",")
        if not tok:
            continue
        if "=" not in tok:
            raise ValueError(
                f"serve config token {tok!r} is not key=value")
        key, val = tok.split("=", 1)
        base, _, tenant = key.partition(".")
        if key.startswith("weight."):
            out.setdefault("tenant_weights", {})[
                key[len("weight."):]] = float(val)
        elif key in ("max_queue", "tenant_quota"):
            out[key] = int(val)
        elif key == "default_deadline_ms":
            out[key] = float(val)
        elif key == "slo_window":
            out.setdefault("slo", {})["window"] = int(val)
        elif base in ("slo_p95_ms", "slo_success"):
            objective = base[len("slo_"):]
            out.setdefault("slo", {}).setdefault(
                "objectives", {}).setdefault(
                tenant or "default", {})[objective] = float(val)
        else:
            raise ValueError(
                f"unknown serve config key {key!r} (one of max_queue, "
                "tenant_quota, default_deadline_ms, weight.<tenant>, "
                "slo_p95_ms[.<tenant>], slo_success[.<tenant>], "
                "slo_window)")
    return out
