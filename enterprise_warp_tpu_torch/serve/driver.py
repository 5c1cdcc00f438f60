"""ServeDriver: the multi-tenant request queue + batched dispatch loop.

Counterpart of ``enterprise_warp_tpu/serve/driver.py``. One driver owns
a set of registered models (likelihoods), a FIFO request queue, the AOT
executable cache, and the per-tenant result streams:

- ``submit(tenant, model, thetas)`` enqueues one job (a small theta
  batch to evaluate) and returns its request id. Admission is guarded
  (``admission.py``): thetas are coerced + validated ONCE (shape,
  dtype, finiteness, prior support), the queue is bounded
  (``max_queue`` / ``EWT_SERVE_MAX_QUEUE``), and per-tenant in-flight
  quotas (``tenant_quota``) apply backpressure — a failed admission
  raises a typed :class:`~.admission.Rejection`, recorded as a
  ``serve_rejected`` event, never a mid-drain traceback;
- requests may carry a ``deadline_ms``; expired jobs are shed at pack
  time (``serve_expired`` event) before ever costing a dispatch;
- ``step()`` drains the queue once: sheds expired requests, orders
  the snapshot by weighted tenant fair-share (safe to reorder — at a
  fixed serve width a row's result is bit-independent of co-batched
  content), groups pending requests by model, packs their rows into
  batches padded to the model's serve width (``packer.py`` — ONE
  sticky bucket per model, so a packed job's answer is bit-equal to
  serving it alone), and dispatches each batch through the AOT
  executable, whose upload is a real copy of the batch's host rows
  (``aot.py``). The harvest of batch ``k`` (result pull, per-request
  assembly, tenant events, latency accounting) runs double-buffered
  behind batch ``k+1``'s dispatch (``samplers/devicestate.py:
  HostPipeline``);
- ``run()`` steps until the queue is idle (checking graceful
  preemption at batch boundaries, like the samplers do).

Supervision is **per batch, not per process**: every dispatch goes
through a ``resilience.supervisor.BlockSupervisor`` (site
``serve.dispatch``) — watchdog, bounded retry for transient errors,
circuit breaker. The port's ladder (``resilience/supervisor.py``): a
``PlatformDemotion`` to ``classic`` is applied in place
(``EWT_PALLAS_MEGA=0`` — the classic chain, its preconditioner still
the hand-written kernel — then an executable cache flush, since the
fingerprint carries the pin, and one re-dispatch of the same host
rows); the bottom rung (``to_level`` None) propagates to the process
layer with every unfinished request requeued AND checkpointed
(``state.npz`` integrity generations, ``io/writers.py``), so the CLI
exits 75 and a restart resumes the queue with ``restore()`` on the
kernels. Nothing is re-executed on the CPU.

**Poison quarantine**: every harvested batch is ``isfinite``-checked
per row. Nonfinite rows attribute back to their requests through the
pack segments; when the whole batch is contaminated (attribution
ambiguous), the driver bisect-redispatches halves at the SAME bucket
until the poison rows are isolated. The poisoned request alone is
quarantined (typed ``serve_quarantined`` event + flight-recorder
forensics + ``serve_quarantined{tenant=}`` counter); its co-tenants
finish with results bit-equal to a clean run — zero co-tenant
casualties. A whole-batch dispatch *exception* (after the supervisor's
retries) takes the same bisection path instead of failing every
passenger.

Results: ``driver.results[rid]`` (host f64 lnl per job row), a typed
``serve_result`` event on the tenant's ``events.jsonl`` (latency,
batch provenance), and ``serve_latency_ms`` histograms in the metrics
registry. Driver heartbeats carry ``queue_depth`` /
``queue_depth_max`` / ``queue_age_ms`` / ``shed_per_s`` /
``batch_fill`` / ``requests_done``.

**Request tracing + SLO plane**: ``submit()`` mints a ``trace_id``
threaded through every stage — admission verdict, queue wait,
fair-share/pack, supervised dispatch (including demotion retries and
bisect re-dispatches), harvest, result — as ``serve_*`` typed events
plus ``serve.order``/``serve.pack``/``serve.dispatch``/
``serve.harvest`` spans, so a request's whole lifecycle is
reconstructable from ``events.jsonl`` alone, across the queue
checkpoint. ``serve_result`` carries the full latency decomposition
(``queue_ms + pack_ms + dispatch_ms + harvest_ms + other_ms ==
latency_ms``). Tracing is host-side wall arithmetic only — zero
added launches or syncs on the hot path, fully inert under
``EWT_TELEMETRY=0``, results bit-equal either way. Declared
per-tenant objectives (paramfile ``serve:`` ``slo_*`` keys) feed the
windowed ``serve/slo.py:SLOEngine`` — burn-rate/budget gauges +
edge-triggered ``slo_breach`` events.
"""

from __future__ import annotations

import contextlib
import os
import uuid
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..io.writers import (checkpoint_replace, remove_checkpoint,
                          resolve_checkpoint)
from ..resilience import faults
from ..resilience.supervisor import (BlockSupervisor, PlatformDemotion,
                                     apply_demotion,
                                     preemption_requested)
from ..samplers.devicestate import HostPipeline, host_pull
from ..utils import profiling, telemetry
from ..utils.logging import EvalRateMeter, get_logger
from .admission import (Rejection, UnknownModel, fair_share_order,
                        prior_bounds, quarantine_reason,
                        validate_thetas)
from .aot import AOTExecutableCache
from .packer import pack_requests, split_batch
from .slo import SLOEngine

__all__ = ["Request", "ServeDriver"]

log = get_logger("ewt.serve")

#: result payloads up to this many rows are inlined into the tenant's
#: ``serve_result`` event; larger jobs get summary stats only (the
#: caller still has the full array via ``driver.results``)
_INLINE_LNL_ROWS = 32

#: ``serve_stage`` events inline at most this many request/trace ids
#: (``n_requests`` always carries the true count) — a capacity-bucket
#: batch must not turn every stage event into a kilobyte of ids
_INLINE_STAGE_IDS = 32


@dataclass
class Request:
    """One queued job: evaluate ``thetas`` (n, ndim) against
    ``model`` for ``tenant``. ``deadline`` is an absolute
    ``profiling.monotonic()`` instant (None = no deadline);
    ``deadline_ms`` keeps the requested relative budget for latency
    reporting.

    Trace context:
    ``trace_id`` is minted at submit and survives the queue
    checkpoint; the ``*_ms`` stage accumulators attribute the
    request's host wall to queue wait / pack / dispatch / harvest
    (plain float adds — never a device sync), summing to at most
    ``latency_ms`` with the remainder reported as ``other_ms`` in
    ``serve_result``. ``t_enqueue`` is the instant the request last
    entered the queue (submit, demotion requeue, or restore) — the
    queue-wait accrual point; ``requeues`` counts demotion requeues
    across sessions."""

    rid: str
    tenant: str
    model: str
    thetas: np.ndarray
    t_submit: float
    meta: dict = field(default_factory=dict)
    deadline: float | None = None
    deadline_ms: float | None = None
    trace_id: str = ""
    t_enqueue: float = 0.0
    t_mark: float = 0.0
    requeues: int = 0
    queue_ms: float = 0.0
    pack_ms: float = 0.0
    dispatch_ms: float = 0.0
    harvest_ms: float = 0.0

    @property
    def n(self) -> int:
        return int(self.thetas.shape[0])

    def accrue(self, st: dict, attr: str,
               gap_attr: str = "queue_ms"):
        """Fold one stage window (a ``profiling.stage`` box with
        ``t0``/``t1``/``dur_ms``) into the decomposition: the window
        wall goes to ``attr``, and the un-attributed gap between this
        request's previous stage boundary (``t_mark``) and the
        window's start goes to ``gap_attr`` — queue wait by default
        (head-of-line blocking behind other batches' dispatches is
        queueing from the request's point of view); the harvest
        accrual routes its gap to ``harvest_ms`` instead (that gap IS
        the device computing + the pipeline's deferred window). The
        gap-filling keeps ``other_ms`` a rounding residual rather
        than a bucket of unexplained wall."""
        gap_ms = (st["t0"] - self.t_mark) * 1e3
        if gap_ms > 0.0:
            setattr(self, gap_attr, getattr(self, gap_attr) + gap_ms)
        setattr(self, attr, getattr(self, attr) + st["dur_ms"])
        self.t_mark = max(st["t1"], self.t_mark)

    def stage_fields(self, latency_ms: float | None = None) -> dict:
        """The latency-decomposition event fields. With
        ``latency_ms``, the explicit residual ``other_ms`` =
        latency - (queue+pack+dispatch+harvest) is included — with
        gap-filling accrual it is bounded by the driver bookkeeping
        between the last stage boundary and the terminal event, so
        the five fields reconcile against ``latency_ms`` to rounding
        slack."""
        out = {"queue_ms": round(self.queue_ms, 3),
               "pack_ms": round(self.pack_ms, 3),
               "dispatch_ms": round(self.dispatch_ms, 3),
               "harvest_ms": round(self.harvest_ms, 3)}
        if latency_ms is not None:
            staged = (self.queue_ms + self.pack_ms
                      + self.dispatch_ms + self.harvest_ms)
            out["other_ms"] = round(max(latency_ms - staged, 0.0), 3)
        if self.requeues:
            out["requeues"] = self.requeues
        return out


class ServeDriver:
    """See module docstring. ``root`` is the serve run directory
    (driver events.jsonl + ``tenants/<tenant>/`` streams)."""

    def __init__(self, root, buckets=None, max_queue=None, tenant_quota=None,
                 tenant_weights=None, default_deadline_ms=None,
                 slo=None, **start_fields):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.cache = AOTExecutableCache(buckets)
        self.models: dict = {}
        self.widths: dict = {}
        self._bounds: dict = {}     # model -> (lo, hi) prior box
        self._outdim: dict = {}     # model -> per-row result width
        self.queue: deque = deque()
        self.results: dict = {}
        self.rejected: dict = {}    # rid -> admission reason
        self.expired: dict = {}     # rid -> waited_ms at shed time
        self.quarantined: dict = {} # rid -> quarantine reason
        # quarantines whose reason is a dispatch failure rather than a
        # nonfinite result: the INFRA failure class. The CLI exit code
        # treats these like drops (a poison theta exiting 0 is the
        # contract; a broken executable exiting 0 would be a lie).
        self.dispatch_error_quarantines = 0
        # True once this session wrote or consumed the queue
        # checkpoint — gates its removal after a full drain
        self._ckpt_touched = False
        # set by _requeue_unfinished so run()'s demotion handler does
        # not pay a second savez+fsync+rotation for identical content
        # on the exact exit path racing a process restart
        self._demotion_checkpointed = False
        self._pending: dict = {}    # rid -> [buf, n_filled, Request]
        self._inflight: dict = {}   # tenant -> unfinished requests
        self._tenant_rec: dict = {}
        self._seq = 0
        # admission knobs (ctor > env > unbounded); 0 = unbounded
        self.max_queue = int(
            max_queue if max_queue is not None
            else os.environ.get("EWT_SERVE_MAX_QUEUE", 0) or 0)
        self.tenant_quota = int(
            tenant_quota if tenant_quota is not None
            else os.environ.get("EWT_SERVE_TENANT_QUOTA", 0) or 0)
        self.tenant_weights = dict(tenant_weights or {})
        self.default_deadline_ms = default_deadline_ms
        # per-tenant SLO engine (serve/slo.py) — None unless the
        # paramfile `serve:` line declared objectives
        self.slo = slo if isinstance(slo, SLOEngine) \
            else SLOEngine.from_config(slo)
        # heartbeat-interval aggregates (anti-aliasing satellites): a
        # poller sampling point-in-time queue_depth at drain would
        # miss any burst between beats, so each beat also reports the
        # interval's depth high-water mark and the shed rate since
        # the previous beat
        self._hb_depth_max = 0
        self._hb_expired_last = 0
        self._hb_t_last = profiling.monotonic()
        self.n_dispatch = 0
        self.n_sequential_equiv = 0   # dispatches a one-per-request
        #                               loop would have issued
        self.bisect_dispatches = 0
        self.requests_submitted = 0   # every submit() call
        self.requests_seen = 0        # accepted (+ restored)
        self.requests_done = 0
        self.rejected_requests = 0
        self.expired_requests = 0
        self.quarantined_requests = 0
        self.restored_requests = 0
        self.dropped_requests = 0
        self.pad_rows = 0
        self.real_rows = 0
        self._fills: list = []
        self.request_log: list = []
        self.pipe = HostPipeline()
        self.sup = BlockSupervisor("serve.dispatch",
                                   on_checkpoint=self.pipe.flush)
        self.meter = EvalRateMeter()
        self._stack = contextlib.ExitStack()
        self.rec = self._stack.enter_context(
            telemetry.run_scope(root, sampler="serve", **start_fields))
        reg = telemetry.registry()
        self._g_depth = reg.gauge("serve_queue_depth")
        self._g_fill = reg.gauge("serve_batch_fill")
        self._c_req = reg.counter("serve_requests")
        self._c_disp = reg.counter("serve_dispatches")
        self._h_latency = reg.histogram("serve_latency_ms")
        if self.slo is not None:
            # declare the objectives on the stream so events.jsonl is
            # self-describing: tools/observatory.py recounts burn
            # rates from the stream alone without the paramfile
            self.rec.event("slo_config",
                           objectives=self.slo.objectives,
                           window=self.slo.window)

    # ------------------------- registry ---------------------------- #
    def register(self, name, like, width=None):
        """Register a likelihood under ``name``. ``width`` pins the model's
        serve width (its one dispatch bucket — default
        ``EWT_SERVE_WIDTH`` or the capacity bucket); it must be one
        of the cache's configured buckets so a pre-warmed replica
        actually starts warm."""
        width = int(width or os.environ.get("EWT_SERVE_WIDTH", 0)
                    or self.cache.capacity)
        if width not in self.cache.buckets:
            raise ValueError(
                f"serve width {width} is not a configured bucket "
                f"{self.cache.buckets} — a replica warmed at its buckets would "
                "meet it cold")
        # numerical-integrity gate: a quarantined model (ingestion
        # audit verdict, or an escalation-ladder mark) never enters
        # the registry — tenants must not be served known-corrupt
        # answers (typed, same vocabulary as submit-time rejections)
        why = quarantine_reason(like)
        if why is not None:
            raise Rejection("model_quarantined",
                            f"model {name!r} refused at register: "
                            f"{why}")
        self.models[name] = like
        self.widths[name] = width
        # prior support box, resolved once per model: admission-time
        # theta validation is host numpy against these bounds
        self._bounds[name] = prior_bounds(like)
        # vector-result lane: a model may return a row of values per
        # theta (flow surrogates: draw + log q) instead of a scalar
        self._outdim[name] = int(getattr(like, "serve_out_dim", 1) or 1)
        return self.cache.fingerprint(like)

    def warm(self, name=None, buckets=None):
        """Warm executables for one (or every) registered model — the
        fresh-replica warm start. Default: each model's own serve
        width; pass ``buckets`` to warm a wider set (e.g. every
        configured edge, so the replica can be re-pointed at any width
        without a cold start). Returns ``{model: {bucket:
        warm_wall_s}}``."""
        names = [name] if name is not None else list(self.models)
        return {n: self.cache.warm(self.models[n],
                                   buckets or [self.widths[n]])
                for n in names}

    # ------------------------- intake ------------------------------ #
    def submit(self, tenant, model, thetas, rid=None,
               deadline_ms=None, **meta):
        """Enqueue one job; returns its request id.

        Admission control: thetas are coerced and
        validated ONCE here (shape, dtype, finiteness, prior
        support), the queue bound and the tenant's in-flight quota
        are enforced, and any failure raises a typed
        :class:`~.admission.Rejection` after recording a
        ``serve_rejected`` event — a malformed job can never reach
        the packed dispatch path (docstring of :mod:`.admission`)."""
        self._seq += 1
        rid = rid or f"{tenant}-{self._seq:06d}"
        # trace context minted at the door — BEFORE admission, so
        # even a rejection verdict is a traced lifecycle stage. A
        # plain host string: minting is unconditional (cheap) so the
        # queue checkpoint carries it uniformly whatever the
        # telemetry state.
        trace_id = uuid.uuid4().hex[:16]
        # injection site serve.admit BEFORE the accounting bump: an
        # injected error must leave the shed-accounting identity
        # untouched (the request entered no bucket)
        faults.fire("serve.admit", rid=rid, tenant=str(tenant),
                    model=str(model))
        self.requests_submitted += 1
        try:
            like = self.models.get(model)
            if like is None:
                raise UnknownModel(
                    f"model {model!r} is not registered "
                    f"(have {sorted(self.models)})")
            # a model quarantined AFTER registration (health ladder
            # marking a live likelihood) is shed at the door too
            why = quarantine_reason(like)
            if why is not None:
                raise Rejection("model_quarantined",
                                f"model {model!r} is quarantined: "
                                f"{why}")
            thetas = validate_thetas(thetas, int(like.ndim), model,
                                     self._bounds.get(model))
            if self.max_queue and len(self.queue) >= self.max_queue:
                raise Rejection(
                    "queue_full",
                    f"queue is full ({len(self.queue)}/"
                    f"{self.max_queue}) — backpressure, retry later")
            if self.tenant_quota and self._inflight.get(
                    tenant, 0) >= self.tenant_quota:
                raise Rejection(
                    "tenant_quota",
                    f"tenant {tenant!r} already has "
                    f"{self._inflight[tenant]} request(s) in flight "
                    f"(quota {self.tenant_quota})")
        except Rejection as rej:
            rej.rid = rid
            self._reject(rid, tenant, model, rej, trace_id=trace_id)
            raise
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        t_submit = profiling.monotonic()
        req = Request(rid=rid, tenant=tenant, model=model,
                      thetas=thetas, t_submit=t_submit, meta=meta,
                      deadline=(None if deadline_ms is None
                                else t_submit + float(deadline_ms)
                                / 1e3),
                      deadline_ms=(None if deadline_ms is None
                                   else float(deadline_ms)),
                      trace_id=trace_id, t_enqueue=t_submit,
                      t_mark=t_submit)
        self.queue.append(req)
        self._pending[rid] = [self._result_buf(model, req.n), 0, req]
        self._inflight[tenant] = self._inflight.get(tenant, 0) + 1
        self.requests_seen += 1
        self._c_req.inc()
        self._g_depth.set(len(self.queue))
        if len(self.queue) > self._hb_depth_max:
            self._hb_depth_max = len(self.queue)
        self._tenant(tenant).event("serve_request", request_id=rid,
                                   trace_id=trace_id,
                                   model=model, n_theta=req.n,
                                   deadline_ms=req.deadline_ms)
        return rid

    def _reject(self, rid, tenant, model, rej, trace_id=None):
        """Record one typed admission rejection (the request never
        entered the queue)."""
        self.rejected[rid] = rej.reason
        self.rejected_requests += 1
        telemetry.registry().counter("serve_rejected",
                                     reason=rej.reason).inc()
        log.warning("rejected %s (%s): %s", rid, rej.reason,
                    rej.detail)
        self._tenant(tenant).event(
            "serve_rejected", request_id=rid, trace_id=trace_id,
            model=str(model), reason=rej.reason, detail=rej.detail)

    def _dec_inflight(self, tenant):
        n = self._inflight.get(tenant, 0) - 1
        if n <= 0:
            self._inflight.pop(tenant, None)
        else:
            self._inflight[tenant] = n

    def _tenant(self, tenant):
        rec = self._tenant_rec.get(tenant)
        if rec is None:
            tdir = os.path.join(self.root, "tenants", tenant)
            rec = telemetry.RunRecorder(tdir)
            rec.run_start(sampler="serve", tenant=tenant)
            self._tenant_rec[tenant] = rec
        return rec

    # ------------------------- serving loop ------------------------ #
    def step(self):
        """One drain cycle over the current queue snapshot. Returns
        the number of batches dispatched."""
        if not self.queue:
            return 0
        now = profiling.monotonic()
        snapshot: list = []
        by_model: dict = {}
        while self.queue:
            req = self.queue.popleft()
            # deadline honored at pack time: an expired job is shed
            # BEFORE costing a dispatch slot
            if req.deadline is not None and now >= req.deadline:
                self._expire(req, now)
                continue
            snapshot.append(req)
        # weighted tenant fair-share drain order (admission.py): safe
        # to reorder — at a fixed serve width a row's result is
        # bit-independent of co-batched content
        with profiling.stage("serve.order") as st_order:
            snapshot = fair_share_order(snapshot, self.tenant_weights)
            for req in snapshot:
                by_model.setdefault(req.model, []).append(req)
        # the fair-share reorder wall is pack-stage time every
        # snapshot request sat through; the gap since each request's
        # last accounted instant (submit/requeue/restore) is its
        # queue wait
        for req in snapshot:
            req.accrue(st_order, "pack_ms")
        n_batches = 0
        fills = []
        try:
            for model, reqs in by_model.items():
                self.n_sequential_equiv += len(reqs)
                with profiling.stage("serve.pack",
                                     model=str(model)) as st_pack:
                    batches = pack_requests(reqs, self.widths[model])
                for req in reqs:
                    req.accrue(st_pack, "pack_ms")
                self._stage_event(
                    "pack", str(model), None, st_pack["dur_ms"],
                    [r.rid for r in reqs],
                    [r.trace_id for r in reqs],
                    n_batches=len(batches))
                for batch in batches:
                    out = self._dispatch(model, batch)
                    n_batches += 1
                    if out is None:
                        continue    # batch failed; requests recorded
                    self.n_dispatch += 1
                    self._c_disp.inc()
                    self.real_rows += batch.n_real
                    self.pad_rows += batch.bucket - batch.n_real
                    self.meter.add(batch.n_real)
                    fills.append(batch.fill)
                    # double buffer: harvesting batch k runs after
                    # batch k+1 has been dispatched (HostPipeline)
                    self.pipe.defer(
                        lambda b=batch, o=out: self._harvest(b, o))
        except PlatformDemotion:
            # bottom-rung demotion mid-cycle: the process must restart,
            # and the WHOLE drain cycle's unfinished
            # work — the failed batch, undispatched batches, other
            # models' popped requests — must survive the boundary
            self._requeue_unfinished(snapshot)
            raise
        self._fills.extend(fills)
        self._g_depth.set(len(self.queue))
        if fills:
            self._g_fill.set(sum(fills) / len(fills))
        self._beat(fills)
        return n_batches

    # ------------------------- stage attribution ------------------- #
    def _accrue(self, batch, attr):
        """Fold one batch-stage window (deferred — returns an
        applier taking the closed ``profiling.stage`` box) into every
        still-pending request with rows in ``batch``; returns the
        (rids, trace_ids) attributed. The gap since each request's
        last accounted instant goes to ``queue_ms`` (head-of-line
        wait behind earlier batches) — except for harvest windows,
        where the gap IS the device compute plus pipeline defer and
        belongs to ``harvest_ms``. Host float adds only — the
        zero-dispatch tracing contract."""
        gap_attr = "harvest_ms" if attr == "harvest_ms" else "queue_ms"
        rids, trace_ids, seen = [], [], set()
        for req, _, _, _ in batch.segments:
            if req.rid in seen or req.rid not in self._pending:
                continue
            seen.add(req.rid)
            rids.append(req.rid)
            trace_ids.append(req.trace_id)
        def apply(st):
            for req, _, _, _ in batch.segments:
                if req.rid in seen:
                    seen.discard(req.rid)
                    req.accrue(st, attr, gap_attr)
        return rids, trace_ids, apply

    def _stage_event(self, stage, model, bucket, dur_ms, rids,
                     trace_ids, **extra):
        """One typed ``serve_stage`` event on the driver stream: the
        per-batch (or per-pack) stage wall plus the requests it
        covers. Always emitted when telemetry is on (reconstruction
        must not depend on EWT_SPANS); id lists are capped at
        ``_INLINE_STAGE_IDS`` with ``n_requests`` carrying the true
        count."""
        self.rec.event(
            "serve_stage", stage=stage, model=model, bucket=bucket,
            dur_ms=(None if dur_ms is None else round(dur_ms, 3)),
            n_requests=len(rids),
            request_ids=rids[:_INLINE_STAGE_IDS],
            trace_ids=trace_ids[:_INLINE_STAGE_IDS], **extra)

    def _beat(self, fills=None):
        """One driver heartbeat with the interval aggregates: the
        depth high-water mark since the last beat (submit/requeue/
        restore peaks a drain-time sample aliases over), the oldest
        queued request's age, and the shed rate over the interval."""
        now = profiling.monotonic()
        dt = max(now - self._hb_t_last, 1e-9)
        sheds = self.expired_requests - self._hb_expired_last
        oldest = max(((now - r.t_enqueue) for r in self.queue),
                     default=None)
        fields = dict(
            phase="serve", step=self.requests_done,
            nsamp=self.requests_seen, queue_depth=len(self.queue),
            queue_depth_max=max(self._hb_depth_max, len(self.queue)),
            queue_age_ms=(None if oldest is None
                          else round(oldest * 1e3, 3)),
            shed_per_s=round(sheds / dt, 4),
            dispatches=self.n_dispatch,
            requests_done=self.requests_done,
            requests_rejected=self.rejected_requests,
            requests_expired=self.expired_requests,
            requests_quarantined=self.quarantined_requests,
            evals_per_s=round(self.meter.rate(), 1),
            evals_total=self.meter.total)
        if fills is not None:
            fields["batch_fill"] = (round(sum(fills) / len(fills), 4)
                                    if fills else None)
        self.rec.heartbeat(**fields)
        self._hb_t_last = now
        self._hb_expired_last = self.expired_requests
        self._hb_depth_max = len(self.queue)

    def _expire(self, req, now):
        """Shed one deadline-expired request at pack time."""
        waited_ms = (now - req.t_submit) * 1e3
        # close the open queue-wait window: everything since the last
        # accounted instant was spent waiting to be packed
        req.queue_ms += max(now - req.t_mark, 0.0) * 1e3
        req.t_mark = now
        self._pending.pop(req.rid, None)
        self._dec_inflight(req.tenant)
        self.expired[req.rid] = round(waited_ms, 3)
        self.expired_requests += 1
        telemetry.registry().counter("serve_expired",
                                     tenant=str(req.tenant)).inc()
        self._tenant(req.tenant).event(
            "serve_expired", request_id=req.rid,
            trace_id=req.trace_id, model=req.model,
            n_theta=req.n, deadline_ms=req.deadline_ms,
            waited_ms=round(waited_ms, 3), **req.stage_fields())
        self._slo_observe(req, waited_ms, ok=False)

    def run(self):
        """Step until the queue is idle (or a graceful preemption is
        requested), then flush the harvest pipeline. Returns a
        summary dict."""
        self._demotion_checkpointed = False
        try:
            while self.queue and not preemption_requested():
                self.step()
            self.pipe.flush()
        except PlatformDemotion:
            # a bottom-rung demotion can also surface from a bisect
            # re-dispatch inside a DEFERRED harvest (the final
            # flush), outside step()'s requeue handler — the
            # unfinished work must still be persisted before the
            # exception crosses the process boundary (step()'s
            # handler already checkpointed its own demotions)
            if not self._demotion_checkpointed:
                self.checkpoint()
            raise
        if self.queue or self._pending:
            # graceful preemption left unfinished work: persist it
            # (integrity generations) so a restarted replica resumes
            # the queue with restore()
            self.checkpoint()
        elif self._ckpt_touched:
            # remove only a checkpoint this session wrote or
            # consumed — a fresh session draining its own trace must
            # not wipe another session's unconsumed queue
            remove_checkpoint(self._ckpt_path)
        elif os.path.exists(self._ckpt_path):
            log.warning("unconsumed queue checkpoint at %s — was "
                        "this replica meant to run with --resume?",
                        self._ckpt_path)
        self._g_depth.set(len(self.queue))
        # the in-loop heartbeats fire before their cycle's harvest has
        # committed; one post-flush beat carries the settled figures
        self._beat()
        return self.summary()

    # ------------------------- dispatch ---------------------------- #
    def _dispatch(self, model, batch, bisect=False):
        """Dispatch one packed batch; returns the device result tensor
        or None after recording a failure. A ``classic`` demotion is
        applied in place (``EWT_PALLAS_MEGA=0``, cache flush + one
        re-dispatch of the same host rows); a bottom-rung demotion
        re-raises with the batch's requests requeued.

        Every attempt — including demotion retries and bisect
        re-dispatches — is a traced ``serve_stage`` dispatch event
        whose wall accrues to each live passenger's ``dispatch_ms``
        (the request waited through it whatever the outcome). The
        wall is the host-side submission window — including the AOT
        executable acquisition, so a cold replica's warm-up wall
        shows up as dispatch time, not unattributed residual; device
        completion lands in the harvest stage (the pipeline's
        ``host_pull``)."""
        like = self.models[model]
        for attempt in (0, 1):
            def thunk():
                # injection site serve.dispatch (resilience harness):
                # error = the supervisor's retry path, hang = the
                # watchdog/breaker/demotion path
                faults.fire("serve.dispatch", model=str(model),
                            bucket=batch.bucket)
                # the upload INSIDE the supervised thunk: a REAL device
                # copy of the host rows (aot.py). The supervisor's
                # transient-error retry re-invokes the whole thunk, so
                # every attempt uploads the same host rows afresh
                return exe(batch.rows)

            rids, trace_ids, accrue = self._accrue(batch,
                                                   "dispatch_ms")
            extra = {"attempt": attempt}
            if bisect:
                extra["bisect"] = True
            try:
                with profiling.stage("serve.dispatch",
                                     model=str(model),
                                     bucket=batch.bucket) as st:
                    # executable acquisition INSIDE the measured
                    # window: a cold warm-up is dispatch wall the
                    # passengers really waited through
                    exe = self.cache.executable(like, batch.bucket)
                    out = self.sup.call(thunk)
            except PlatformDemotion as d:
                accrue(st)
                self._stage_event("dispatch", str(model),
                                  batch.bucket, st["dur_ms"], rids,
                                  trace_ids,
                                  demotion=str(d.to_level), **extra)
                telemetry.registry().counter(
                    "serve_demotion", to=str(d.to_level)).inc()
                if attempt == 0 and apply_demotion(d):
                    # classic rung (EWT_PALLAS_MEGA=0): the fingerprint
                    # carries the pin, so every executable is stale;
                    # re-warm and retry THIS batch's host rows
                    log.warning("serve batch demoted to the classic "
                                "chain; re-warming executables")
                    self.cache.clear()
                    continue
                # bottom rung (or a second demotion): step() requeues
                # the whole drain cycle's unfinished requests before
                # the exception crosses the process boundary
                raise
            except Exception as exc:   # noqa: BLE001 — per-batch fail
                accrue(st)
                self._stage_event("dispatch", str(model),
                                  batch.bucket, st["dur_ms"], rids,
                                  trace_ids,
                                  error=type(exc).__name__, **extra)
                # a non-demotion batch failure is POISON-SUSPECT:
                # isolate the offending request by bisection instead
                # of failing every passenger
                return self._bisect_failed(model, batch, exc)
            accrue(st)
            self._stage_event("dispatch", str(model), batch.bucket,
                              st["dur_ms"], rids, trace_ids, **extra)
            return out
        return None

    def _requeue_unfinished(self, snapshot):
        """Put a demoted drain cycle's unfinished requests back at
        the FRONT of the queue, in their original order. The
        in-flight harvest is committed FIRST (its rows are valid and
        its completions remove requests from ``_pending``); whatever
        is still pending after that gets its fill counter reset — a
        requeued request is re-packed from row 0, so a stale partial
        fill would overshoot ``req.n`` and the request would never
        finish."""
        self.pipe.flush()
        unfinished = [r for r in snapshot if r.rid in self._pending]
        now = profiling.monotonic()
        for req in unfinished:
            self._pending[req.rid][1] = 0
            # a requeued request re-enters the queue-wait stage NOW;
            # the work it already sat through (pack/dispatch walls of
            # the demoted cycle) stays on its accumulators
            req.t_enqueue = now
            req.requeues += 1
            self.rec.event("serve_requeue", request_id=req.rid,
                           trace_id=req.trace_id,
                           tenant=str(req.tenant),
                           model=str(req.model),
                           requeues=req.requeues, reason="demotion")
        self.queue.extendleft(reversed(unfinished))
        self._g_depth.set(len(self.queue))
        if len(self.queue) > self._hb_depth_max:
            self._hb_depth_max = len(self.queue)
        # the process is about to exit for a restart: persist the
        # rebuilt queue (integrity generations) so the
        # restarted replica resumes it with restore()
        self.checkpoint()
        self._demotion_checkpointed = True

    def _bisect_failed(self, model, batch, exc):
        """A whole-batch dispatch failure (past the supervisor's
        retries): bisect-redispatch to isolate the poison request
        instead of failing every passenger. Always returns None (the
        batch's requests are handled here, not by the caller)."""
        telemetry.registry().counter("serve_batch_error").inc()
        log.warning("batch against %s failed: %r — isolating",
                    model, exc)
        self._bisect_or_quarantine(
            model, batch,
            f"dispatch_error: {type(exc).__name__}: {exc}")
        return None

    def _compact_live(self, batch):
        """Rebuild ``batch`` with ONLY still-pending requests' rows
        (same bucket, padding replicated as usual). A re-dispatched
        half must not carry an already-quarantined request's physical
        rows — the poison theta would re-contaminate and frame its
        innocent co-passengers. Returns None when nothing is live."""
        from .packer import PackedBatch
        rows = np.empty_like(batch.rows)
        sub = PackedBatch(model=batch.model, bucket=batch.bucket,
                          rows=rows, n_real=0)
        cursor = 0
        for req, req_start, batch_start, n in batch.segments:
            if req.rid not in self._pending:
                continue
            rows[cursor:cursor + n] = \
                batch.rows[batch_start:batch_start + n]
            sub.segments.append((req, req_start, cursor, n))
            cursor += n
        if cursor == 0:
            return None
        sub.n_real = cursor
        if cursor < batch.bucket:
            rows[cursor:] = rows[cursor - 1]
        return sub

    def _bisect_or_quarantine(self, model, batch, reason):
        """``batch`` is poison-suspect as a whole (dispatch exception,
        or fully non-finite harvest). Compact to the live requests,
        then: a single live request (or single row) fails ALONE —
        quarantined; otherwise bisect-redispatch the halves at the
        same bucket, recursing through the normal harvest path until
        the poison isolates."""
        sub = self._compact_live(batch)
        if sub is None:
            return
        live = {}
        for req, _, _, _ in sub.segments:
            live.setdefault(req.rid, req)
        if sub.n_real < batch.n_real:
            # stale rows rode along (requests quarantined or finished
            # through another batch) — possibly the poison itself. A
            # compacted re-dispatch judges the survivors on THEIR OWN
            # rows before anyone is condemned; if it is still
            # contaminated, the recursion re-enters here with nothing
            # left to compact away.
            out = self._dispatch(model, sub, bisect=True)
            if out is not None:
                self.n_dispatch += 1
                self.bisect_dispatches += 1
                self._harvest(sub, out)
            return
        if sub.n_real < 2 or len(live) < 2:
            for req in live.values():
                self._quarantine(req, reason, batch)
            return
        log.warning("bisecting a %d-request poison-suspect batch "
                    "against %s (%s)", len(live), model, reason)
        telemetry.registry().counter("serve_bisect",
                                     model=str(model)).inc()
        for half in split_batch(sub):
            out = self._dispatch(model, half, bisect=True)
            if out is not None:
                self.n_dispatch += 1
                self.bisect_dispatches += 1
                self._harvest(half, out)

    # ------------------------- harvest ----------------------------- #
    def _harvest(self, batch, out):
        """Pull + check + apply one batch. The harvest stage wall
        (the D2H pull — where an async dispatch's device completion
        actually lands — plus the isfinite gate) accrues to every
        live passenger BEFORE completions fire, so a request
        finishing from this very batch sees its own harvest time in
        its ``serve_result`` decomposition (row assembly is host
        bookkeeping after the accrual and lands in ``other_ms``)."""
        rids, trace_ids, accrue = self._accrue(batch, "harvest_ms")
        with profiling.stage("serve.harvest",
                             model=str(batch.model),
                             bucket=batch.bucket) as st:
            lnl = host_pull(out)
            # injection site serve.harvest: kind ``nonfinite``
            # poisons the harvested batch (whole-batch contamination
            # — the quarantine-bisection vector; a ``where`` filter
            # against the rid list scopes it to batches carrying a
            # chosen request)
            spec = faults.fire(
                "serve.harvest", model=str(batch.model),
                rids=",".join(sorted({req.rid for req, _, _, _
                                      in batch.segments})))
            if spec is not None and spec.kind == "nonfinite":
                lnl = np.array(lnl, copy=True)
                lnl[:batch.n_real] = np.nan
            finite = np.isfinite(np.asarray(lnl[:batch.n_real]))
            if finite.ndim > 1:
                # vector-result lane: a row is poisoned if ANY of its
                # components is non-finite — per-row verdicts keep the
                # isolation/bisection machinery model-shape-agnostic
                finite = finite.all(axis=tuple(range(1, finite.ndim)))
        accrue(st)
        self._stage_event("harvest", str(batch.model), batch.bucket,
                          st["dur_ms"], rids, trace_ids)
        if not finite.all():
            self._isolate(batch, lnl, finite)
            return
        self._apply_rows(batch, lnl, batch.segments)

    def _apply_rows(self, batch, lnl, segments):
        """Copy harvested rows into the owning requests' result
        buffers (skipping requests already failed/quarantined
        elsewhere), finishing any request whose buffer completes."""
        for req, req_start, batch_start, n in segments:
            slot = self._pending.get(req.rid)
            if slot is None:
                continue
            buf, filled, _ = slot
            buf[req_start:req_start + n] = \
                lnl[batch_start:batch_start + n]
            slot[1] = filled + n
            if slot[1] == req.n:
                self._finish(req, buf, batch)

    def _isolate(self, batch, lnl, finite):
        """Post-harvest poison attribution: map the
        nonfinite rows back to requests through the pack segments.

        - Partial contamination attributes directly: the poisoned
          request(s) are quarantined, everyone whose rows are finite
          finishes from THIS dispatch (bit-equal rows).
        - A fully-contaminated multi-request batch is ambiguous (a
          batch-level NaN bleed can shadow the true source):
          bisect-redispatch halves at the same bucket until the
          poison isolates. Clean halves return rows bit-equal to a
          clean run (fixed-width contract), so co-tenants see zero
          casualties."""
        live: list = []
        live_reqs: dict = {}
        bad_by_req: dict = {}
        for seg in batch.segments:
            req, _, batch_start, n = seg
            if req.rid not in self._pending:
                continue
            live.append(seg)
            live_reqs.setdefault(req.rid, req)
            seg_bad = bool((~finite[batch_start:batch_start + n])
                           .any())
            bad_by_req[req.rid] = bad_by_req.get(req.rid,
                                                 False) or seg_bad
        if not live:
            return
        if not finite.any():
            # fully contaminated: attribution is ambiguous (a batch-
            # level NaN bleed can shadow the true source) — compact
            # to the live requests and bisect-redispatch
            self._bisect_or_quarantine(batch.model, batch,
                                       "nonfinite_result")
            return
        for rid, req in live_reqs.items():
            if bad_by_req[rid]:
                self._quarantine(req, "nonfinite_result", batch)
        # the survivors finish from THIS dispatch (bit-equal rows);
        # _apply_rows skips the just-quarantined slots
        self._apply_rows(batch, lnl, live)

    def _quarantine(self, req, reason, batch=None):
        """Fail exactly ONE poisoned request: typed event, flight-
        recorder forensics, ``serve_quarantined{tenant=}`` counter.
        Co-tenants are untouched — the zero-casualty contract."""
        faults.fire("serve.quarantine", rid=req.rid,
                    tenant=str(req.tenant))
        slot = self._pending.pop(req.rid, None)
        if slot is None:
            return
        self._dec_inflight(req.tenant)
        self.quarantined[req.rid] = reason
        self.quarantined_requests += 1
        if reason.startswith("dispatch_error"):
            self.dispatch_error_quarantines += 1
        telemetry.registry().counter("serve_quarantined",
                                     tenant=str(req.tenant)).inc()
        log.error("quarantined request %s (%s): %s", req.rid,
                  req.tenant, reason)
        elapsed_ms = (profiling.monotonic() - req.t_submit) * 1e3
        from ..utils.flightrec import flight_recorder
        # forensics: the offending theta head, non-finite-safe (the
        # ring's dump encoder preserves NaN/Inf as strings)
        theta_head = [[float(v) if np.isfinite(v) else str(v)
                       for v in row] for row in req.thetas[:4]]
        flight_recorder().record(
            "serve_quarantined", rid=req.rid,
            trace_id=req.trace_id, tenant=req.tenant,
            model=str(req.model), reason=reason,
            theta_head=theta_head)
        self._tenant(req.tenant).event(
            "serve_quarantined", request_id=req.rid,
            trace_id=req.trace_id, model=str(req.model),
            n_theta=req.n, reason=reason,
            elapsed_ms=round(elapsed_ms, 3),
            bucket=(batch.bucket if batch is not None else None),
            **req.stage_fields())
        self._slo_observe(req, elapsed_ms, ok=False)

    def _slo_observe(self, req, elapsed_ms, ok):
        """Fold one terminal outcome into the SLO engine (no-op
        without declared objectives). Breach events land on the
        DRIVER stream — objectives are an operator contract, not a
        per-tenant payload."""
        if self.slo is not None:
            self.slo.observe(req.tenant, elapsed_ms, ok,
                             emit=self.rec.event)

    def _result_buf(self, model, n):
        """Result buffer for one request: ``(n,)`` scalars for
        likelihood models, ``(n, out_dim)`` rows for vector-result
        models (flow surrogates)."""
        out_dim = self._outdim.get(model, 1)
        if out_dim == 1:
            return np.empty(n, dtype=np.float64)
        return np.empty((n, out_dim), dtype=np.float64)

    def _finish(self, req, lnl, batch):
        del self._pending[req.rid]
        self._dec_inflight(req.tenant)
        self.results[req.rid] = lnl
        self.requests_done += 1
        latency_ms = (profiling.monotonic() - req.t_submit) * 1e3
        self._h_latency.observe(latency_ms)
        ev = dict(request_id=req.rid, trace_id=req.trace_id,
                  model=req.model, n_theta=req.n,
                  latency_ms=round(latency_ms, 3),
                  bucket=batch.bucket,
                  batch_fill=round(batch.fill, 4),
                  lnl_max=float(np.max(lnl)),
                  **req.stage_fields(latency_ms))
        deadline_ok = True
        if req.deadline_ms is not None:
            # deadline accounting: the requested budget and whether
            # the result beat it (a completion can still miss — the
            # shed only happens at pack time)
            deadline_ok = bool(latency_ms <= req.deadline_ms)
            ev["deadline_ms"] = req.deadline_ms
            ev["deadline_met"] = deadline_ok
        if req.n <= _INLINE_LNL_ROWS:
            ev["lnl"] = (np.asarray(lnl).tolist() if np.ndim(lnl) > 1
                         else [float(v) for v in lnl])
        self._tenant(req.tenant).event("serve_result", **ev)
        self.request_log.append(
            {"rid": req.rid, "tenant": req.tenant, "model": req.model,
             "n": req.n, "latency_ms": round(latency_ms, 3),
             "bucket": batch.bucket, "fill": round(batch.fill, 4),
             "trace_id": req.trace_id,
             **req.stage_fields(latency_ms)})
        self._slo_observe(req, latency_ms, ok=deadline_ok)

    # ------------------------- queue checkpoint -------------------- #
    @property
    def _ckpt_path(self):
        return os.path.join(self.root, "state.npz")

    def checkpoint(self):
        """Persist every unfinished request (queued + mid-drain) to
        ``<root>/state.npz`` with integrity generations
        (``io/writers.py:checkpoint_replace``): sha256 sidecar +
        last-good ``state.prev.npz`` rotation. Deadlines are stored
        as REMAINING budget so a restore re-arms them relative to the
        restore instant. Trace context is persisted too — the
        request's ``trace_id``, already-elapsed wall, per-stage
        accumulators, and requeue count — so a request's trace stays
        ONE connected story across a kill/resume (the restoring
        session back-dates ``t_submit`` by the elapsed wall;
        see :meth:`restore`). Model names must be strings (the CLI's
        registry contract)."""
        self._ckpt_touched = True
        reqs = [slot[2] for slot in self._pending.values()]
        if not reqs:
            remove_checkpoint(self._ckpt_path)
            return None
        now = profiling.monotonic()
        rem = np.array([np.nan if r.deadline is None
                        else max((r.deadline - now) * 1e3, 0.0)
                        for r in reqs])
        tmp = self._ckpt_path + ".tmp.npz"
        np.savez(
            tmp,
            flat=np.concatenate([r.thetas.ravel() for r in reqs]),
            shapes=np.array([[r.n, r.thetas.shape[1]] for r in reqs],
                            dtype=np.int64),
            rids=np.array([r.rid for r in reqs]),
            tenants=np.array([str(r.tenant) for r in reqs]),
            models=np.array([str(r.model) for r in reqs]),
            deadline_rem_ms=rem, seq=self._seq,
            trace_ids=np.array([r.trace_id for r in reqs]),
            elapsed_ms=np.array([(now - r.t_submit) * 1e3
                                 for r in reqs]),
            # fold each request's still-open queue-wait window (the
            # gap since its last accounted instant) into the
            # persisted queue_ms WITHOUT mutating the live request —
            # a checkpoint is an observation, not a stage boundary
            stage_ms=np.array(
                [[r.queue_ms + max(now - r.t_mark, 0.0) * 1e3,
                  r.pack_ms, r.dispatch_ms, r.harvest_ms]
                 for r in reqs]),
            requeues=np.array([r.requeues for r in reqs],
                              dtype=np.int64))
        checkpoint_replace(tmp, self._ckpt_path)
        self.rec.event("checkpoint", phase="serve_queue",
                       n=len(reqs))
        return self._ckpt_path

    def restore(self):
        """Restore unfinished requests from the queue checkpoint
        (digest-verified, last-good generation fallback). Call AFTER
        registering the models. Returns the number restored (0 when
        no restorable checkpoint exists). Restored requests keep
        their rids AND trace ids (no new ``serve_request`` events —
        they were announced by the session that accepted them); a
        request whose model is no longer registered is recorded as
        rejected. ``t_submit`` is back-dated by the checkpointed
        elapsed wall so the eventual ``latency_ms`` spans sessions
        (inter-process downtime is excluded — the monotonic clock
        does not cross processes); stage accumulators and the requeue
        count carry over so the final decomposition still reconciles.
        Pre-tracing checkpoints (no ``trace_ids`` key) restore with
        fresh trace ids and zeroed accumulators."""
        self._ckpt_touched = True
        path = resolve_checkpoint(self._ckpt_path,
                                  what="serve queue checkpoint")
        if path is None:
            return 0
        n = 0
        now = profiling.monotonic()
        with np.load(path) as z:
            self._seq = max(self._seq, int(z["seq"]))
            flat, shapes = z["flat"], z["shapes"]
            rem = z["deadline_rem_ms"]
            has_trace = "trace_ids" in z.files
            offset = 0
            for i, rid in enumerate(str(x) for x in z["rids"]):
                rows, ndim = int(shapes[i][0]), int(shapes[i][1])
                thetas = flat[offset:offset + rows * ndim] \
                    .reshape(rows, ndim).copy()
                offset += rows * ndim
                tenant = str(z["tenants"][i])
                model = str(z["models"][i])
                try:
                    like = self.models.get(model)
                    if like is None:
                        raise UnknownModel(
                            f"checkpointed request {rid} names model "
                            f"{model!r}, no longer registered", rid)
                    # re-validate against the CURRENT registration: a
                    # geometry change between sessions must surface as
                    # a typed restore-time rejection, not the
                    # mid-drain shape crash admission exists to stop
                    thetas = validate_thetas(
                        thetas, int(like.ndim), model,
                        self._bounds.get(model))
                except Rejection as rej:
                    rej.rid = rid
                    # counted on the submitted side too, so the
                    # accounting identity (accepted == submitted -
                    # rejected + restored) stays balanced for a
                    # rejection that never went through submit()
                    self.requests_submitted += 1
                    self._reject(rid, tenant, model, rej)
                    continue
                rem_ms = float(rem[i])
                req = Request(
                    rid=rid, tenant=tenant, model=model,
                    thetas=thetas, t_submit=now,
                    deadline=(None if np.isnan(rem_ms)
                              else now + max(rem_ms, 0.0) / 1e3),
                    deadline_ms=(None if np.isnan(rem_ms)
                                 else rem_ms))
                if has_trace:
                    req.trace_id = str(z["trace_ids"][i])
                    req.t_submit = \
                        now - max(float(z["elapsed_ms"][i]), 0.0) / 1e3
                    (req.queue_ms, req.pack_ms, req.dispatch_ms,
                     req.harvest_ms) = [float(v)
                                        for v in z["stage_ms"][i]]
                    req.requeues = int(z["requeues"][i])
                else:
                    req.trace_id = uuid.uuid4().hex[:16]
                req.t_enqueue = now
                # attribution restarts here: inter-process downtime
                # is excluded from every stage (monotonic clocks do
                # not cross processes)
                req.t_mark = now
                self.queue.append(req)
                self._pending[rid] = [self._result_buf(model, req.n),
                                      0, req]
                self._inflight[tenant] = \
                    self._inflight.get(tenant, 0) + 1
                n += 1
        self.requests_seen += n
        self.restored_requests += n
        self._g_depth.set(len(self.queue))
        self._hb_depth_max = max(self._hb_depth_max, len(self.queue))
        self.rec.event("checkpoint", phase="serve_restore", n=n)
        log.info("restored %d unfinished request(s) from %s", n,
                 path)
        return n

    # ------------------------- teardown ---------------------------- #
    def summary(self):
        lat = [r["latency_ms"] for r in self.request_log]
        lat_sorted = sorted(lat)

        def q(p):
            if not lat_sorted:
                return None
            return lat_sorted[min(int(p * len(lat_sorted)),
                                  len(lat_sorted) - 1)]

        unfinished = len(self._pending)
        accounting = {
            "submitted": self.requests_submitted,
            "restored": self.restored_requests,
            "accepted": self.requests_seen,
            "done": self.requests_done,
            "rejected": self.rejected_requests,
            "expired": self.expired_requests,
            "quarantined": self.quarantined_requests,
            "failed": self.dropped_requests,
            "unfinished": unfinished,
        }
        # shed accounting must balance: every request ends in exactly
        # one bucket (the sentinel's serve gate holds the chaos storm
        # to this invariant)
        accounting["balanced"] = bool(
            self.requests_seen == self.requests_done
            + self.expired_requests + self.quarantined_requests
            + self.dropped_requests + unfinished
            and self.requests_seen == self.requests_submitted
            - self.rejected_requests + self.restored_requests)
        return {
            "requests_seen": self.requests_seen,
            "requests_done": self.requests_done,
            "dropped_requests": self.dropped_requests,
            "rejected_requests": self.rejected_requests,
            "expired_requests": self.expired_requests,
            "quarantined_requests": self.quarantined_requests,
            "dispatch_error_quarantines":
                self.dispatch_error_quarantines,
            "restored_requests": self.restored_requests,
            "bisect_dispatches": self.bisect_dispatches,
            "accounting": accounting,
            "max_queue": self.max_queue or None,
            "tenant_quota": self.tenant_quota or None,
            "queue_depth": len(self.queue),
            "dispatches": self.n_dispatch,
            "sequential_dispatch_equiv": self.n_sequential_equiv,
            "dispatch_reduction": (
                round(self.n_sequential_equiv
                      / max(self.n_dispatch, 1), 2)
                if self.n_dispatch else None),
            "mean_batch_fill": (round(sum(self._fills)
                                      / len(self._fills), 4)
                                if self._fills else None),
            "real_rows": self.real_rows,
            "pad_rows": self.pad_rows,
            "latency_ms": {"p50": q(0.50), "p90": q(0.90),
                           "p99": q(0.99),
                           "max": lat_sorted[-1] if lat_sorted
                           else None},
            "decomposition": self._decomposition(),
            "slo": (self.slo.summary() if self.slo is not None
                    else None),
            "evals_per_s": round(self.meter.rate(), 1),
            "aot": self.cache.stats(),
        }

    def _decomposition(self):
        """Stage-latency decomposition over every completed request
        (from ``request_log``): per-stage mean/p50/p95 plus the worst
        reconciliation residual. ``other_ms`` is an EXPLICIT residual
        (clamped at 0), so ``unaccounted_ms_max`` measures only the
        rounding slack of the recorded fields — the sentinel ``slo``
        gate holds it near zero. None before the first completion."""
        if not self.request_log:
            return None
        stages = ("queue_ms", "pack_ms", "dispatch_ms", "harvest_ms",
                  "other_ms")

        def stats(vals):
            vs = sorted(vals)
            n = len(vs)
            return {"mean": round(sum(vs) / n, 3),
                    "p50": round(vs[min(n // 2, n - 1)], 3),
                    "p95": round(vs[min(int(0.95 * n), n - 1)], 3)}

        out = {s: stats([r.get(s, 0.0) for r in self.request_log])
               for s in stages}
        out["unaccounted_ms_max"] = round(
            max(abs(r["latency_ms"]
                    - sum(r.get(s, 0.0) for s in stages))
                for r in self.request_log), 3)
        out["n"] = len(self.request_log)
        return out

    def close(self):
        """Flush the pipeline, close every tenant stream, and leave
        the driver's run scope."""
        self.pipe.flush()
        final = self.summary()
        for rec in self._tenant_rec.values():
            rec.run_end(status="ok")
            rec.close()
        self._tenant_rec.clear()
        self.rec.event("serve_summary", **{
            k: final[k] for k in ("requests_seen", "requests_done",
                                  "dropped_requests",
                                  "rejected_requests",
                                  "expired_requests",
                                  "quarantined_requests",
                                  "dispatch_error_quarantines",
                                  "bisect_dispatches", "dispatches",
                                  "dispatch_reduction",
                                  "mean_batch_fill")})
        self._stack.close()
        return final

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
