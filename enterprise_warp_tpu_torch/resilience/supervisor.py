"""Supervised dispatch: watchdog, bounded retry, platform demotion and
graceful preemption.

Counterpart of ``enterprise_warp_tpu/resilience/supervisor.py``. Every
sampler routes its device block through a :class:`BlockSupervisor`:

- **watchdog** — the block runs on a daemon worker thread (on the
  caller's CUDA device and stream) and the caller waits
  ``EWT_WATCHDOG_S`` wall seconds for it; a block that never returns
  becomes a typed :class:`DispatchHang`. Off by default
  (``EWT_WATCHDOG_S=0``): then, and with no fault plan armed,
  :meth:`BlockSupervisor.call` is a direct call, with no thread and no
  added synchronisation.
- **bounded retry** — transient errors (injected faults and the
  transport-style markers of the reference) are retried
  ``EWT_DISPATCH_RETRIES`` times with exponential backoff and
  deterministic jitter, counted as ``dispatch_retry{site=}``. A retry is
  bit for bit: the site fires before the block draws anything, and a
  supervised call restores the sampler's ``torch.Generator`` to its state
  before the first attempt. CUDA errors that leave the context unusable
  (a failed kernel launch, an illegal memory access, a device-side
  assert) are never retried and never demoted: they propagate as raised.
- **circuit breaker** — a hang, an exhausted retry budget, or
  ``EWT_DISPATCH_STRIKES`` blocks that each needed retries: the
  supervisor flushes the sampler's pending checkpoint (``on_checkpoint``),
  re-probes the card in a child process (``utils.deviceprobe``), dumps a
  flight-recorder anomaly, records ``demotion{from=,to=}`` and raises
  :class:`PlatformDemotion`.

The port's ladder is ``mega`` (the megakernel routes on) -> ``classic``
(``EWT_PALLAS_MEGA=0``: the classic chain, its preconditioner still the
hand-written kernel 3, the chain the health plane pins; applied in
process by the samplers' run loops) -> restart. The reference's
``classic`` rung sets ``EWT_PALLAS=0``, which also turns its fused
preconditioner kernel off; the port never demotes a card run to a plain
version, so it keeps that kernel. The reference's bottom rung re-executes
the CLI on the CPU; the port does not move a card run to the host, so its
CLI prints the demotion and exits :data:`EXIT_DEMOTED` with the
checkpoint on disk (the reference's ``EWT_DEMOTION_EXEC=0`` branch), and
a restart resumes on the kernels.

This module also owns graceful preemption: the CLI installs
:func:`install_graceful_sigterm`, the samplers poll
:func:`preemption_requested` at block boundaries, finish the block,
checkpoint, and the run scope closes with ``run_end(reason="preempted")``.
"""

from __future__ import annotations

import os
import threading
import time
import zlib

from . import faults

__all__ = ["DispatchHang", "PlatformDemotion", "BlockSupervisor",
           "current_level", "next_level", "pin_classic", "apply_demotion",
           "request_preemption", "preemption_requested",
           "install_graceful_sigterm", "EXIT_DEMOTED"]

#: exit status when a demotion cannot be applied in process (EX_TEMPFAIL:
#: an external supervisor restarts and resumes)
EXIT_DEMOTED = 75


class DispatchHang(RuntimeError):
    """A supervised device call exceeded the watchdog wall clock."""

    def __init__(self, site: str, waited_s: float):
        super().__init__(
            f"dispatch at site {site!r} exceeded the {waited_s:.1f}s "
            f"watchdog (device call hung)")
        self.site = site
        self.waited_s = waited_s


class PlatformDemotion(RuntimeError):
    """The circuit breaker's verdict: re-enter the run one rung down.
    ``to_level`` is None at the bottom (restart and resume)."""

    def __init__(self, from_level: str, to_level, site: str, cause=None,
                 device_ok=None):
        target = to_level or "restart"
        super().__init__(
            f"demoting run at site {site!r}: {from_level} -> {target}"
            + (f" (cause: {cause!r})" if cause is not None else ""))
        self.from_level = from_level
        self.to_level = to_level
        self.site = site
        self.cause = cause
        self.device_ok = device_ok


_LADDER = ("mega", "classic")


def current_level() -> str:
    """``mega`` while the megakernel routes are on, else ``classic``."""
    from ..ops.routes import _mega_enabled
    return "mega" if _mega_enabled() else "classic"


def next_level(level: str):
    """One rung down, or None at the bottom."""
    i = _LADDER.index(level)
    return _LADDER[i + 1] if i + 1 < len(_LADDER) else None


def pin_classic():
    """The ``classic`` level: ``EWT_PALLAS_MEGA=0``, so every evaluation
    takes the classic chain with the preconditioner kernel (the health
    plane's pin). No kernel is switched to its plain version."""
    os.environ["EWT_PALLAS_MEGA"] = "0"


def apply_demotion(demotion: PlatformDemotion) -> bool:
    """Apply an in-process demotion: ``mega -> classic`` pins the classic
    chain (:func:`pin_classic`). Returns False at the bottom: the caller
    must restart."""
    if demotion.to_level == "classic":
        pin_classic()
        from ..utils.logging import get_logger
        get_logger("ewt.supervisor").warning(
            "demotion applied in process: EWT_PALLAS_MEGA=0, the classic "
            "chain and its preconditioner kernel run from here on")
        return True
    return False


# ------------------------------------------------------------------ #
#  graceful preemption (SIGTERM)                                      #
# ------------------------------------------------------------------ #

_PREEMPT = threading.Event()


def request_preemption():
    """Ask the running samplers to stop at the next block boundary."""
    _PREEMPT.set()


def preemption_requested() -> bool:
    return _PREEMPT.is_set()


def clear_preemption():
    """Reset the flag (a process that runs several runs in turn)."""
    _PREEMPT.clear()


def install_graceful_sigterm():
    """SIGTERM sets the preemption flag and returns, so the block in
    flight finishes, the sampler checkpoints and the run scope emits
    ``run_end(reason="preempted")``. Main thread only; returns True when
    installed."""
    import signal

    def _on_term(signum, frame):
        request_preemption()
        from ..utils.flightrec import flight_recorder
        from ..utils.logging import get_logger
        flight_recorder().record("preempt_signal", signum=int(signum))
        get_logger("ewt.supervisor").warning(
            "SIGTERM: finishing the in-flight block, then checkpointing "
            "and shutting down cleanly")

    try:
        signal.signal(signal.SIGTERM, _on_term)
        return True
    except (ValueError, OSError):
        return False


# ------------------------------------------------------------------ #
#  the supervisor                                                     #
# ------------------------------------------------------------------ #

def _env_float(name, default):
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return float(default)


# transport-style markers (the reference's): these justify a retry,
# anything else propagates unchanged
_TRANSIENT_MARKERS = (
    "injected dispatch fault", "deadline exceeded", "unavailable",
    "connection reset", "connection refused", "socket closed",
    "transport", "rpc error", "aborted", "internal: failed to connect",
)

# CUDA errors that leave the context unusable: retrying them cannot
# succeed, and demoting to the plain version would hide a broken kernel
_STICKY_CUDA_MARKERS = (
    "cuda launch failed", "cudaerror", "cuda error",
    "illegal memory access", "device-side assert", "misaligned address",
    "illegal instruction", "unspecified launch failure",
)


def _is_sticky_cuda(exc: BaseException) -> bool:
    text = str(exc).lower()
    return any(m in text for m in _STICKY_CUDA_MARKERS)


def _is_transient(exc: BaseException) -> bool:
    if isinstance(exc, faults.InjectedFault):
        return True
    if _is_sticky_cuda(exc):
        return False
    text = f"{type(exc).__name__}: {exc}".lower()
    return any(m in text for m in _TRANSIENT_MARKERS)


def _cuda_context():
    """``(device, stream)`` of the calling thread when CUDA is in use,
    for the watchdog's worker to run on; None otherwise."""
    import torch
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    dev = torch.cuda.current_device()
    return dev, torch.cuda.current_stream(dev)


class BlockSupervisor:
    """Supervised execution of one sampler's device blocks.

    One instance per sampler, named by its injection ``site``
    (``pt.dispatch``, ``hmc.dispatch``, ``nested.iteration``).
    ``on_checkpoint`` is called by the breaker before it demotes, so the
    last committed state is on disk. With the watchdog off and no fault
    plan, :meth:`call` is ``return thunk()``."""

    def __init__(self, site: str, on_checkpoint=None, watchdog_s=None,
                 retries=None, strike_limit=None, backoff_s=None):
        self.site = site
        self.on_checkpoint = on_checkpoint
        self.watchdog_s = (_env_float("EWT_WATCHDOG_S", 0.0)
                           if watchdog_s is None else float(watchdog_s))
        self.retries = (int(_env_float("EWT_DISPATCH_RETRIES", 2))
                        if retries is None else int(retries))
        self.strike_limit = (int(_env_float("EWT_DISPATCH_STRIKES", 3))
                             if strike_limit is None else int(strike_limit))
        self.backoff_s = (_env_float("EWT_DISPATCH_BACKOFF_S", 0.05)
                          if backoff_s is None else float(backoff_s))
        self.strikes = 0
        self.calls = 0

    def supervised(self) -> bool:
        """Whether :meth:`call` takes the supervised path (watchdog armed
        or a fault plan active); False is the inline fast path."""
        return self.watchdog_s > 0 or faults.plan() is not None

    def call(self, thunk, retryable=True, site=None, gen=None, **ctx):
        """Run one supervised block (class docstring). ``gen``: the
        ``torch.Generator`` the block draws from; a supervised call
        restores it before every attempt, so a retried block draws what
        the first attempt would have. ``retryable=False`` sends transient
        errors and hangs straight to the breaker."""
        if not self.supervised():
            return thunk()
        site = site or self.site
        self.calls += 1
        if self.strikes >= self.strike_limit:
            # the breaker tripped on repeated flaky blocks: demote at this
            # clean boundary instead of dispatching again
            self._demote(None, site)
        gen_state = gen.get_state() if gen is not None else None

        def attempt(abandoned):
            faults.fire(site, **ctx)
            if abandoned.is_set():
                # the watchdog gave up on this attempt while it hung at
                # the site: never run the block behind the caller's back
                return None
            if gen is not None:
                gen.set_state(gen_state)
            return thunk()

        tries = self.retries if retryable else 0
        delay = self.backoff_s
        n_retry = 0
        while True:
            try:
                out = self._watched(attempt, site)
                if n_retry:
                    self.strikes += 1
                return out
            except DispatchHang as exc:
                self._record_hang(exc)
                self._demote(exc, site)
            except Exception as exc:   # noqa: BLE001 — classified below
                if _is_sticky_cuda(exc):
                    raise
                if not _is_transient(exc):
                    if n_retry:
                        self.strikes += 1
                        self._demote(exc, site)
                    raise
                n_retry += 1
                if n_retry > tries:
                    self.strikes += 1
                    self._demote(exc, site)
                self._record_retry(exc, n_retry, site)
                # deterministic jitter: a rerun of the same plan sleeps the
                # same schedule (hash() would vary per process)
                jitter = (zlib.crc32(f"{site}:{self.calls}:{n_retry}"
                                     .encode()) % 1000) / 1000.0
                time.sleep(delay * (1.0 + jitter))
                delay *= 2.0

    def _watched(self, fn, site):
        """Run ``fn`` under the watchdog (inline when it is off). The
        worker is a daemon thread on the caller's CUDA device and stream:
        a hung call cannot be cancelled, only abandoned."""
        abandoned = threading.Event()
        if self.watchdog_s <= 0:
            return fn(abandoned)
        box: dict = {}
        done = threading.Event()
        ctx = _cuda_context()

        def runner():
            try:
                if ctx is None:
                    box["value"] = fn(abandoned)
                else:
                    import torch
                    with torch.cuda.device(ctx[0]), torch.cuda.stream(ctx[1]):
                        box["value"] = fn(abandoned)
            except BaseException as exc:   # noqa: BLE001 — re-raised
                box["error"] = exc
            finally:
                done.set()

        t = threading.Thread(target=runner, daemon=True,
                             name=f"ewt-dispatch-{site}")
        t.start()
        if not done.wait(self.watchdog_s):
            abandoned.set()
            raise DispatchHang(site, self.watchdog_s)
        if "error" in box:
            raise box["error"]
        return box["value"]

    def _record_retry(self, exc, n_retry, site):
        from ..utils import telemetry
        from ..utils.flightrec import flight_recorder
        from ..utils.logging import get_logger
        telemetry.registry().counter("dispatch_retry", site=site).inc()
        flight_recorder().record("dispatch_retry", site=site,
                                 attempt=n_retry, error=repr(exc)[:160])
        rec = telemetry.active_recorder()
        if rec is not None:
            rec.event("retry", site=site, attempt=n_retry,
                      error=repr(exc)[:160])
            rec.flush()
        get_logger("ewt.supervisor").warning(
            "transient dispatch error at %s (retry %d/%d): %r",
            site, n_retry, self.retries, exc)

    def _record_hang(self, exc):
        from ..utils import telemetry
        from ..utils.flightrec import flight_recorder
        telemetry.registry().counter("dispatch_hang", site=exc.site).inc()
        flight_recorder().record("dispatch_hang", site=exc.site,
                                 waited_s=exc.waited_s)

    def _demote(self, cause, site=None):
        """Checkpoint, re-probe, record, raise. Never returns."""
        import torch

        from ..utils import telemetry
        from ..utils.flightrec import flight_recorder
        from ..utils.logging import get_logger
        site = site or self.site
        log = get_logger("ewt.supervisor")
        if self.on_checkpoint is not None:
            try:
                self.on_checkpoint()
            except Exception as exc:   # noqa: BLE001 — still demote
                log.warning("pre-demotion checkpoint flush failed: %r", exc)
        from_level = current_level()
        to_level = next_level(from_level)
        device_ok = None
        if torch.cuda.is_available():
            from ..utils.deviceprobe import probe_device
            device_ok = bool(probe_device(
                timeout=_env_float("EWT_DEMOTE_PROBE_S", 30.0),
                refresh=True))
        telemetry.registry().counter(
            "demotion", **{"from": from_level,
                           "to": to_level or "restart"}).inc()
        rec = telemetry.active_recorder()
        if rec is not None:
            rec.event("demotion", site=site,
                      **{"from": from_level, "to": to_level or "restart"},
                      strikes=self.strikes, device_ok=device_ok,
                      run_id=rec.run_id,
                      cause=(repr(cause)[:200] if cause is not None
                             else None))
            rec.flush()
        flight_recorder().anomaly(
            "dispatch_demotion",
            once_key=f"dispatch_demotion:{site}:{from_level}",
            site=site, from_level=from_level,
            to_level=to_level or "restart", strikes=self.strikes,
            device_ok=device_ok,
            cause=(repr(cause)[:300] if cause is not None else None))
        log.error("circuit breaker tripped at %s (%s; device_ok=%s): "
                  "demoting %s -> %s", site,
                  cause if cause is not None else f"{self.strikes} strikes",
                  device_ok, from_level, to_level or "restart")
        raise PlatformDemotion(from_level, to_level, site, cause=cause,
                               device_ok=device_ok)
