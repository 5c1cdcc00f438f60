"""Device probe in a throwaway subprocess with a wall-clock timeout.

Counterpart of ``enterprise_warp_tpu/utils/deviceprobe.py``. Once a device
call has hung, the only safe way to ask whether the card is alive is to
run a small CUDA operation in a child interpreter and wait for it with a
deadline: a hang becomes a clean ``timeout``. The result carries a typed
``outcome`` (``ok`` / ``timeout`` / ``exit`` / ``oserror``) and a
``reason`` with the child's stderr tail; every probe counts
``device_probe{outcome=}`` in the registry and a failure is logged.
Results are memoized per (env, require_accelerator) unless ``refresh``.
"""

import subprocess
import sys

__all__ = ["probe_device", "ProbeResult"]

_PROBE_CODE = (
    "import torch;"
    "{check}"
    "d = 'cuda' if torch.cuda.is_available() else 'cpu';"
    "x = torch.ones((8, 8), device=d).sum();"
    "assert float(x) == 64.0;"
    "print('ok')"
)

_STDERR_TAIL = 240


class ProbeResult:
    """Truthy iff the probe passed; carries the failure provenance."""

    __slots__ = ("ok", "outcome", "reason")

    def __init__(self, ok: bool, outcome: str, reason: str):
        self.ok = bool(ok)
        self.outcome = outcome      # ok | timeout | exit | oserror
        self.reason = reason

    def __bool__(self):
        return self.ok

    def __repr__(self):
        return (f"ProbeResult(ok={self.ok}, outcome={self.outcome!r}, "
                f"reason={self.reason!r})")


_MEMO: dict = {}


def _run_probe(timeout, env, require_accelerator) -> ProbeResult:
    check = ("assert torch.cuda.is_available(), 'no CUDA device';"
             if require_accelerator else "")
    try:
        r = subprocess.run(
            [sys.executable, "-c", _PROBE_CODE.format(check=check)],
            env=env, timeout=timeout, capture_output=True)
    except subprocess.TimeoutExpired:
        return ProbeResult(False, "timeout",
                           f"probe exceeded {timeout}s wall clock (device "
                           "call hung)")
    except OSError as exc:
        return ProbeResult(False, "oserror",
                           f"probe subprocess failed to start: {exc!r}")
    if r.returncode == 0:
        return ProbeResult(True, "ok", "probe passed")
    tail = (r.stderr or b"").decode("utf-8", "replace").strip()
    tail = tail[-_STDERR_TAIL:]
    return ProbeResult(False, "exit", f"probe exited {r.returncode}"
                       + (f"; stderr tail: {tail}" if tail else ""))


def probe_device(timeout=60, env=None, require_accelerator=True,
                 refresh=False):
    """Truthy :class:`ProbeResult` iff a small torch operation on the card
    (on the CPU when ``require_accelerator`` is False and no card is
    visible) completes within ``timeout`` seconds in a child process."""
    key = (tuple(sorted(env.items())) if env is not None else None,
           bool(require_accelerator))
    if not refresh and key in _MEMO:
        return _MEMO[key]
    res = _run_probe(timeout, env, require_accelerator)
    _MEMO[key] = res
    from . import telemetry
    from .logging import get_logger
    telemetry.registry().counter("device_probe", outcome=res.outcome).inc()
    if not res.ok:
        get_logger("ewt.deviceprobe").warning(
            "device probe failed (%s): %s", res.outcome, res.reason)
    return res
