"""Routing and launch accounting shared by the hand-written kernels.

Every routing decision of the three kernels (``mega_solve``,
``mega_like``, ``chol_precond``) goes through :func:`route` and records
the path it took in ``ROUTES`` under ``(kernel, path)``, path one of
``kernel`` (CUDA launch), ``plain-cpu``, ``over-cap``, ``disabled``,
``blocked`` (the ``EWT_BLOCKED_CHOL=1`` build pin declines all three
kernels: the classic chain then factors through
``ops/kernel.py:blocked_cholesky``) and, for the likelihood kernel,
``per-walker-basis`` (a sampled chromatic index gives each walker its
own basis, which the kernel does not take) and ``toa-sharded`` (Gram
blocks summed across processes, which the kernel, forming its own Gram
from whole rows, cannot take) — the counterpart of the reference's
``pallas_path{kernel,path}`` counter.
A launch adds one to ``LAUNCHES[kernel]`` and to the ``kernel`` route at
the launch site (:func:`record_launch`) and nowhere else; a kernel with
two designs also counts the one it launched in ``DESIGNS`` under
``(kernel, design)`` (``chol_precond``: ``smem`` up to the shared-memory
cap, ``global`` above it).

Switches, the reference's environment variables under the same names:
``EWT_PALLAS=0`` turns every kernel off, ``EWT_PALLAS_MEGA=0`` the two
megakernels, ``EWT_PALLAS_CHOL=0`` the preconditioner kernel; each
kernel's route asks its own switch only.
"""

from __future__ import annotations

import collections
import os

import torch

KERNELS = ("mega_solve", "mega_like", "chol_precond")
ROUTES = collections.Counter()
LAUNCHES = {k: 0 for k in KERNELS}
DESIGNS = collections.Counter()


def reset_counts():
    """Zero the route and launch counters (a run reads them after)."""
    ROUTES.clear()
    DESIGNS.clear()
    for k in KERNELS:
        LAUNCHES[k] = 0


def record_launch(kernel, design=None):
    LAUNCHES[kernel] += 1
    ROUTES[(kernel, "kernel")] += 1
    if design is not None:
        DESIGNS[(kernel, design)] += 1


def kernels_enabled():
    """``EWT_PALLAS=0`` switches every hand-written kernel off."""
    return os.environ.get("EWT_PALLAS", "1") != "0"


def _mega_enabled():
    return kernels_enabled() \
        and os.environ.get("EWT_PALLAS_MEGA", "1") != "0"


def _chol_enabled():
    return kernels_enabled() \
        and os.environ.get("EWT_PALLAS_CHOL", "1") != "0"


# the switch each kernel's route obeys
_ENABLED = {"mega_solve": _mega_enabled, "mega_like": _mega_enabled,
            "chol_precond": _chol_enabled}


def route(kernel, fits, device, why="over-cap"):
    """The one routing decision for a call of ``kernel`` on ``device``:
    ``kernel`` (a CUDA launch, recorded at the launch site), or a decline
    — ``disabled``, ``why`` (where the call does not ``fit`` the kernel:
    ``over-cap`` by default) or ``plain-cpu`` — recorded here. Raises
    for a device the port does not run on."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {dev}")
    if not _ENABLED[kernel]():
        path = "disabled"
    elif not fits:
        path = why
    elif dev.type == "cpu":
        path = "plain-cpu"
    else:
        return "kernel"
    ROUTES[(kernel, path)] += 1
    return path


def check(t, name, shape):
    """A launch's input contract: float32, CUDA, ``shape``, contiguous."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def launch_check(rc, kernel):
    if rc != 0:
        raise RuntimeError(f"{kernel} CUDA launch failed: cudaError {rc}")
