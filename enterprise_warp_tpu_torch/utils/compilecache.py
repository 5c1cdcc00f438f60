"""The kernel build directory: the port's stand-in for the reference's
persistent XLA compilation cache.

Counterpart of ``enterprise_warp_tpu/utils/compilecache.py``, with its
names. The port has no jit: what a fresh process pays before its first
evaluation on the card is the ``nvcc`` build of the hand-written kernels
(``ops/cuda_lib.py``), and what a fresh replica can reuse across
processes is that build's library, keyed on the source digest and the
``nvcc`` flags. So the port's "compile cache" is the directory the
kernels are built into:

- ``enterprise_warp_tpu_torch/_build/`` by default (git-ignored);
- ``EWT_COMPILE_CACHE=<dir>`` relocates it;
- ``EWT_NO_COMPILE_CACHE=1`` builds into a fresh temporary directory,
  removed at exit: a cold replica that runs ``nvcc`` again.

:func:`enable_compilation_cache` returns the directory the kernels are
built into (``cache_dir`` pins it for this process);
:func:`arm_env` sets the same variable for child processes without
importing torch.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from pathlib import Path

__all__ = ["DEFAULT_DIR", "build_dir", "enable_compilation_cache",
           "arm_env"]

#: where the kernels are built unless ``EWT_COMPILE_CACHE`` says otherwise
DEFAULT_DIR = Path(__file__).resolve().parents[1] / "_build"

_PINNED = [None]     # the directory enable_compilation_cache(cache_dir) set
_FRESH = [None]      # this process's temporary directory (no cache)


def _resolve_dir(cache_dir=None) -> str:
    """The directory the knobs select (no side effects)."""
    if cache_dir is not None:
        return str(cache_dir)
    return os.environ.get("EWT_COMPILE_CACHE") or str(DEFAULT_DIR)


def _fresh_dir() -> str:
    if _FRESH[0] is None:
        _FRESH[0] = tempfile.mkdtemp(prefix="ewt_build_")
        atexit.register(shutil.rmtree, _FRESH[0], True)
    return _FRESH[0]


def build_dir() -> Path:
    """The directory ``ops/cuda_lib.py`` builds the kernels into now."""
    if os.environ.get("EWT_NO_COMPILE_CACHE"):
        return Path(_fresh_dir())
    return Path(_PINNED[0] or _resolve_dir())


def enable_compilation_cache(cache_dir=None):
    """Pin the kernel build directory for this process (``cache_dir``, or
    the knobs' choice) and return it; with ``EWT_NO_COMPILE_CACHE=1``,
    this process's fresh temporary directory."""
    if os.environ.get("EWT_NO_COMPILE_CACHE"):
        return _fresh_dir()
    _PINNED[0] = _resolve_dir(cache_dir)
    return _PINNED[0]


def arm_env(cache_dir=None):
    """Set ``EWT_COMPILE_CACHE`` for child processes (a value the user
    set wins) without importing torch; returns the directory armed, or
    None with ``EWT_NO_COMPILE_CACHE=1`` (each child then builds into its
    own fresh directory)."""
    if os.environ.get("EWT_NO_COMPILE_CACHE"):
        return None
    os.environ.setdefault("EWT_COMPILE_CACHE", _resolve_dir(cache_dir))
    return os.environ["EWT_COMPILE_CACHE"]
