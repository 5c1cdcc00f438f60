"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, into the build directory
(``enterprise_warp_tpu_torch/_build/``, git-ignored, unless
``utils/compilecache.py`` relocates it), under a file lock so concurrent
processes build once. The library name carries a digest of the source and
the flags, so an edited kernel is rebuilt, and a process that finds the
library already built reuses it: :data:`BUILD_VERDICTS` says which
(``True``: found built, ``False``: ``nvcc`` ran). Nothing here runs at import: the CPU tests import this
module on machines with no ``nvcc`` and no card.

Pointers and the stream cross into C as ``ctypes.c_void_p``
(``tensor.data_ptr()``, ``torch.cuda.current_stream().cuda_stream``);
each launch function returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..utils import compilecache

CSRC = Path(__file__).resolve().parent / "csrc"
#: the default build directory (``compilecache.build_dir()`` is the one in
#: use)
BUILD_DIR = compilecache.DEFAULT_DIR
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "mega_solve_ws_floats": ([_I, _I], ctypes.c_longlong),
    "mega_like_ws_floats": ([_I, _I], ctypes.c_longlong),
    "mega_like_single_block_ws_floats": ([_I, _I, _I], ctypes.c_longlong),
    "mega_solve_factor_launch": ([_P] * 3 + [_I, _I, _I, _F, _F, _P], _I),
    "mega_solve_inverse_launch": ([_P, _I, _I, _I, _P], _I),
    "mega_solve_refine_launch": ([_P] * 4 + [_I, _I, _I, _I, _P], _I),
    "mega_solve_refine_serial_launch": ([_P] * 4 + [_I, _I, _I, _I, _P], _I),
    "mega_solve_product_launch": ([_P] * 2 + [_I, _I, _I, _I, _P], _I),
    "mega_solve_logdet_launch": ([_P] * 2 + [_I, _I, _I, _P], _I),
    "mega_solve_inverse_single_block_launch": ([_P, _I, _I, _I, _P], _I),
    "mega_solve_product_single_block_launch": (
        [_P] * 2 + [_I, _I, _I, _I, _P], _I),
    "mega_solve_single_block_launch": (
        [_P] * 6 + [_I, _I, _I, _F, _F, _I, _P], _I),
    "mega_like_gram_launch": ([_P] * 5 + [_I, _I, _I, _P], _I),
    "mega_like_factor_threads": ([], _I),
    "mega_like_factor_launch": ([_P] * 3 + [_I, _I, _I, _F, _F, _I, _P], _I),
    "mega_like_launch": ([_P] * 9 + [_I, _I, _I, _I, _F, _F, _I, _P], _I),
    "mega_like_single_block_launch": (
        [_P] * 9 + [_I, _I, _I, _I, _F, _F, _I, _P], _I),
    "mega_like_gram_single_block_launch": ([_P] * 6 + [_I, _I, _I, _P], _I),
    "chol_precond_ws_floats": ([_I], ctypes.c_longlong),
    "chol_precond_launch": ([_P] * 6 + [_I, _I, _F, _F, _P], _I),
    "chol_precond_smem_maxn": ([], _I),
    "chol_precond_smem_launch": ([_P] * 5 + [_I, _I, _F, _F, _P], _I),
    "chol_precond_smem_phases_launch": (
        [_P] * 5 + [_I, _I, _F, _F, _I, _P], _I),
}

_lock = threading.Lock()
_libs = {}
#: compiler output (``-Xptxas -v``: registers, shared memory, spills) of
#: each build this process ran, by source name
BUILD_LOG = {}
#: by source name: True when :func:`build` found the library already
#: built, False when it ran ``nvcc``
BUILD_VERDICTS = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def build(name="megakernel") -> Path:
    """Compile ``csrc/<name>.cu`` (once per source digest) and return the
    shared library's path."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    bdir = compilecache.build_dir()
    out = bdir / f"lib{name}_{digest[:16]}.so"
    BUILD_VERDICTS[name] = True
    if out.exists():
        return out
    bdir.mkdir(parents=True, exist_ok=True)
    with open(bdir / f"{name}.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if out.exists():
            return out
        BUILD_VERDICTS[name] = False
        tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True)
        BUILD_LOG[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def load_library(name="megakernel"):
    """The loaded, typed ctypes library for ``csrc/<name>.cu``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, (argtypes, restype) in _SIGNATURES.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = restype
            _libs[name] = lib
    return lib


def loaded(name="megakernel") -> bool:
    """Whether this process has loaded ``csrc/<name>.cu``'s library."""
    return name in _libs
