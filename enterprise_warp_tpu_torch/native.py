"""ctypes binding of the native IO core (``native/fastio.cpp``).

Counterpart of ``enterprise_warp_tpu/native.py``: tempo2 FORMAT-1 ``.tim``
parsing, the chain-table reader and the ``%.18e`` table writer in C++.
:func:`load` compiles the repository's ``native/fastio.cpp`` with ``g++``
(the flags of ``native/Makefile``) into this package's git-ignored
``_build/_fastio.so`` at first use, and again when the source is newer
than the library, under a file lock, through a PID-unique temporary and a
rename, so a concurrent reader never opens a partial library. Where there
is no source or no compiler, or the build fails, it returns None and every
caller takes its pure-Python path (``io/tim.py``, ``results/core.py``,
``io/writers.py``), which stays the behavioural oracle in the tests. This
is host IO, not a device kernel.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from .utils.logging import get_logger

SRC = Path(__file__).resolve().parents[1] / "native" / "fastio.cpp"
SO_PATH = Path(__file__).resolve().parent / "_build" / "_fastio.so"
CXXFLAGS = ("-O3", "-Wall", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()
_LIB = None
_TRIED = False


def _bind(lib):
    c_dp = ctypes.POINTER(ctypes.c_double)
    c_ip = ctypes.POINTER(ctypes.c_int64)
    lib.ewt_tim_parse.argtypes = [ctypes.c_char_p]
    lib.ewt_tim_parse.restype = ctypes.c_void_p
    lib.ewt_tim_error.argtypes = [ctypes.c_void_p]
    lib.ewt_tim_error.restype = ctypes.c_char_p
    lib.ewt_tim_ntoa.argtypes = [ctypes.c_void_p]
    lib.ewt_tim_ntoa.restype = ctypes.c_longlong
    lib.ewt_tim_fill.argtypes = [ctypes.c_void_p, c_dp, c_ip, c_dp, c_dp]
    lib.ewt_tim_fill.restype = None
    lib.ewt_tim_strsize.argtypes = [ctypes.c_void_p]
    lib.ewt_tim_strsize.restype = ctypes.c_longlong
    lib.ewt_tim_strs.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ewt_tim_strs.restype = None
    lib.ewt_tim_free.argtypes = [ctypes.c_void_p]
    lib.ewt_tim_free.restype = None
    lib.ewt_table_read.argtypes = [ctypes.c_char_p]
    lib.ewt_table_read.restype = ctypes.c_void_p
    lib.ewt_table_size.argtypes = [ctypes.c_void_p]
    lib.ewt_table_size.restype = ctypes.c_longlong
    lib.ewt_table_ncols.argtypes = [ctypes.c_void_p]
    lib.ewt_table_ncols.restype = ctypes.c_longlong
    lib.ewt_table_fill.argtypes = [ctypes.c_void_p, c_dp]
    lib.ewt_table_fill.restype = None
    lib.ewt_table_free.argtypes = [ctypes.c_void_p]
    lib.ewt_table_free.restype = None
    lib.ewt_table_write.argtypes = [ctypes.c_char_p, c_dp, ctypes.c_longlong,
                                    ctypes.c_longlong, ctypes.c_int]
    lib.ewt_table_write.restype = ctypes.c_longlong
    return lib


def _fresh():
    return SO_PATH.exists() and \
        SO_PATH.stat().st_mtime >= SRC.stat().st_mtime


def build():
    """Compile ``native/fastio.cpp`` into ``_build/_fastio.so`` unless the
    library is newer than the source; returns its path. Raises
    ``RuntimeError`` when ``g++`` is missing or fails."""
    if _fresh():
        return SO_PATH
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    SO_PATH.parent.mkdir(parents=True, exist_ok=True)
    with open(SO_PATH.parent / "_fastio.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if _fresh():
            return SO_PATH
        tmp = SO_PATH.with_name(f"{SO_PATH.name}.tmp.{os.getpid()}")
        proc = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SRC)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed on {SRC.name}:\n"
                               f"{proc.stderr[-2000:]}")
        os.replace(tmp, SO_PATH)
    return SO_PATH


def load():
    """The bound native library, or None (the pure-Python paths apply)."""
    global _LIB, _TRIED
    with _lock:
        if _TRIED:
            return _LIB
        _TRIED = True
        if not SRC.exists():
            return None
        try:
            # ewt: allow-no-raw-kernel-launch — the host IO core (.tim parser,
            # chain tables), a CPU library with no kernel in it
            _LIB = _bind(ctypes.CDLL(str(build())))
        except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
            get_logger("ewt.native").warning(
                "native IO core unavailable, falling back to Python IO: %s",
                exc)
            _LIB = None
        return _LIB


def parse_tim_native(path: str):
    """Parse a ``.tim`` through the native core: ``(freqs, mjd_int, sec,
    errs, names, sites, flags)`` with the flags columnarized as ``{flag:
    (ntoa,) object array}``, or None where the core is unavailable.
    Raises ``FileNotFoundError`` for an unreadable file (the Python
    engine's contract) and ``ValueError`` on other parse errors (a cyclic
    INCLUDE)."""
    lib = load()
    if lib is None:
        return None
    h = lib.ewt_tim_parse(path.encode())
    try:
        err = lib.ewt_tim_error(h)
        if err:
            msg = err.decode()
            if msg.startswith("cannot open"):
                raise FileNotFoundError(msg)
            raise ValueError(msg)
        n = int(lib.ewt_tim_ntoa(h))
        freqs = np.empty(n)
        mjd_i = np.empty(n, dtype=np.int64)
        sec = np.empty(n)
        errs = np.empty(n)
        if n:
            lib.ewt_tim_fill(
                h, freqs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                mjd_i.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                sec.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                errs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        size = int(lib.ewt_tim_strsize(h))
        raw = ctypes.create_string_buffer(size)
        lib.ewt_tim_strs(h, raw)
        blocks = bytes(raw.raw[:size]).split(b"\0")
        names = blocks[0].decode().splitlines()
        sites = blocks[1].decode().splitlines()
        flags = {}
        for blk in blocks[2:]:
            if not blk:
                continue
            lines = blk.decode().split("\n")
            flags[lines[0]] = np.array(lines[1:n + 1], dtype=object)
        return freqs, mjd_i, sec, errs, names, sites, flags
    finally:
        lib.ewt_tim_free(h)


def read_table_native(path: str):
    """A numeric table (chain files) as a 2-D array, or None where the core
    is unavailable or the file is not a clean numeric table (a non-numeric
    token, a ragged row): the caller's ``np.loadtxt`` then applies its own
    error semantics."""
    lib = load()
    if lib is None:
        return None
    h = lib.ewt_table_read(path.encode())
    try:
        total = int(lib.ewt_table_size(h))
        ncols = int(lib.ewt_table_ncols(h))
        if total <= 0 or ncols <= 0 or total % ncols != 0:
            return None
        out = np.empty(total)
        lib.ewt_table_fill(
            h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return out.reshape(-1, ncols)
    finally:
        lib.ewt_table_free(h)


def write_table(path: str, arr, append: bool = True) -> None:
    """``%.18e`` table write (chain files), ``np.savetxt``'s default row
    format, through the native core's buffered writer, or ``np.savetxt``
    where the core is unavailable or its write failed (a failed native
    write's partial rows are cut off first)."""
    arr = np.ascontiguousarray(np.atleast_2d(arr), dtype=np.float64)
    lib = load()
    if lib is not None:
        pre = os.path.getsize(path) if (append and
                                        os.path.exists(path)) else 0
        rc = lib.ewt_table_write(
            path.encode(), arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            arr.shape[0], arr.shape[1], int(append))
        if rc == arr.shape[0]:
            return
        if rc == -1 and os.path.exists(path) and \
                os.path.getsize(path) > pre:
            os.truncate(path, pre)
    with open(path, "ab" if append else "wb") as fh:
        np.savetxt(fh, arr)
