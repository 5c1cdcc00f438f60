"""Run-artifact writers the samplers use: durable atomic JSON, chain
tables, and checkpoint generations with sha256 sidecars.

The subset of the reference package's ``io/writers.py`` (and its
``native.write_table``) that the PT, HMC and nested samplers' on-disk
contracts need.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np


def fsync_dir(path: str):
    """fsync the directory holding ``path`` so a just-renamed entry
    survives a power loss / hard kill (POSIX: ``rename`` alone orders
    nothing against the directory's own durability). Platform-tolerant:
    filesystems/OSes that refuse ``open(dir)`` or directory fsync
    (some network mounts, Windows) degrade to a no-op — the rename is
    still atomic, just not yet durable."""
    try:
        fd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                     os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def durable_replace(tmp: str, path: str):
    """``os.replace`` plus source-file and directory fsync: the
    durability tail every atomic-write path in the package shares
    (JSON artifacts here, the samplers' ``state.npz`` checkpoints).
    The tmp file's DATA must be on disk before the rename makes it
    reachable, and the rename itself must be on disk before a caller
    treats the checkpoint as taken."""
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
    os.replace(tmp, path)
    fsync_dir(path)


# ------------------------------------------------------------------ #
#  checkpoint integrity generations (docs/resilience.md)              #
# ------------------------------------------------------------------ #
#
# ``durable_replace`` guarantees the checkpoint file is COMPLETE, but a
# complete file can still be WRONG: silent media corruption, a torn
# filesystem journal replay, an operator cp from a bad copy. A resume
# that np.load()s such a file either crashes (lucky) or silently
# continues from garbage state (not lucky). The generation layer closes
# this: every checkpoint write lands with a sha256 sidecar
# (``state.npz.sha256``), the previous generation is rotated to
# ``state.prev.npz`` (plus its own sidecar) instead of being clobbered,
# and :func:`resolve_checkpoint` verifies the digest at restore time —
# a corrupted-but-complete checkpoint falls back one generation with a
# ``ckpt_corrupt`` event instead of dying.

def sidecar_path(path: str) -> str:
    """The digest sidecar of a checkpoint file."""
    return path + ".sha256"


def prev_generation(path: str) -> str:
    """The last-good generation of ``path``:
    ``state.npz`` -> ``state.prev.npz``."""
    root, ext = os.path.splitext(path)
    return root + ".prev" + ext


def sha256_file(path: str) -> str:
    """Streaming sha256 of a file's content (hex)."""
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def checkpoint_replace(tmp: str, path: str) -> str:
    """:func:`durable_replace` plus integrity generations: rotate the
    current ``path`` (and its sidecar) to :func:`prev_generation`,
    install ``tmp`` as the new ``path``, and write its sha256 sidecar.
    Returns the digest.

    Ordering is chosen so that every crash window leaves a RESTORABLE
    state for :func:`resolve_checkpoint`:

    1. sidecar rotation first, then data — a crash in between leaves
       ``path`` (still the old, good data) without a sidecar, which
       restores as an unverified-but-accepted generation;
    2. the new data lands via :func:`durable_replace` BEFORE its
       sidecar is written — a crash in between again leaves a
       sidecar-less (accepted) generation, never a mismatching pair;
    3. a crash between the rotation and the new data's rename leaves
       no ``path`` at all, and restore falls back to the verified
       ``prev`` generation.
    """
    digest = sha256_file(tmp)
    prev = prev_generation(path)
    if os.path.exists(path):
        if os.path.exists(sidecar_path(path)):
            os.replace(sidecar_path(path), sidecar_path(prev))
        else:
            # a legacy (pre-sidecar) generation rotates without one; a
            # stale prev sidecar must not shadow it as "corrupt"
            try:
                os.remove(sidecar_path(prev))
            except FileNotFoundError:
                pass
        os.replace(path, prev)
    durable_replace(tmp, path)
    side_tmp = sidecar_path(path) + ".tmp"
    with open(side_tmp, "w") as fh:
        fh.write(digest + "\n")
    durable_replace(side_tmp, sidecar_path(path))
    return digest


def verify_checkpoint(path: str):
    """Digest verdict for one generation: True (sidecar matches),
    False (mismatch — the file is corrupt), None (no sidecar — a
    legacy or mid-rotation generation, accepted unverified)."""
    sp = sidecar_path(path)
    if not os.path.exists(sp):
        return None
    with open(sp) as fh:
        want = fh.read().split()
    if not want:
        return None
    return sha256_file(path) == want[0]


def checkpoint_exists(path: str) -> bool:
    """Any generation of ``path`` present on disk (the cheap resume
    test; :func:`resolve_checkpoint` does the digest work)."""
    return os.path.exists(path) or os.path.exists(prev_generation(path))


def remove_checkpoint(path: str):
    """Remove every generation of ``path`` and their sidecars (the run is
    complete: the next one starts fresh)."""
    for p in (path, sidecar_path(path), prev_generation(path),
              sidecar_path(prev_generation(path))):
        try:
            os.remove(p)
        except FileNotFoundError:
            pass


def resolve_checkpoint(path: str, what: str = "checkpoint"):
    """Digest-verified checkpoint resolution with last-good fallback:
    tries ``path`` then :func:`prev_generation`; a candidate is
    accepted when its sidecar digest matches (or when it has none — a
    legacy or mid-rotation generation). A mismatch is logged under
    ``what`` and falls through to the previous generation. Returns the
    usable path, or None when no restorable generation exists."""
    from ..utils.logging import get_logger
    log = get_logger("ewt.ckpt")
    for generation, cand in enumerate((path, prev_generation(path))):
        if not os.path.exists(cand):
            continue
        if verify_checkpoint(cand) is False:
            log.error("%s %s failed digest verification%s", what, cand,
                      " — falling back one generation" if generation == 0
                      else "")
            continue
        if generation:
            log.warning("%s restored from previous generation %s", what,
                        cand)
        return cand
    return None


def write_table(path: str, arr, append: bool = True) -> None:
    """``%.18e`` table write (chain files): np.savetxt's default row
    format, the same text the reference package's native writer
    produces."""
    arr = np.ascontiguousarray(np.atleast_2d(arr), dtype=np.float64)
    with open(path, "ab" if append else "wb") as fh:
        np.savetxt(fh, arr)


def atomic_write_json(path: str, obj, indent: int = 1, sort_keys=False,
                      default=None):
    """Write ``obj`` as JSON to ``path`` atomically AND durably (tmp
    file + fsync + rename + directory fsync).

    The shared write path for every run artifact refreshed while a run
    is live (``mask_stats.json``, nested result JSON, ``run_report.json``,
    bench records): a kill mid-write must never leave a truncated file
    where a consumer — a resumed run, a results process tailing the
    directory — expects valid JSON. ``os.replace`` is atomic on POSIX
    within one filesystem, which the same-directory tmp name guarantees;
    the fsyncs (:func:`durable_replace`) close the remaining hole where
    a crash AFTER the rename could still surface a zero-length or torn
    file because neither the tmp's data nor the directory entry had
    reached disk.

    ``default`` falls back to ``float`` coercion for numpy scalars (the
    dominant non-JSON type in run artifacts) when not given.
    """
    if default is None:
        default = float
    data = json.dumps(obj, indent=indent, sort_keys=sort_keys,
                      default=default)
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as fh:
            fh.write(data)
            fh.flush()
            try:
                os.fsync(fh.fileno())
            except OSError:
                pass    # platform-tolerant: durability degrades,
                #         atomicity does not
        durable_replace(tmp, path)
    except BaseException:
        # a failed dump must not leave a stray tmp next to the artifact
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    return path
