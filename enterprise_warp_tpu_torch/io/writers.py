"""Writers: the samplers' run artifacts (durable atomic JSON, chain
tables, checkpoint generations with sha256 sidecars) and tempo2 ``.par``
/ ``.tim`` files.

Counterpart of the reference package's ``io/writers.py`` (and its
``native.write_table``). Simulated pulsars are plain :class:`Pulsar`
containers, so writing one to disk needs native writers: tempo2
``FORMAT 1`` (tim) and line-oriented ``KEY value [fit]`` (par), the
grammar the parsers read, so write -> parse is lossless. From the same
pulsar the files are byte for byte the reference's.
"""

from __future__ import annotations

import copy
import hashlib
import json
import math
import os

import numpy as np

from .. import constants as const
# the chain-table writer: the native core's, with np.savetxt's fallback
from ..native import write_table  # noqa: F401
from .par import ParFile
from .pulsar import Pulsar
from .tim import TimFile


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


#: resolve_checkpoint's memo: absolute path -> (stat signature of the
#: four generation files, resolved path). One resume resolves the same
#: checkpoint twice (sample_to_convergence reads the step counter, then
#: the sampler loads the state); the memo keeps that to one digest pass
#: and, on a corrupt archive, one ``ckpt_corrupt`` record. Any write,
#: rotation or corruption changes a signature and invalidates the entry.
_RESOLVE_MEMO: dict = {}


def _generation_stat_sig(path: str):
    """``(st_mtime_ns, st_size)`` of ``path``, its sidecar, its previous
    generation and that one's sidecar (None for an absent file)."""
    sig = []
    for p in (path, sidecar_path(path), prev_generation(path),
              sidecar_path(prev_generation(path))):
        try:
            st = os.stat(p)
            sig.append((st.st_mtime_ns, st.st_size))
        except OSError:
            sig.append(None)
    return tuple(sig)


def resolve_checkpoint(path: str, what: str = "checkpoint"):
    """Digest-verified checkpoint resolution with last-good fallback:
    tries ``path`` then :func:`prev_generation`; a candidate is
    accepted when its sidecar digest matches (or when it has none — a
    legacy or mid-rotation generation). A mismatch is logged under
    ``what``, recorded as a ``ckpt_corrupt`` event and
    ``ckpt_verify{outcome=corrupt}``, and falls through to the previous
    generation. Returns the usable path, or None when no restorable
    generation exists. A repeat call on unchanged files returns the
    memoized verdict (``_RESOLVE_MEMO``) without hashing or recording
    again. Fault site ``ckpt.verify`` fires on every call, before the
    memo: kind ``torn`` truncates ``path`` on disk before verification
    (which changes the signature, so it is always verified anew)."""
    from ..resilience import faults
    from ..utils import telemetry
    from ..utils.logging import get_logger
    spec = faults.fire("ckpt.verify", write=True, path=path)
    if spec is not None and spec.kind == "torn" and os.path.exists(path):
        with open(path, "rb") as fh:
            data = fh.read()
        with open(path, "wb") as fh:
            fh.write(faults.torn_bytes(spec, data))
    key = os.path.abspath(path)
    sig = _generation_stat_sig(key)
    memo = _RESOLVE_MEMO.get(key)
    if memo is not None and memo[0] == sig:
        return memo[1]
    log = get_logger("ewt.ckpt")
    reg = telemetry.registry()
    for generation, cand in enumerate((path, prev_generation(path))):
        if not os.path.exists(cand):
            continue
        verdict = verify_checkpoint(cand)
        if verdict is False:
            reg.counter("ckpt_verify", outcome="corrupt").inc()
            log.error("%s %s failed digest verification%s", what, cand,
                      " — falling back one generation" if generation == 0
                      else "")
            from ..utils.flightrec import flight_recorder
            flight_recorder().record("ckpt_corrupt", path=cand,
                                     generation=generation, what=what)
            rec = telemetry.active_recorder()
            if rec is not None:
                rec.event("ckpt_corrupt", path=cand, generation=generation,
                          what=what)
                rec.flush()
            continue
        reg.counter("ckpt_verify",
                    outcome="ok" if verdict else "unverified").inc()
        if generation:
            reg.counter("ckpt_verify", outcome="fallback").inc()
            log.warning("%s restored from previous generation %s", what,
                        cand)
        _RESOLVE_MEMO[key] = (sig, cand)
        return cand
    _RESOLVE_MEMO[key] = (sig, None)
    return None


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

    Fault site ``io.atomic_json``: ``torn`` writes a truncated payload
    through the rename; ``kill`` writes the truncated tmp and dies before
    the rename, so the destination keeps its previous content.
    """
    if default is None:
        default = float
    from ..resilience import faults
    spec = faults.fire("io.atomic_json", write=True, path=path)
    data = json.dumps(obj, indent=indent, sort_keys=sort_keys,
                      default=default)
    if spec is not None and spec.kind in ("torn", "kill"):
        data = faults.torn_bytes(spec, data)
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
        if spec is not None and spec.kind == "kill":
            faults.kill_now(spec)
        durable_replace(tmp, path)
    except BaseException:
        # a failed dump must not leave a stray tmp next to the artifact
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    return path


def atomic_write_text(path: str, text: str):
    """Atomic (tmp + same-directory rename) text write without the
    durability fsyncs of :func:`atomic_write_json`: for artifacts that
    are rewritten often and only scraped, where a reader must never see
    a torn file but losing the last refresh to a power cut costs
    nothing."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as fh:
            fh.write(text)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
        raise
    return path


def _rad_to_hms(rad: float) -> str:
    hours = (rad % (2.0 * math.pi)) * 12.0 / math.pi
    h = int(hours)
    m = int((hours - h) * 60.0)
    s = ((hours - h) * 60.0 - m) * 60.0
    return f"{h:02d}:{m:02d}:{s:011.8f}"


def _rad_to_dms(rad: float) -> str:
    sign = "-" if rad < 0 else "+"
    deg = abs(rad) * 180.0 / math.pi
    d = int(deg)
    m = int((deg - d) * 60.0)
    s = ((deg - d) * 60.0 - m) * 60.0
    return f"{sign}{d:02d}:{m:02d}:{s:010.7f}"


def write_par(par: ParFile, path: str):
    """Write a :class:`ParFile`. Keys parsed from a real file round-trip
    through ``par.raw`` (lossless string values); synthetic ParFiles
    (``sim.make_fake_pulsar``) fall back to the typed fields."""
    lines = []

    def emit(key, value, fit=None):
        if fit is None:
            fit = par.fit_flags.get(key, False)
        tail = "  1" if fit else ""
        lines.append(f"{key:<12} {value}{tail}")

    emit("PSRJ", par.name or "J0000+0000", fit=False)
    emit("RAJ", par.raw.get("RAJ", _rad_to_hms(par.raj)))
    emit("DECJ", par.raw.get("DECJ", _rad_to_dms(par.decj)))
    for key in ("F0", "F1", "F2", "DM", "DM1", "DM2", "PMRA", "PMDEC",
                "PX", "PB", "A1", "ECC", "T0", "OM"):
        attr = key.lower()
        val = par.raw.get(key, getattr(par, attr, 0.0))
        # zero-valued params are still emitted when present in the source
        # or marked for fitting (their design-matrix column must survive)
        if float(val) != 0.0 or key == "F0" or key in par.raw \
                or par.fit_flags.get(key):
            emit(key, repr(float(val)) if key not in par.raw else val)
    for key in ("PEPOCH", "POSEPOCH", "DMEPOCH", "TZRMJD", "TZRFRQ"):
        attr = key.lower()
        val = par.raw.get(key, getattr(par, attr, 0.0))
        if float(val) != 0.0:
            emit(key, val, fit=False)
    if par.tzrsite:
        emit("TZRSITE", par.tzrsite, fit=False)
    for key, val in (("UNITS", par.units), ("EPHEM", par.ephem),
                     ("CLK", par.clk)):
        if val:
            emit(key, val, fit=False)
    # pass through every remaining raw key so real .par metadata
    # (START/FINISH, TRES, NE_SW, BINARY, ...) survives the round trip
    handled = {ln.split()[0] for ln in lines} | {"PSR"}
    for key, val in par.raw.items():
        if key not in handled:
            emit(key, val)
    for jmp in par.jumps:
        lines.append(f"JUMP -{jmp.flag} {jmp.flagval} {jmp.value!r} "
                     f"{1 if jmp.fit else 0}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def write_tim(tim: TimFile, path: str, flags_order=None):
    """Write a :class:`TimFile` as tempo2 FORMAT 1."""
    flags_order = flags_order or sorted(tim.flags)
    with open(path, "w") as fh:
        fh.write("FORMAT 1\n")
        for i in range(len(tim)):
            frac = tim.sec[i] / const.day
            day = int(tim.mjd_int[i])
            if frac >= 1.0 or frac < 0.0:    # normalize day overflow
                shift = int(np.floor(frac))
                day += shift
                frac -= shift
            mjd = f"{day}.{format(frac, '.17f')[2:]}"
            # error column: %.10g preserves sub-1e-4-us uncertainties that
            # a fixed %.4f would serialize as 0.0000 (reloading sigma=0
            # then divides by zero in whiten_inputs)
            row = (f"{tim.names[i]} {tim.freqs[i]:.6f} {mjd} "
                   f"{tim.errs[i]:.10g} {tim.sites[i]}")
            for k in flags_order:
                v = str(tim.flags[k][i])
                if v:
                    row += f" -{k} {v}"
            fh.write(row + "\n")


def _align_to_pulses(dt: np.ndarray, par: ParFile) -> np.ndarray:
    """Shift PEPOCH-relative arrival times (< half a period) onto integer
    pulse numbers of the par's spin solution, so a zero-residual simulated
    pulsar re-loads with zero phase residuals."""
    phase = dt * (par.f0 + dt * par.f1 / 2.0)
    n = np.round(phase)
    for _ in range(3):          # Newton refinement (exact when f1 == 0)
        dt = dt + (n - dt * (par.f0 + dt * par.f1 / 2.0)) \
            / (par.f0 + dt * par.f1)
    return dt


def pulsar_to_timfile(psr: Pulsar, par: ParFile | None = None,
                      apply_residuals: bool = True) -> TimFile:
    """Render a (typically simulated) :class:`Pulsar` back into TOA form.

    With ``apply_residuals`` the stored residuals are added to the arrival
    times — the libstempo convention where injection perturbs the TOAs
    themselves, so a later ``load_pulsar`` recovers the injected noise as
    phase residuals. With ``par`` given, noise-free arrival times are first
    aligned to that spin solution's pulse grid (sub-period shifts).

    Precision: with ``par`` given, the (MJD-int, seconds) split is computed
    relative to PEPOCH — never through absolute seconds — so the split adds
    ~3e-8 s error over a 10 yr span. Without ``par`` the split is taken
    relative to the first TOA's day for the same reason, but the absolute
    ``psr.toas`` float64 representation itself carries ~1 us ulp at
    MJD-scale seconds, which bounds the par=None round-trip precision.
    """
    n = len(psr)
    if par is not None:
        base = int(np.floor(par.pepoch))
        dt = _align_to_pulses(
            psr.toas - par.pepoch * const.day, par) \
            + (par.pepoch - base) * const.day
    else:
        base = int(np.floor(psr.toas[0] / const.day))
        dt = psr.toas - base * const.day
    day_off = np.floor(dt / const.day).astype(np.int64)
    mjd_int = base + day_off
    sec = dt - day_off * const.day
    if apply_residuals:
        sec = sec + psr.residuals
    flags = {k: np.asarray(v, dtype=object) for k, v in psr.flags.items()}
    return TimFile(
        names=np.array([f"{psr.name}_{i:05d}" for i in range(n)],
                       dtype=object),
        freqs=psr.freqs.astype(np.float64),
        mjd_int=mjd_int,
        sec=sec,
        errs=psr.toaerrs * 1e6,
        sites=np.array(["bat"] * n, dtype=object),
        flags=flags,
    )


def _synthesize_par(psr: Pulsar) -> ParFile:
    """A minimal phase-connectable par for a simulated pulsar: spin F0/F1
    fitted (matching the quadratic design matrix of ``make_fake_pulsar``),
    barycentric site, PEPOCH at the first TOA."""
    par = ParFile()
    par.name = psr.name
    par.raj, par.decj = float(psr.raj), float(psr.decj)
    par.f0 = getattr(psr.par, "f0", 100.0) if psr.par else 100.0
    par.pepoch = float(np.floor(psr.toas.min() / const.day))
    par.posepoch = par.dmepoch = par.pepoch
    par.tzrsite = "bat"
    par.units = "TDB"
    par.fit_flags = {"F0": True, "F1": True}
    par.raw["F1"] = "0.0"
    return par


def save_pulsar_pair(psr: Pulsar, datadir: str, apply_residuals=True):
    """Write ``<datadir>/<name>.par`` + ``.tim`` for a simulated pulsar."""
    os.makedirs(datadir, exist_ok=True)
    par = psr.par if (psr.par and psr.par.raw) else _synthesize_par(psr)
    if not par.fit_flags.get("F0"):
        # never mutate the caller's ParFile: adjust a shallow working copy
        par = copy.copy(par)
        par.fit_flags = dict(par.fit_flags)
        par.fit_flags["F0"] = True
        par.fit_flags["F1"] = True
    parfile = os.path.join(datadir, f"{psr.name}.par")
    timfile = os.path.join(datadir, f"{psr.name}.tim")
    write_par(par, parfile)
    write_tim(pulsar_to_timfile(psr, par=par,
                                apply_residuals=apply_residuals), timfile)
    return parfile, timfile
