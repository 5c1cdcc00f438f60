"""The device diagnostics plane: block moments on the device and the
streaming mixing diagnostics on the host.

Counterpart of ``enterprise_warp_tpu/utils/devicemetrics.py``, its mesh
half included (:func:`mesh_enabled`, :class:`MeshStatsLedger`,
:func:`write_mesh_stats`: the sharded joint likelihood's per-shard
attribution, folded at block cadence).

**Device side.** The reference threads fixed-shape accumulators (Welford
moments, extrema, a fixed-bin histogram) through its ``lax.scan`` carry
and updates them every step. The port's samplers run a Python step loop
whose cost is its launches, so nothing is added inside the step: each
block already keeps its cold rows on the device (``out_x``, (steps,
nchains, ndim)), and :func:`block_moments` folds them once per block over
the step axis into ``(mean, M2, min, max, hist)``, a handful of
launches and no host synchronisation (the histogram is an ``index_add_``;
``torch.bincount`` would read its maximum back to the host). The result
joins the block's one host snapshot. Merged into a run with Chan's formula
(:func:`welford_merge`), it equals the reference's per-step Welford
updates over the same rows within float64 rounding. Of the reference's
per-step primitives only the histogram's (:func:`hist_init`,
:func:`hist_add`) are kept: :func:`block_moments` adds a whole block
with them.

``EWT_TELEMETRY=0`` (the master switch) or ``EWT_DEVICE_DIAG=0`` (the
plane alone) turns the plane off; it only reads the chain, so the chain
is the same bit for bit either way.

**Host side.** :class:`MomentLedger` keeps the per-block, per-chain
sufficient statistics ``(count, mean, M2, min, max)`` of a sampler's cold
chains, appended once per block (:meth:`MomentLedger.append_block`, or
:meth:`MomentLedger.append_samples` from rows already on the host, as
HMC's). From it, at block cadence and O(blocks) host cost:

- :meth:`MomentLedger.split_rhat` — split-R-hat with the split at the
  block boundary nearest the halfway point (the Gelman/BDA3 formula
  exactly when that boundary is the halfway point);
- :meth:`MomentLedger.moment_ess` — batch-means ESS from the per-block
  means grouped into ~sqrt(blocks) batches. It over-reads while batches
  are shorter than the autocorrelation time, so the convergence gate
  (``samplers/convergence.py``) confirms every streaming pass with the
  exact estimators.

The ledger serializes to flat arrays (:meth:`MomentLedger.state_dict`,
:meth:`MomentLedger.from_state`), the ``diag_*`` keys of a sampler's
``state.npz``, so a resumed run's streaming R-hat continues from the
checkpointed statistics.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import telemetry

__all__ = ["enabled", "mesh_enabled", "MeshStatsLedger",
           "write_mesh_stats", "welford_merge", "welford_finalize",
           "hist_init", "hist_add", "hist_bounds", "block_moments",
           "set_stream_gauges",
           "MomentLedger", "DEFAULT_NBINS", "STREAM_BURN_FRAC"]

#: fixed bin count of the per-parameter marginal histograms
DEFAULT_NBINS = 32

#: the post-burn window of every streaming diagnostic (the default
#: ``burn_frac`` of the ledger's estimators)
STREAM_BURN_FRAC = 0.25

#: ledger compaction threshold: at this many retained blocks adjacent
#: pairs are merged (exactly, by Welford merge), halving the count, so
#: every diagnostic fold stays O(cap) whatever the run's length
COMPACT_CAP = 512


def set_stream_gauges(worst):
    """The ``stream_rhat``/``stream_ess`` gauges from a ledger's
    :meth:`MomentLedger.worst` figures (None entries left unset)."""
    if worst is None:
        return
    reg = telemetry.registry()
    for key in ("rhat", "ess"):
        if worst[key] is not None:
            reg.gauge(f"stream_{key}").set(worst[key])


def enabled() -> bool:
    """Whether the device diagnostics plane is armed: on by default,
    off with ``EWT_TELEMETRY=0`` or ``EWT_DEVICE_DIAG=0``."""
    return telemetry.enabled() \
        and os.environ.get("EWT_DEVICE_DIAG", "1") != "0"


# ------------------------------------------------------------------ #
#  device side (torch)                                                #
# ------------------------------------------------------------------ #

def hist_init(ndim, nbins=DEFAULT_NBINS, device="cpu"):
    """Zero fixed-bin histogram ``(ndim, nbins)`` (float64 counts, exact
    integers up to 2**53)."""
    return torch.zeros((ndim, nbins), dtype=torch.float64, device=device)


def _bins(x, lo, span, nbins):
    """Bin index of every element of ``x`` (..., ndim) on the affine grid
    ``lo + span * [0..nbins]/nbins``, out-of-range values clamped into the
    edge bins (truncation toward zero, as the reference's int cast)."""
    return torch.clamp(((x - lo) / span * nbins).to(torch.int64), 0,
                       nbins - 1)


def hist_add(hist, x, lo, span):
    """Add one batch ``x`` (batch, ndim) into the (ndim, nbins)
    histogram ``hist`` (returned, not modified)."""
    nbins = hist.shape[1]
    idx = _bins(x, lo, span, nbins)
    dims = torch.arange(x.shape[1], device=x.device)[None, :] * nbins
    return hist.reshape(-1).index_add(
        0, (idx + dims).reshape(-1),
        torch.ones(idx.numel(), dtype=hist.dtype, device=hist.device)) \
        .reshape(hist.shape)


def block_moments(rows, lo, span, nbins=DEFAULT_NBINS):
    """One block's fold over its step axis: ``rows`` (steps, nchains,
    ndim) float64 on the device, ``lo``/``span`` (ndim,) the histogram
    grid. Returns the device tensors ``mean``, ``m2``, ``min``, ``max``
    (nchains, ndim) and ``hist`` (ndim, nbins), with no host
    synchronisation; the block's count is ``steps``."""
    nd = rows.shape[-1]
    mean = rows.mean(dim=0)
    m2 = torch.sum((rows - mean) ** 2, dim=0)
    hist = hist_add(hist_init(nd, nbins, device=rows.device),
                    rows.reshape(-1, nd), lo, span)
    return mean, m2, rows.amin(dim=0), rows.amax(dim=0), hist


# ------------------------------------------------------------------ #
#  host side (numpy)                                                  #
# ------------------------------------------------------------------ #

def welford_merge(a, b):
    """Chan et al. parallel merge of two Welford states (associative up
    to floating point, the property the block-granular ledger relies
    on)."""
    na, ma, m2a = a
    nb, mb, m2b = b
    na = np.asarray(na, dtype=np.float64)
    nb = np.asarray(nb, dtype=np.float64)
    n = na + nb
    safe = np.maximum(n, 1.0)
    d = np.asarray(mb, dtype=np.float64) - np.asarray(ma, dtype=np.float64)
    mean = np.asarray(ma, dtype=np.float64) + d * (nb / safe)
    m2 = (np.asarray(m2a, dtype=np.float64)
          + np.asarray(m2b, dtype=np.float64)
          + d * d * (na * nb / safe))
    return (n, mean, m2)


def welford_finalize(state, ddof=1):
    """``(n, mean, var)`` from a Welford state; below ``ddof + 1``
    samples ``var`` is NaN, which callers gate on ``n``."""
    n, mean, m2 = state
    n = float(np.asarray(n))
    mean = np.asarray(mean, dtype=np.float64)
    m2 = np.asarray(m2, dtype=np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        var = m2 / (n - ddof)
    return n, mean, var


def hist_bounds(params, nsigma=5.0):
    """Per-parameter histogram bounds ``(lo, span)`` from the priors: box
    priors their support, location-scale priors ``mu +/- nsigma *
    sigma``, anything else the unit interval."""
    lo, hi = [], []
    for p in params:
        pr = getattr(p, "prior", None)
        a, b = 0.0, 1.0
        if pr is not None and hasattr(pr, "lo"):
            a, b = float(pr.lo), float(pr.hi)
        elif pr is not None and hasattr(pr, "sigma"):
            mu = float(getattr(pr, "mu", 0.0))
            s = float(pr.sigma)
            a, b = mu - nsigma * s, mu + nsigma * s
        if not (np.isfinite(a) and np.isfinite(b)) or b <= a:
            a, b = 0.0, 1.0
        lo.append(a)
        hi.append(b)
    lo = np.asarray(lo, dtype=np.float64)
    return lo, np.asarray(hi, dtype=np.float64) - lo


class MomentLedger:
    """Block-granular sufficient statistics of a sampler's cold chains:
    per block, per chain ``(count, mean, M2, min, max)`` over every
    parameter. The per-block statistics are kept (``nblocks x nchains x
    ndim`` floats), so any contiguous block suffix folds exactly and the
    post-burn window tracks the growing run at block granularity."""

    def __init__(self, nchains, ndim):
        self.nchains = int(nchains)
        self.ndim = int(ndim)
        self._counts: list[int] = []
        self._means: list[np.ndarray] = []
        self._m2s: list[np.ndarray] = []
        self._mins: list[np.ndarray] = []
        self._maxs: list[np.ndarray] = []

    def __len__(self):
        return len(self._counts)

    @property
    def total_steps(self) -> int:
        """Per-chain steps folded so far (across resumes when restored
        from a checkpoint)."""
        return int(sum(self._counts))

    # -------------------------- folds ------------------------------ #
    def append_block(self, count, mean, m2, mn=None, mx=None):
        """Fold one block: ``count`` per-chain steps, ``mean``/``m2`` the
        per-chain moments (``(nchains, ndim)``), optional extrema of the
        same shape."""
        count = int(np.asarray(count))
        if count <= 0:
            return
        shape = (self.nchains, self.ndim)
        self._counts.append(count)
        self._means.append(np.asarray(mean, dtype=np.float64).reshape(shape))
        self._m2s.append(np.asarray(m2, dtype=np.float64).reshape(shape))
        self._mins.append(
            np.full(shape, np.nan) if mn is None
            else np.asarray(mn, dtype=np.float64).reshape(shape))
        self._maxs.append(
            np.full(shape, np.nan) if mx is None
            else np.asarray(mx, dtype=np.float64).reshape(shape))
        if len(self._counts) >= COMPACT_CAP:
            self._compact()

    def _compact(self):
        """Merge adjacent block pairs (exactly), halving the count."""
        n = len(self._counts)
        counts, means, m2s, mins, maxs = [], [], [], [], []
        with np.errstate(invalid="ignore"):
            for i in range(0, n - 1, 2):
                c, mu, m2 = welford_merge(
                    (float(self._counts[i]), self._means[i], self._m2s[i]),
                    (float(self._counts[i + 1]), self._means[i + 1],
                     self._m2s[i + 1]))
                counts.append(int(c))
                means.append(mu)
                m2s.append(m2)
                mins.append(np.fmin(self._mins[i], self._mins[i + 1]))
                maxs.append(np.fmax(self._maxs[i], self._maxs[i + 1]))
        if n % 2:
            counts.append(self._counts[-1])
            means.append(self._means[-1])
            m2s.append(self._m2s[-1])
            mins.append(self._mins[-1])
            maxs.append(self._maxs[-1])
        self._counts, self._means, self._m2s = counts, means, m2s
        self._mins, self._maxs = mins, maxs

    def append_samples(self, block):
        """Fold a ``(steps, nchains, ndim)`` emission already on the host
        into one block entry (HMC's theta chains)."""
        b = np.asarray(block, dtype=np.float64)
        if b.ndim != 3 or b.shape[0] == 0:
            return
        mean = b.mean(axis=0)
        m2 = ((b - mean[None]) ** 2).sum(axis=0)
        self.append_block(b.shape[0], mean, m2, b.min(axis=0),
                          b.max(axis=0))

    # -------------------------- diagnostics ------------------------ #
    def _start(self, burn_frac):
        """Index of the first kept block: the earliest blocks whose
        cumulative step count fits inside the burn window are dropped
        (the straddling block is kept)."""
        counts = np.asarray(self._counts)
        burn = int(counts.sum() * float(burn_frac))
        start = int(np.searchsorted(np.cumsum(counts), burn, side="right"))
        return min(start, len(counts) - 1) if len(counts) else 0

    def _merge_range(self, a, b):
        """Merged per-chain Welford state over blocks ``[a, b)``."""
        state = (np.zeros(()), np.zeros((self.nchains, self.ndim)),
                 np.zeros((self.nchains, self.ndim)))
        for i in range(a, b):
            state = welford_merge(
                state, (float(self._counts[i]), self._means[i],
                        self._m2s[i]))
        return state

    def split_rhat(self, burn_frac=STREAM_BURN_FRAC):
        """Per-parameter split-R-hat over the post-burn block suffix,
        split at the block boundary nearest the halfway point. None with
        fewer than two kept blocks (or halves shorter than 2 steps)."""
        start = self._start(burn_frac)
        counts = np.asarray(self._counts[start:], dtype=np.float64)
        if len(counts) < 2:
            return None
        cum = np.cumsum(counts)
        k = int(np.searchsorted(cum, cum[-1] / 2.0, side="left")) + 1
        k = min(max(k, 1), len(counts) - 1)
        n1, mu1, m21 = self._merge_range(start, start + k)
        n2, mu2, m22 = self._merge_range(start + k, len(self._counts))
        n1, n2 = float(n1), float(n2)
        if min(n1, n2) < 2:
            return None
        means = np.concatenate([mu1, mu2], axis=0)     # (2m, d)
        variances = np.concatenate(
            [m21 / (n1 - 1.0), m22 / (n2 - 1.0)], axis=0)
        n = 0.5 * (n1 + n2)
        w = variances.mean(axis=0)
        var_plus = (n - 1.0) / n * w + np.var(means, axis=0, ddof=1)
        with np.errstate(invalid="ignore", divide="ignore"):
            rhat = np.sqrt(var_plus / w)
        return np.where(w > 0, rhat, 1.0)

    def moment_ess(self, burn_frac=STREAM_BURN_FRAC):
        """Per-parameter batch-means ESS over the post-burn block suffix:
        per-block chain means grouped into ~sqrt(blocks) batches, ``ESS =
        m * nbatch * var_plus / var(batch means)``. None below 4 kept
        blocks. Over-reads while batches are shorter than the
        autocorrelation time: a gate on it must confirm exactly."""
        start = self._start(burn_frac)
        nb_blocks = len(self._counts) - start
        if nb_blocks < 4:
            return None
        counts = np.asarray(self._counts[start:], dtype=np.float64)
        means = np.stack(self._means[start:])    # (B, m, d)
        nbatch = max(2, int(nb_blocks ** 0.5))
        groups = np.array_split(np.arange(nb_blocks), nbatch)
        batch_means = []
        for g in groups:
            wsum = counts[g].sum()
            batch_means.append(
                np.tensordot(counts[g], means[g], axes=(0, 0)) / wsum)
        bm = np.stack(batch_means)               # (nbatch, m, d)
        bm = bm.reshape(nbatch * self.nchains, self.ndim)
        _, mu, var = welford_finalize(
            self._merge_range(start, len(self._counts)))
        w = np.nan_to_num(var, nan=0.0).mean(axis=0)
        n_per_chain = counts.sum()
        var_plus = (n_per_chain - 1.0) / n_per_chain * w
        if self.nchains > 1:
            var_plus = var_plus + np.var(mu, axis=0, ddof=1)
        var_bm = np.var(bm, axis=0, ddof=1)
        total = self.nchains * n_per_chain
        with np.errstate(invalid="ignore", divide="ignore"):
            ess = self.nchains * nbatch * var_plus / var_bm
        ess = np.where(var_bm > 0, ess, total)
        return np.minimum(np.maximum(ess, 0.0), total)

    def worst(self, burn_frac=STREAM_BURN_FRAC, summary=None):
        """The heartbeat figure ``{"rhat": max, "ess": min, "steps":
        kept}`` over the post-burn window, or None when the ledger is too
        short; non-finite estimates become None (strict JSON). A
        :meth:`param_summary` of the same ``burn_frac`` may be passed to
        reuse its estimates."""
        if summary is not None:
            rhat, ess = summary.get("rhat"), summary.get("ess")
        else:
            rhat = self.split_rhat(burn_frac)
            ess = self.moment_ess(burn_frac)
        if rhat is None and ess is None:
            return None
        start = self._start(burn_frac)
        kept = int(sum(self._counts[start:]))
        rh = float(np.max(rhat)) if rhat is not None else None
        es = float(np.min(ess)) if ess is not None else None
        return {
            "rhat": rh if rh is not None and np.isfinite(rh) else None,
            "ess": es if es is not None and np.isfinite(es) else None,
            "steps": kept,
        }

    def param_summary(self, burn_frac=STREAM_BURN_FRAC):
        """Per-parameter table for ``mixing_stats.json``: ``mean``,
        ``std`` (pooled over chains), ``min``, ``max``, ``rhat``, ``ess``
        over the post-burn window."""
        if not self._counts:
            return None
        start = self._start(burn_frac)
        _, mu, var = welford_finalize(
            self._merge_range(start, len(self._counts)))
        mins = np.stack(self._mins[start:])
        maxs = np.stack(self._maxs[start:])
        with np.errstate(invalid="ignore"):
            mn = np.nanmin(mins, axis=(0, 1))
            mx = np.nanmax(maxs, axis=(0, 1))
        return {
            "mean": mu.mean(axis=0),
            "std": np.sqrt(np.maximum(
                np.nan_to_num(var, nan=0.0).mean(axis=0), 0.0)),
            "min": mn,
            "max": mx,
            "rhat": self.split_rhat(burn_frac),
            "ess": self.moment_ess(burn_frac),
        }

    # -------------------------- persistence ------------------------ #
    def state_dict(self):
        """Flat arrays for ``np.savez`` (copies)."""
        shape = (0, self.nchains, self.ndim)
        if not self._counts:
            z = np.zeros(shape)
            return {"counts": np.zeros(0, dtype=np.int64), "mean": z,
                    "m2": z.copy(), "min": z.copy(), "max": z.copy()}
        return {
            "counts": np.asarray(self._counts, dtype=np.int64),
            "mean": np.stack(self._means),
            "m2": np.stack(self._m2s),
            "min": np.stack(self._mins),
            "max": np.stack(self._maxs),
        }

    @classmethod
    def from_state(cls, nchains, ndim, state):
        """A ledger from :meth:`state_dict` arrays; a checkpoint of
        another chain geometry gives a fresh ledger."""
        led = cls(nchains, ndim)
        counts = np.asarray(state.get("counts", ()), dtype=np.int64)
        mean = np.asarray(state.get("mean", ()))
        if counts.size == 0 or mean.ndim != 3 \
                or mean.shape[1:] != (led.nchains, led.ndim) \
                or mean.shape[0] != counts.size:
            return led
        m2 = np.asarray(state["m2"])
        mn = np.asarray(state["min"])
        mx = np.asarray(state["max"])
        for i in range(counts.size):
            led.append_block(counts[i], mean[i], m2[i], mn[i], mx[i])
        return led


# ------------------------------------------------------------------ #
#  the mesh plane                                                     #
# ------------------------------------------------------------------ #

#: the collective's cost-model coefficient: FLOP-equivalents charged per
#: byte of the packed sum's payload when the block wall is split into
#: local, collective and stage-3 shares. A model knob, not a measurement
#: (``EWT_MESH_COLL_FPB`` overrides it; every payload names the basis).
DEFAULT_COLL_FLOP_PER_BYTE = 32.0


def mesh_enabled() -> bool:
    """Whether the mesh plane is armed: under ``EWT_TELEMETRY`` (the
    master switch), with ``EWT_MESH_STATS=0`` as the plane's own."""
    return telemetry.enabled() \
        and os.environ.get("EWT_MESH_STATS", "1") != "0"


class MeshStatsLedger:
    """Host-side fold of the per-shard attribution lanes that ride the
    sharded evaluation's packed sum (``parallel/pta.py:MESH_ATTR_WIDTH``
    lanes a shard: evaluations, active TOAs, jitter-engaged and
    refine-diverged pulsars) and the static cost model's wall split.

    Built from ``like.mesh_layout``. Per block, :meth:`fold` takes the
    block's ``(nshard, attr_width)`` table and its measured wall and
    returns the gauges: ``shard_skew`` (max over mean of the work lane;
    1.0 is balanced), ``collective_wall_ms`` (the wall times the model's
    collective share ``C_coll / (max C12 + C3 + C_coll)``, ``C_coll`` the
    payload bytes times ``EWT_MESH_COLL_FPB``: an attribution of the
    measured wall, not a second timer), ``straggler_index`` and
    ``straggler_host`` (the shard with the most work and its process).
    Numpy only, at block cadence."""

    def __init__(self, layout):
        self.layout = dict(layout)
        self.nshard = int(layout["nshard"])
        self.attr_width = int(layout.get("attr_width", 4))
        self._attr = np.zeros((self.nshard, self.attr_width))
        self._wall_s = 0.0
        self._blocks = 0
        self._straggler_hits = np.zeros(self.nshard, dtype=np.int64)
        self._procs = [int(p) for p in layout.get(
            "shard_process", [0] * self.nshard)][:self.nshard]
        f12 = np.asarray(layout.get("flops_stage12_per_shard",
                                    [1.0] * self.nshard), dtype=np.float64)
        f3 = float(layout.get("flops_stage3", 0.0))
        self.coll_flop_per_byte = float(os.environ.get(
            "EWT_MESH_COLL_FPB", DEFAULT_COLL_FLOP_PER_BYTE))
        c_coll = (float(layout.get("psum_payload_bytes", 0))
                  * self.coll_flop_per_byte)
        crit = max(float(f12.max(initial=0.0)) + f3 + c_coll, 1.0)
        self.frac_coll = c_coll / crit
        self.frac_stage3 = f3 / crit
        self.frac_local = float(f12.max(initial=0.0)) / crit
        #: the imbalance the cost model predicts from the shard geometry
        self.model_skew = float(f12.max(initial=0.0)) \
            / max(float(f12.mean()), 1.0)

    @staticmethod
    def _skew(work):
        mean = float(work.mean())
        if mean <= 0.0:
            return 1.0
        return float(work.max(initial=0.0)) / mean

    def _host(self, shard):
        return self._procs[shard] if shard < len(self._procs) else 0

    def fold(self, attr, wall_s):
        """Fold one block's table and measured wall; returns the block's
        gauges."""
        attr = np.asarray(attr, dtype=np.float64).reshape(
            self.nshard, self.attr_width)
        wall_s = max(float(wall_s), 0.0)
        self._attr += attr
        self._wall_s += wall_s
        self._blocks += 1
        work = attr[:, 1]
        straggler = int(np.argmax(work))
        self._straggler_hits[straggler] += 1
        return {"shard_skew": self._skew(work),
                "collective_wall_ms": wall_s * 1e3 * self.frac_coll,
                "straggler_index": straggler,
                "straggler_host": self._host(straggler)}

    def snapshot(self):
        """The run-cumulative payload of the ``mesh_stats`` event and the
        sidecar."""
        work = self._attr[:, 1]
        straggler = int(np.argmax(work)) if self.nshard else 0
        wall_ms = self._wall_s * 1e3
        return {
            "nshard": self.nshard,
            "blocks": int(self._blocks),
            "shard_evals": [float(v) for v in self._attr[:, 0]],
            "shard_work": [float(v) for v in work],
            "shard_jitter": [float(v) for v in self._attr[:, 2]],
            "shard_diverged": [float(v) for v in self._attr[:, 3]],
            "shard_process": list(self._procs),
            "straggler_hits": [int(v) for v in self._straggler_hits],
            "shard_skew": self._skew(work),
            "model_skew": self.model_skew,
            "straggler_index": straggler,
            "straggler_host": self._host(straggler),
            "wall_ms": wall_ms,
            "collective_wall_ms": wall_ms * self.frac_coll,
            "stage3_wall_ms": wall_ms * self.frac_stage3,
            "local_wall_ms": wall_ms * self.frac_local,
            "collective_frac_model": self.frac_coll,
            "coll_flop_per_byte": self.coll_flop_per_byte,
            "cost_basis": self.layout.get("cost_basis",
                                          "static_cost_model"),
        }


def write_mesh_stats(run_dir, payload):
    """The mesh plane's sidecar: ``mesh_stats.json`` on the primary,
    ``mesh_stats.<process_index>.json`` on every other process (each owns
    its path: ``primary_only(telemetry_ok=True)``). Returns the path."""
    from ..parallel.distributed import primary_only, process_index

    @primary_only(telemetry_ok=True)
    def _write():
        import json
        idx = process_index()
        name = "mesh_stats.json" if idx == 0 else f"mesh_stats.{idx}.json"
        path = os.path.join(run_dir, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(payload, fh, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    return _write()
