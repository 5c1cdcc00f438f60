# ewt: allow-precision module — the cached evaluation's theta and lnL parts
# are float64 sampler state
"""The evaluation protocol of a likelihood, and the update_mask contract
of a block-structured one.

Counterpart of ``enterprise_warp_tpu/samplers/evalproto.py``.
:func:`eval_protocol` returns ``(batch_fn(thetas), single_fn(theta),
())`` for any likelihood object, from its ``loglike_batch``. The empty
tuple stands where the reference's consts are: the port closes over its
device arrays instead of passing them as jit arguments, so no class
installs a separate evaluation (the reference's ``install_protocol``).

A likelihood whose evaluation decomposes into per-pulsar
blocks plus a common coupling (the joint PTA Schur path,
``parallel/pta.py``) installs, through :func:`install_masked_protocol`,

    like.param_blocks                      (ndim,) block id per parameter
    like._cache_init(theta)            -> (lnl, cache)
    like._cache_site(theta, a, cache)  -> (lnl, cache)
    like._cache_common(theta, cache)   -> (lnl, cache)

with ``theta`` one parameter vector (ndim,) and ``cache`` a dict of
tensors holding every per-pulsar stage result. The update functions
build new tensors and never write into a cached one, so a cache that
was handed out stays valid. A caller that knows which block a proposal
touched declares it with an **update_mask**:

    None          full recompute (always correct)
    ("psr", a)    only pulsar ``a``'s parameters changed
    ("common",)   only coupling-only common parameters (the GW block)

Block ids in ``param_blocks``: ``>= 0`` the owning pulsar;
``BLOCK_COMMON`` coupling-only common parameters; ``BLOCK_GLOBAL``
parameters that touch more than one block, never maskable.
:class:`CachedEvaluator` runs it from the host: it checks every
declared mask against the actual change of theta (a stale mask raises)
and counts the updates by class.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import F64

BLOCK_COMMON = -1     # coupling-only common parameters (the GW block)
BLOCK_GLOBAL = -2     # touches more than one block: never maskable


def eval_protocol(like):
    """``(batch_fn(thetas), single_fn(theta), ())`` for any likelihood
    object with a ``loglike_batch``."""
    def single(theta):
        if torch.is_tensor(theta):
            return like.loglike_batch(theta[None])[0]
        return like.loglike_batch(
            np.asarray(theta, dtype=np.float64)[None])[0]

    return like.loglike_batch, single, ()


def install_masked_protocol(like, init_fn, site_fn, common_fn,
                            param_blocks):
    """Install the update_mask contract on ``like`` from the three cache
    functions (each returning ``(lnl, cache)``) and the block id of every
    parameter."""
    like.param_blocks = np.asarray(param_blocks, dtype=np.int64)
    like._cache_init = init_fn
    like._cache_site = site_fn
    like._cache_common = common_fn
    return like


def derive_update_mask(param_blocks, theta_prev, theta_new):
    """The narrowest correct update_mask for a change of theta:
    ``("psr", a)``, ``("common",)`` or ``None`` (a full recompute is
    needed, or nothing changed)."""
    changed = np.nonzero(np.asarray(theta_prev) != np.asarray(theta_new))[0]
    if len(changed) == 0:
        return None
    blocks = set(int(b) for b in np.asarray(param_blocks)[changed])
    if blocks == {BLOCK_COMMON}:
        return ("common",)
    if len(blocks) == 1:
        (b,) = blocks
        if b >= 0:
            return ("psr", b)
    return None


class CachedEvaluator:
    """The update_mask contract, run from the host.

    Holds ``(theta, cache, lnl)`` across evaluations, sends each update
    to the cheapest correct cache function, raises ``ValueError`` on a
    mask that the change of theta does not stay inside, and counts the
    updates::

        ev = CachedEvaluator(like, theta0)
        lnl = ev.update(theta1, ("psr", 3))     # one pulsar's block
        ev.reject()                              # back to theta0
        lnl = ev.update(theta2, "auto")         # mask from the change
        lnl = ev.update(theta3)                 # full recompute
        ev.counters                              # {"site": ..., ...}

    ``reject`` restores the previous ``(theta, cache, lnl)`` by
    reference, one level deep, as a Metropolis-Hastings rejection needs.
    """

    def __init__(self, like, theta0=None):
        if not hasattr(like, "_cache_init"):
            raise TypeError(
                "likelihood does not implement the update_mask contract "
                "(no masked protocol installed; see samplers/evalproto.py)")
        self.like = like
        self.param_blocks = np.asarray(like.param_blocks)
        self.counters = {"site": 0, "common": 0, "full": 0, "rejected": 0}
        self.theta = None
        self._cache = None
        self.lnl = None
        self._prev = None
        if theta0 is not None:
            self.reset(theta0)

    # ewt: allow-host-sync — the cached evaluator is host-driven: each call
    # uploads its theta
    def _tensor(self, theta):
        return torch.as_tensor(theta, dtype=F64, device=self.like.device)

    def reset(self, theta):
        """Full recompute: (re)build the cache at ``theta``."""
        theta = np.array(theta, dtype=np.float64)
        if self.theta is not None:
            self._prev = (self.theta, self._cache, self.lnl)
        lnl, self._cache = self.like._cache_init(self._tensor(theta))
        self.theta = theta
        self.lnl = float(lnl)
        return self.lnl

    def reject(self):
        """Revert the last ``update``/``reset`` with no recompute."""
        if self._prev is None:
            raise RuntimeError(
                "CachedEvaluator.reject with no update to revert "
                "(each update can be rejected once)")
        self.theta, self._cache, self.lnl = self._prev
        self._prev = None
        self.counters["rejected"] += 1
        return self.lnl

    def _validate(self, theta, update_mask):
        changed = np.nonzero(self.theta != theta)[0]
        blocks = set(int(b) for b in self.param_blocks[changed])
        if update_mask[0] == "psr":
            allowed = {int(update_mask[1])}
        else:
            allowed = {BLOCK_COMMON}
        if not blocks <= allowed:
            raise ValueError(
                f"stale update_mask {update_mask!r}: the theta "
                f"transition touches parameter blocks {sorted(blocks)} "
                f"(param indices {changed.tolist()}) outside the "
                "declared block; a masked evaluation here would reuse "
                "invalidated cached factorizations")

    def update(self, theta, update_mask=None):
        """lnL at ``theta`` given what the proposal declared it touched:
        ``None`` (full), ``("psr", a)``, ``("common",)`` or ``"auto"``
        (the narrowest correct mask, derived from the change of
        theta)."""
        if self.theta is None:
            raise RuntimeError("CachedEvaluator.update before reset: no "
                               "cache to update")
        theta = np.array(theta, dtype=np.float64)
        if update_mask == "auto":
            update_mask = derive_update_mask(self.param_blocks,
                                             self.theta, theta)
        if update_mask is None:
            self.counters["full"] += 1
            return self.reset(theta)
        self._validate(theta, update_mask)
        self._prev = (self.theta, self._cache, self.lnl)
        if update_mask[0] == "psr":
            lnl, self._cache = self.like._cache_site(
                self._tensor(theta), int(update_mask[1]), self._cache)
            self.counters["site"] += 1
        else:
            lnl, self._cache = self.like._cache_common(self._tensor(theta),
                                                       self._cache)
            self.counters["common"] += 1
        self.theta = theta
        self.lnl = float(lnl)
        return self.lnl

    @property
    def cache_hit_rate(self):
        """Fraction of evaluations that reused cached pulsar blocks."""
        n = (self.counters["site"] + self.counters["common"]
             + self.counters["full"])
        if n == 0:
            return 0.0
        return (self.counters["site"] + self.counters["common"]) / n
