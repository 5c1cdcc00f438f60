"""GP noise reconstruction: the tempo2 ``general2`` bridge, natively.

Counterpart of ``enterprise_warp_tpu/results/reconstruct.py``. The
original shells out to tempo2 for maximum-likelihood noise realizations,
scraping the ``general2`` columns ``bat post posttn tndm tnrn``
(barycentric arrival time, post-fit residual, the residual minus the red
and DM realizations, and the two realizations). Here they are the
conditional mean of the rank-reduced GP at a hyperparameter point, from
the likelihood's own design matrices:

    a_hat = Sigma^-1 T^T N^-1 r,   Sigma = Phi^-1 + T^T N^-1 T

with the timing model among ``T``'s columns at prior variance
``_TM_PHI``; each process's realization is its block of columns times its
block of ``a_hat`` (a sampled chromatic index scales its block's columns
per draw, ``models/build.py:eval_T``). ``Sigma`` is factored equilibrated to a unit diagonal
(``equilibrated_cholesky``), then solved with the scales, as the
reference does. Float64 torch, on the card unless the caller asks for
the CPU; the reference ``vmap``s over draws, here the draws are one
batch, ``RECON_CHUNK`` at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import F64, constants as const, resolve_device
from ..models.build import (_resolve_params, basis_static, collect_params,
                            eval_T, eval_nw, eval_phi, lower_det_terms,
                            lower_terms, param_value, white_static)
from ..ops.kernel import equilibrated_cholesky, whiten_inputs
from ..parallel.pta import _TM_PHI

# draws per batch: a draw's whitened basis takes (ntoa, nbasis) float64,
# 0.7 MB at J1234-5678 (334 TOAs, 258 columns), so 128 draws hold 88 MB
RECON_CHUNK = 128


class NoiseReconstructor:
    """Conditional-mean reconstruction for one pulsar.

    ``realizations(theta)`` returns ``{signal_name: (ntoa,) seconds}``,
    with the refit timing-model adjustment under ``"tm"`` and each
    sampled-coefficient deterministic delay (``bayes_ephem: sampled``)
    under its term's name; ``realizations_batch`` takes (D, ndim) draws
    and returns (D, ntoa) arrays.
    """

    def __init__(self, psr, terms, fixed_values=None, ecorr_dt=10.0,
                 device="cuda"):
        self.psr = psr
        self.device = dev = resolve_device(device)
        ntoa = len(psr)
        sigma = np.asarray(psr.toaerrs, dtype=np.float64)

        det_terms = []
        white_blocks, basis_blocks, T_all = lower_terms(
            psr, terms, ecorr_dt=ecorr_dt, det_out=det_terms)
        r_w, M_w, T_w, cs2, _ = whiten_inputs(psr.residuals, sigma,
                                              psr.Mmat, T_all)
        self.params, mapping = _resolve_params(
            collect_params(white_blocks, basis_blocks), fixed_values)
        # sampled-coefficient delays: the realization is D c, and the GP
        # conditions on the delay-subtracted residuals; the shared
        # lowering keeps the likelihood's (pars.txt) parameter order
        D_w, det_refs = lower_det_terms(det_terms, sigma, self.params,
                                        mapping)
        self.param_names = [p.name for p in self.params]
        self.block_names = [bb.name for bb in basis_blocks]
        self._slices = [bb.col_slice for bb in basis_blocks]
        det_names, det_slices, c0 = [], [], 0
        for t in det_terms:
            det_names.append(t.name)
            det_slices.append(slice(c0, c0 + t.D.shape[1]))
            c0 += t.D.shape[1]

        def put(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64),
                                   dtype=F64, device=dev)

        wb = white_static(white_blocks, mapping, dev)
        bb = basis_static(basis_blocks, mapping, dev)
        sigma_t, sigma2 = put(sigma), put(sigma ** 2)
        r_w_t, M_w_t, T_w_t, cs2_t = put(r_w), put(M_w), put(T_w), put(cs2)
        ntm, nb = M_w.shape[1], T_w.shape[1]
        D_w_t = None if D_w is None else put(D_w)
        D_phys = None if D_w is None else put(np.concatenate(
            [np.asarray(t.D, dtype=np.float64) for t in det_terms], axis=1))

        def realize(theta):
            """(D, ndim) draws -> {name: (D, ntoa)}."""
            nw = eval_nw(theta, wb, ntoa, sigma2)
            phi = eval_phi(theta, bb, cs2_t)
            # the basis at each draw: (D, ntoa, nb) where a sampled
            # chromatic index scales its block, else the static one
            T_mat = eval_T(theta, bb, T_w_t)
            T_full = torch.cat([T_mat, M_w_t.expand(T_mat.shape[:-1]
                                                    + (ntm,))], dim=-1)
            r_eff = r_w_t.expand(theta.shape[0], ntoa)
            c = None
            if det_refs is not None:
                c = torch.stack([param_value(theta, rf) for rf in det_refs],
                                dim=-1)
                r_eff = r_eff - c @ D_w_t.T
            b = torch.cat([phi, torch.full((theta.shape[0], ntm), _TM_PHI,
                                           dtype=F64, device=dev)], dim=-1)
            sw = torch.sqrt(1.0 / nw)
            Ts = T_full * sw[..., None]
            rs = r_eff * sw
            Sigma = Ts.mT @ Ts + torch.diag_embed(1.0 / b)
            L, s, _ = equilibrated_cholesky(Sigma, 0.0)
            rhs = s * (Ts.mT @ rs[..., None])[..., 0]
            u = torch.linalg.solve_triangular(L, rhs[..., None], upper=False)
            a_hat = s * torch.linalg.solve_triangular(L.mT, u,
                                                      upper=True)[..., 0]
            out = {}
            for name, sl in zip(self.block_names, self._slices):
                out[name] = sigma_t * (T_mat[..., sl]
                                       @ a_hat[:, sl, None])[..., 0]
            out["tm"] = sigma_t * (a_hat[:, nb:] @ M_w_t.T)
            for name, sl in zip(det_names, det_slices):
                out[name] = c[:, sl] @ D_phys[:, sl].T
            return out

        self._realize = realize

    # -------------------------------------------------------------- #
    def theta_from_dict(self, values: dict) -> np.ndarray:
        """Parameter vector from a (PAL2 noisefile style) name -> value
        dict; raises on missing sampled parameters."""
        missing = [n for n in self.param_names if n not in values]
        if missing:
            raise KeyError(
                f"reconstruction values missing parameters: {missing}")
        return np.asarray([float(values[n]) for n in self.param_names])

    def realizations(self, theta) -> dict:
        if isinstance(theta, dict):
            theta = self.theta_from_dict(theta)
        out = self.realizations_batch(np.asarray(theta)[None])
        return {k: v[0] for k, v in out.items()}

    def realizations_batch(self, thetas) -> dict:
        thetas = np.asarray(thetas, dtype=np.float64).reshape(
            -1, max(len(self.param_names), 1))
        parts = []
        for i in range(0, len(thetas), RECON_CHUNK):
            th = torch.as_tensor(thetas[i:i + RECON_CHUNK], dtype=F64,
                                 device=self.device)
            parts.append({k: v.cpu().numpy()
                          for k, v in self._realize(th).items()})
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _match(real: dict, *needles):
    tot = None
    for name, r in real.items():
        if any(n in name for n in needles):
            tot = r if tot is None else tot + r
    return tot if tot is not None else 0.0


def get_tempo2_prediction(parfile, timfile, noise_dict, output=None,
                          custom_models_obj=None, device="cuda"):
    """The reference's tempo2 bridge, natively: the white + red + DM model
    at fixed noisefile values, as the ``general2`` column contract ``bat
    post posttn tndm tnrn`` (seconds; bat in MJD), written to ``output``
    where given. Returns ``(columns, output)``, ``columns`` (ntoa, 5)."""
    from ..io import load_pulsar
    from ..models.standard import StandardModels
    from ..models.terms import TermList

    psr = load_pulsar(parfile, timfile)
    cls = custom_models_obj or StandardModels
    m = cls(psr=psr)
    terms = TermList(psr, [m.efac("by_backend"), m.equad("by_backend"),
                           m.spin_noise("powerlaw_30_nfreqs"),
                           m.dm_noise("powerlaw_30_nfreqs")])
    rec = NoiseReconstructor(psr, terms, device=device)

    # PAL2 noisefile -> parameter vector; unmatched parameters take a
    # no-noise value, so partial noisefiles still reconstruct
    defaults = {}
    for n in rec.param_names:
        if n.endswith("efac"):
            defaults[n] = 1.0
        elif "log10_equad" in n or "log10_A" in n:
            defaults[n] = -20.0
        elif n.endswith("gamma"):
            defaults[n] = 3.0
    unused = [k for k in noise_dict
              if k not in rec.param_names and psr.name in k]
    if unused:
        from ..utils.logging import get_logger
        get_logger("ewt.results").warning(
            "noisefile entries outside the reconstruction model "
            "(efac/equad/red/DM) are ignored: %s", unused)
    defaults.update(noise_dict)
    real = rec.realizations(rec.theta_from_dict(defaults))

    tnrn = np.asarray(_match(real, "red_noise"))
    tndm = np.asarray(_match(real, "dm_gp"))
    post = psr.residuals
    posttn = post - tnrn - tndm
    bat = psr.toas / const.day
    cols = np.stack([bat, post, posttn, tndm, tnrn], axis=1)
    if output:
        np.savetxt(output, cols, header="bat post posttn tndm tnrn")
    return cols, output
