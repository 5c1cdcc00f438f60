"""The noise reconstruction on the card against the CPU and a long-double
witness, draw by draw.

    python -m enterprise_warp_tpu_torch.bench.recon_witness \\
        [--nsamp 600] [--draws 1000] [--witness 20] [--out FILE]

Runs ``system_noise.dat --num 0`` through the CLI on the card for
``--nsamp`` PT steps (``chip_smoke.write_paramfile``'s copy, seed 0),
takes ``--draws`` draws of its chain as ``chip_smoke.recon_check`` does,
and reconstructs every draw with ``NoiseReconstructor.realizations_batch``
on the card and on the CPU (both float64). Per draw and realization it
prints the card-against-CPU gap (``max |card - CPU| / max |CPU|``, the
smoke's measure) and the condition number of the equilibrated system
``Sigma = T^T N^-1 T + diag(1/b)``. For the ``--witness`` draws with the
largest gap and as many drawn at random, it forms the same system from
the same float64 inputs in numpy long double (64-bit mantissa, unit
roundoff 5.4e-20), solves it by Cholesky, and measures both devices
against that witness: the gap each float64 implementation leaves,
beside ``cond * 2^-53``. The last line is a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
U64 = 2.0 ** -53


def _closure(fn):
    """The closure cells of ``fn`` by name."""
    return {n: c.cell_contents for n, c in
            zip(fn.__code__.co_freevars, fn.__closure__)}


def _chol_solve_ld(A, b):
    """``A x = b`` for a symmetric positive-definite long-double ``A`` by
    a Cholesky factor in long double."""
    n = A.shape[0]
    L = np.zeros_like(A)
    for j in range(n):
        d = A[j, j] - L[j, :j] @ L[j, :j]
        L[j, j] = np.sqrt(d)
        L[j + 1:, j] = (A[j + 1:, j] - L[j + 1:, :j] @ L[j, :j]) / L[j, j]
    y = np.zeros_like(b)
    for i in range(n):
        y[i] = (b[i] - L[i, :i] @ y[:i]) / L[i, i]
    x = np.zeros_like(b)
    for i in reversed(range(n)):
        x[i] = (y[i] - L[i + 1:, i] @ x[i + 1:]) / L[i, i]
    return x


def _system(rec, theta):
    """``(Sigma, rhs, parts)`` of one draw in long double, from the CPU
    reconstructor's own float64 inputs (``nw``, ``phi`` as it evaluates
    them); ``parts`` maps each realization to ``(scale, basis, slice)``."""
    import torch
    cl = _closure(rec._realize)
    g = rec._realize.__globals__
    if cl["det_refs"] is not None:
        raise SystemExit("the witness covers models without sampled "
                         "deterministic terms")
    th = torch.as_tensor(theta[None], dtype=torch.float64)
    nw = g["eval_nw"](th, cl["wb"], cl["ntoa"], cl["sigma2"])[0].numpy()
    phi = g["eval_phi"](th, cl["bb"], cl["cs2_t"])[0].numpy()
    ld = np.longdouble
    b = np.concatenate([phi, np.full(cl["ntm"], g["_TM_PHI"])]).astype(ld)
    sw = np.sqrt(ld(1.0) / nw.astype(ld))
    Ts = cl["T_full"].numpy().astype(ld) * sw[:, None]
    rs = cl["r_w_t"].numpy().astype(ld) * sw
    Sigma = Ts.T @ Ts + np.diag(ld(1.0) / b)
    rhs = Ts.T @ rs
    return Sigma, rhs, cl


def _realize_ld(rec, cl, a):
    """The realizations of coefficient vector ``a`` in long double."""
    sigma = cl["sigma_t"].numpy().astype(np.longdouble)
    Tw = cl["T_w_t"].numpy().astype(np.longdouble)
    out = {name: sigma * (Tw[:, sl] @ a[sl])
           for name, sl in zip(rec.block_names, rec._slices)}
    out["tm"] = sigma * (cl["M_w_t"].numpy().astype(np.longdouble)
                         @ a[cl["nb"]:])
    return out


def _gap(x, ref):
    return float(np.max(np.abs(x - ref)) / max(np.max(np.abs(ref)),
                                               1e-300))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nsamp", type=int, default=600)
    ap.add_argument("--draws", type=int, default=1000)
    ap.add_argument("--witness", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="cpu only to rehearse the script")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import types

    import chip_smoke as cs
    from enterprise_warp_tpu_torch import cli
    from enterprise_warp_tpu_torch.config import Params
    from enterprise_warp_tpu_torch.models.assemble import \
        build_terms_for_model
    from enterprise_warp_tpu_torch.results.reconstruct import \
        NoiseReconstructor

    print(cs.nvidia_smi_line() if a.device == "cuda" else "cpu",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        pf = cs.write_paramfile(tmp, "system_noise.dat", nsamp=a.nsamp)
        if cli.main(["--prfile", pf, "--num", "0"], device=a.device) != 0:
            raise SystemExit("the PT run failed")
        run = [r for r, _, fs in os.walk(os.path.join(tmp, "out"))
               if "chain_1.txt" in fs][0]
        chain = np.loadtxt(os.path.join(run, "chain_1.txt"))
        opts = types.SimpleNamespace(num=0, drop=0, mpi_regime=2,
                                     wipe_old_output=0,
                                     extra_model_terms=None)
        params = Params(pf, opts=opts)
    psr = params.psrs[0]
    terms = build_terms_for_model(params.models[min(params.models)], [psr],
                                  params.noise_model_obj)[0]
    recs = {d: NoiseReconstructor(psr, terms, device=d)
            for d in (a.device, "cpu")}
    nd = len(recs["cpu"].param_names)
    post = chain[len(chain) // 4:, :nd]
    th = post[np.random.default_rng(0).choice(
        len(post), a.draws, replace=len(post) < a.draws)]
    out = {"card": recs[a.device].realizations_batch(th),
           "cpu": recs["cpu"].realizations_batch(th)}
    names = list(out["cpu"])
    # per draw and realization: the smoke's card-against-CPU gap
    gaps = np.stack([np.max(np.abs(out["card"][k] - out["cpu"][k]), axis=1)
                     / np.maximum(np.max(np.abs(out["cpu"][k]), axis=1),
                                  1e-300) for k in names], axis=1)
    worst = np.max(gaps, axis=1)
    # the total (every realization summed) is what the data constrain
    tot = {d: sum(out[d][k] for k in names) for d in out}
    tot_gap = (np.max(np.abs(tot["card"] - tot["cpu"]), axis=1)
               / np.max(np.abs(tot["cpu"]), axis=1))
    print(f"{a.draws} draws of the {a.nsamp}-step chain: card against CPU, "
          f"max over draws per realization "
          f"{dict(zip(names, np.max(gaps, axis=0).round(13).tolist()))}; "
          f"the sum of all {float(np.max(tot_gap)):.3e}", flush=True)
    rng = np.random.default_rng(1)
    pick = list(np.argsort(worst)[::-1][:a.witness])
    rest = [i for i in range(a.draws) if i not in pick]
    pick += list(rng.choice(rest, min(a.witness, len(rest)), replace=False))
    rows = []
    for i in pick:
        Sigma, rhs, cl = _system(recs["cpu"], th[i])
        d = 1.0 / np.sqrt(np.diag(Sigma))
        eq = (Sigma * d[:, None] * d[None, :]).astype(np.float64)
        ev = np.linalg.eigvalsh(eq)
        cond = float(ev[-1] / ev[0]) if ev[0] > 0 else float("inf")
        aw = _chol_solve_ld(Sigma, rhs)
        wit = _realize_ld(recs["cpu"], cl, aw)
        row = dict(draw=int(i), worst=bool(len(rows) < a.witness),
                   cond=cond, cond_u=cond * U64,
                   card_cpu=float(worst[i]), sum_card_cpu=float(tot_gap[i]))
        for dev in ("card", "cpu"):
            row[f"{dev}_witness"] = max(
                _gap(out[dev][k][i], wit[k]) for k in names)
            row[f"sum_{dev}_witness"] = _gap(
                tot[dev][i], sum(wit[k] for k in names))
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = dict(
        draws=a.draws, nsamp=a.nsamp, names=names,
        card_cpu_max=float(np.max(worst)),
        sum_card_cpu_max=float(np.max(tot_gap)),
        witnessed=len(rows),
        card_witness_max=max(r["card_witness"] for r in rows),
        cpu_witness_max=max(r["cpu_witness"] for r in rows),
        cond_u_at_worst=rows[0]["cond_u"],
        cond_max=max(r["cond"] for r in rows),
        gap_over_cond_u_max=max(r["card_cpu"] / r["cond_u"] for r in rows),
        sum_witness_max=max(max(r["sum_card_witness"],
                                r["sum_cpu_witness"]) for r in rows))
    line = json.dumps({"recon_witness": summary})
    print(line, flush=True)
    if a.out:
        with open(a.out, "w") as fh:
            fh.write("\n".join(json.dumps(r) for r in rows) + "\n" + line
                     + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
