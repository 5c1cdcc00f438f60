#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check its kernels.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. environment: torch/CUDA versions and ``nvidia-smi``'s card name and
   power limit;
2. build: every hand-written kernel is compiled from
   ``enterprise_warp_tpu_torch/ops/csrc`` with ``nvcc`` for ``sm_90a``;
3. kernels vs plain versions: each kernel's inputs are captured from the
   two real likelihoods of ``examples/example_params/system_noise.dat``
   (``--num 0``: J1234-5678, nb = 250, the solve kernel; ``--num 1``:
   fake_psr_0, nb = 120, the likelihood kernel) at walker points near the
   injected noise parameters, at the walker count the paramfile's
   sampler uses; each kernel and its plain PyTorch version run on the
   same CUDA tensors (plus the three-tier fixture) and must agree within
   the stated tolerance; both are timed with CUDA events;
4. main path: ``enterprise_warp_tpu_torch.cli.main`` runs both pulsars
   (temporary copies of the paramfile with ``nsamp: 2000``, so that the
   ``covUpdate``=1000 adaptation fires), with the
   launch counters zeroed just before each run and read just after; the
   expected kernel must have launched, and the chain must be finite with
   an acceptance rate in (0, 1);
5. the ``kernels`` JSON line, then the result line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import logging
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "enterprise_warp_tpu_torch"
SOURCE = f"{PKG}/ops/csrc/megakernel.cu"
REPLACES = {
    "mega_solve": "enterprise_warp_tpu/ops/megakernel.py:262",
    "mega_like": "enterprise_warp_tpu/ops/megakernel.py:449",
}
# H100 SXM peaks (NVIDIA data sheet, dense): float32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# the reference probe's tolerance on Z and ld (ops/megakernel.py:823-827)
ATOL = 5e-4
# sampler steps per main-path run: past covUpdate = 1000, so the
# covariance adaptation fires
NSAMP = 2000
# injected noise parameters of the example data (examples/
# example_noisefiles/J1234-5678_noise.json; examples/make_example_data.py
# for fake_psr_0); parameters with no injected value sit mid-prior
TRUTH = {
    "J1234-5678_CPSR2_20CM_efac": 1.1, "J1234-5678_CPSR2_50CM_efac": 1.35,
    "J1234-5678_CASPSR_40CM_efac": 0.95, "J1234-5678_PDFB_10CM_efac": 1.05,
    "J1234-5678_CPSR2_20CM_log10_equad": -6.6,
    "J1234-5678_CPSR2_50CM_log10_equad": -6.2,
    "J1234-5678_CASPSR_40CM_log10_equad": -6.9,
    "J1234-5678_PDFB_10CM_log10_equad": -7.0,
    "J1234-5678_red_noise_log10_A": -13.3,
    "J1234-5678_red_noise_gamma": 3.8,
    "J1234-5678_dm_gp_log10_A": -13.6, "J1234-5678_dm_gp_gamma": 2.9,
    "J0042-0000_efac": 1.0, "J0042-0000_red_noise_log10_A": -12.9,
    "J0042-0000_red_noise_gamma": 3.5,
}


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi exited {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def write_paramfile(tmp, nsamp):
    ex = os.path.join(HERE, "examples")
    with open(os.path.join(ex, "example_params", "system_noise.dat")) as fh:
        src = fh.read()
    out = []
    for line in src.splitlines():
        key = line.split(":")[0].strip()
        if key == "datadir":
            line = f"datadir: {os.path.join(ex, 'data')}"
        elif key == "out":
            line = f"out: {os.path.join(tmp, 'out')}"
        elif key == "nsamp":
            line = f"nsamp: {nsamp}"
        elif key == "noise_model_file":
            line = "noise_model_file: " + os.path.join(
                ex, line.split(":", 1)[1].strip())
        out.append(line)
    path = os.path.join(tmp, "system_noise.dat")
    with open(path, "w") as fh:
        fh.write("\n".join(out) + "\n")
    return path


def near_truth(like, nwalk, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    mid = []
    for p in like.params:
        pr = p.prior
        mid.append(TRUTH.get(p.name, 0.5 * (pr.lo + pr.hi)))
    return np.asarray(mid) + 0.05 * rng.standard_normal((nwalk, like.ndim))


class Capture:
    """Record the inputs the likelihood hands to a kernel wrapper."""

    def __init__(self, mk, name):
        self.mk, self.name, self.args = mk, name, None
        self.orig = getattr(mk, name)

    def __enter__(self):
        def rec(*args):
            self.args = args
            return self.orig(*args)
        setattr(self.mk, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.mk, self.name, self.orig)


def time_cuda(fn, warm=5, reps=50):
    """Median of ``reps`` single-call CUDA-event timings, in ms."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def solve_cost(B, n, k, refine, tiers):
    """(FLOP, bytes) that one solve-kernel launch needs on these inputs,
    counting only the operations the function requires, per walker:
    n^3/3 per Cholesky attempt (a second attempt only for walkers past
    tier 1); n^3/3 for the triangular inverse; n^3/3 for U^T U (triangle
    times triangle, symmetric result); n^3 each for V^T D (triangle times
    full) and (V^T D) V (full times triangle); n^3 for E^2 (symmetric
    result); and 4 n^2 k for each of the (refine + 1) passes — the
    preconditioner solve V (V^T R) (two triangular products, n^2 k each)
    and the residual Sn Z (2 n^2 k)."""
    attempts = sum(1 if t == 1 else 2 for t in tiers)
    flops = (attempts * n ** 3 / 3.0
             + B * (2.0 * n ** 3 / 3.0 + 3.0 * n ** 3
                    + (refine + 1) * 4.0 * n * n * k))
    nbytes = 4.0 * B * (n * n + n * k) + 4.0 * B * (n * k + 2)
    return flops, nbytes


def bound(flops, nbytes):
    t_ops = flops / PEAK_F32_FLOPS
    t_mem = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_mem), ("operations" if t_ops >= t_mem
                                     else "bytes")


def three_tier_fixture(torch, dev):
    """Walker 0 clean; walker 1 indefinite at j1 but PD at j2; walker 2
    hopeless (identity tier) — the reference test's fixture."""
    import numpy as np
    n = 16
    rng = np.random.default_rng(13)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    ev = np.linspace(0.5, 1.5, n)
    ev[0] = -5e-5
    S_mid = (Q * ev) @ Q.T
    A = np.random.default_rng(2).standard_normal((n, n))
    S0 = A @ A.T / n + 0.5 * np.eye(n)
    d = np.sqrt(np.diag(S0))
    S0 = S0 / d[:, None] / d[None, :]
    Sn = np.stack([S0, S_mid, -np.eye(n)]).astype(np.float32)
    Bn = rng.standard_normal((3, n, 2)).astype(np.float32)
    return (torch.as_tensor(Sn, device=dev), torch.as_tensor(Bn, device=dev))


def main():
    if not os.path.isdir(os.path.join(HERE, PKG)):
        print(f"chip_smoke: {PKG}/ not found next to this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {card} "
          f"count {torch.cuda.device_count()}")
    smi = nvidia_smi_line()
    print(f"nvidia-smi: {smi}")

    # ---- phase 2: build --------------------------------------------------
    from enterprise_warp_tpu_torch.ops import cuda_lib
    from enterprise_warp_tpu_torch.ops import megakernel as mk
    t0 = time.perf_counter()
    cuda_lib.load_library()
    print(f"build: {SOURCE} with nvcc for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in cuda_lib.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas[{name}]: {line.strip()}")

    # ---- phase 3: kernels vs plain versions at the main path's shapes ----
    from enterprise_warp_tpu_torch.config import Params
    from enterprise_warp_tpu_torch.models.assemble import \
        init_model_likelihoods
    from enterprise_warp_tpu_torch.samplers.ptmcmc import sampler_options
    import types
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        prfile = write_paramfile(tmp, NSAMP)
        likes, walkers = {}, None
        for num in (0, 1):
            opts = types.SimpleNamespace(num=num, drop=0, mpi_regime=2,
                                         wipe_old_output=0,
                                         extra_model_terms=None)
            params = Params(prfile, opts=opts)
            popts, _ = sampler_options(params)
            walkers = popts["ntemps"] * 8
            likes[num] = init_model_likelihoods(params, write_pars=False,
                                                device=dev)[0]
        with Capture(mk, "mega_solve_logdet") as cap_s:
            lnl0 = likes[0].loglike_batch(near_truth(likes[0], walkers, 0))
        with Capture(mk, "mega_like") as cap_l:
            lnl1 = likes[1].loglike_batch(near_truth(likes[1], walkers, 1))
        if cap_s.args is None or cap_l.args is None:
            fail("the likelihoods did not reach both kernel wrappers")
        if not (torch.isfinite(lnl0).all() and torch.isfinite(lnl1).all()):
            fail("non-finite lnL at the near-truth walkers")
        # the card's route (float32 kernel class) against the float64
        # oracle on the CPU at the same points, within the reference's
        # megakernel tolerance (tests/test_megakernel.py: rtol 1e-3,
        # atol 5e-2)
        for num, lnl in ((0, lnl0), (1, lnl1)):
            opts = types.SimpleNamespace(num=num, drop=0, mpi_regime=2,
                                         wipe_old_output=0,
                                         extra_model_terms=None)
            oracle = init_model_likelihoods(Params(prfile, opts=opts),
                                            gram_mode="f64",
                                            write_pars=False,
                                            device="cpu")[0]
            ref = oracle.loglike_batch(near_truth(oracle, walkers, num))
            gap = (lnl.cpu() - ref).abs()
            print(f"lnL --num {num} on the card vs float64 on the CPU: "
                  f"max|dlnL| {float(gap.max()):.3e} over {walkers} walkers")
            if not bool((gap <= 5e-2 + 1e-3 * ref.abs()).all()):
                fail(f"--num {num}: lnL on the card disagrees with the "
                     "float64 oracle")
        Sn, Bn, j1, j2, refine = cap_s.args
        S32, w, s, ivb, Bl, lj1, lj2, lrefine = cap_l.args
        print(f"shapes: mega_solve Sn {tuple(Sn.shape)} Bn {tuple(Bn.shape)}"
              f"; mega_like S {tuple(S32.shape)} w {tuple(w.shape)} "
              f"Bn {tuple(Bl.shape)}; refine {refine} / {lrefine}")

        checks = {
            "mega_solve": (
                lambda: mk._mega_solve_cuda(Sn, Bn, j1, j2, refine),
                lambda: mk._mega_solve_torch(Sn, Bn, j1, j2, refine)),
            "mega_like": (
                lambda: mk._mega_like_cuda(S32, w, s, ivb, Bl, lj1, lj2,
                                           lrefine),
                lambda: mk._mega_like_torch(S32, w, s, ivb, Bl, lj1, lj2,
                                            lrefine)),
        }
        Sf, Bf = three_tier_fixture(torch, dev)
        Zk, ldk, tk = mk._mega_solve_cuda(Sf, Bf, 1e-6, 1e-3, 2)
        Zp, ldp = mk._mega_solve_torch(Sf, Bf, 1e-6, 1e-3, 2)
        torch.cuda.synchronize()
        tier_err = max(float((Zk - Zp).abs().max()),
                       float((ldk - ldp).abs().max()))
        print(f"three-tier fixture: tiers {tk.tolist()} max|err| "
              f"{tier_err:.3e}")
        if tk.tolist() != [1, 2, 3] or not tier_err <= 2e-4:
            fail("three-tier fixture disagrees with the plain version")
        for name, (kern, plain) in checks.items():
            Zk, ldk, tk = kern()
            Zp, ldp = plain()
            torch.cuda.synchronize()
            ez = float((Zk - Zp).abs().max())
            el = float((ldk - ldp).abs().max())
            zscale = float(Zp.abs().max())
            print(f"{name}: max|dZ| {ez:.3e} (max|Z| {zscale:.3e}) "
                  f"max|dld| {el:.3e} tiers {tk.tolist()}")
            if not (torch.isfinite(Zk).all() and torch.isfinite(ldk).all()):
                fail(f"{name}: non-finite kernel output")
            if not (ez <= ATOL and el <= ATOL):
                fail(f"{name}: kernel and plain version differ by more "
                     f"than atol {ATOL}")
            ms = time_cuda(kern)
            plain_ms = time_cuda(plain)
            if name == "mega_solve":
                B, n, k = Bn.shape
                flops, nbytes = solve_cost(B, n, k, refine, tk.tolist())
            else:
                B, nb, k = Bl.shape
                ntoa = S32.shape[0]
                flops, nbytes = solve_cost(B, nb, k, lrefine, tk.tolist())
                # Ss = S sqrt(w), the symmetric Gram Ss^T Ss, Sn assembly
                flops += B * (ntoa * nb * nb + ntoa * nb + 3 * nb * nb)
                nbytes = 4.0 * (ntoa * nb + B * (ntoa + 2 * nb + nb * k)) \
                    + 4.0 * B * (nb * k + 2)
            bms, bby = bound(flops, nbytes)
            print(f"{name}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                  f"bound {bms:.4f} ms ({bby}; {flops / 1e9:.3f} GFLOP, "
                  f"{nbytes / 1e6:.3f} MB) [{smi}]")
            results[name] = dict(max_abs_err=max(ez, el), ms=ms,
                                 plain_ms=plain_ms, bound_ms=bms,
                                 bound_by=bby)

        # ---- phase 4: the main path through the CLI -----------------------
        from enterprise_warp_tpu_torch import cli
        stats = []

        class BlockStats(logging.Handler):
            def emit(self, record):
                st = getattr(record, "block_stats", None)
                if st is not None:
                    stats.append(st)

        plog = logging.getLogger("ewt.ptmcmc")
        plog.setLevel(logging.INFO)
        handler = BlockStats()
        plog.addHandler(handler)
        launches = {name: 0 for name in mk.KERNELS}
        expect = {0: "mega_solve", 1: "mega_like"}
        for num in (0, 1):
            del stats[:]
            mk.reset_counts()
            t0 = time.perf_counter()
            rc = cli.main(["--prfile", prfile, "--num", str(num)],
                          device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(mk.LAUNCHES)
            routes = {f"{k}/{p}": v for (k, p), v in mk.ROUTES.items()}
            print(f"main path --num {num}: rc {rc} wall {wall:.1f} s "
                  f"launches {counts} routes {routes}")
            if rc != 0:
                fail(f"cli.main exited {rc} for --num {num}")
            kname = expect[num]
            if counts[kname] <= 0:
                fail(f"--num {num}: {kname} was never launched")
            launches[kname] = counts[kname]
            outdir = [os.path.join(r, d) for r, ds, _ in
                      os.walk(os.path.join(tmp, "out")) for d in ds
                      if d.startswith(f"{num}_")]
            chain = np.loadtxt(os.path.join(outdir[0], "chain_1.txt"))
            acc = chain[-1, -2]
            if not (np.isfinite(chain).all() and 0.0 < acc < 1.0):
                fail(f"--num {num}: chain not finite or acceptance {acc}")
            if not np.isfinite(chain[:, -3]).all():
                fail(f"--num {num}: non-finite lnlike")
            steps = sum(st["steps"] for st in stats)
            block_s = sum(st["block_s"] for st in stats)
            W = stats[-1]["walkers"]
            print(f"main path --num {num}: {chain.shape[0]} chain rows, "
                  f"acceptance {acc:.3f}, {steps} steps x {W} walkers in "
                  f"{block_s:.2f} s: {W * steps / block_s:.1f} walker-evals/s"
                  f", {1e3 * block_s / steps:.3f} ms/step [{smi}]")
        plog.removeHandler(handler)

    kernels = [dict(name=name, route="cuda", source=SOURCE,
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=results[name]["max_abs_err"],
                    ms=results[name]["ms"],
                    plain_ms=results[name]["plain_ms"],
                    bound_ms=results[name]["bound_ms"],
                    bound_by=results[name]["bound_by"], library_ms=None)
               for name in mk.KERNELS]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
