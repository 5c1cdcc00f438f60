#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check its kernels.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. environment: torch/CUDA versions and ``nvidia-smi``'s card name and
   power limit;
2. build: every hand-written kernel is compiled from
   ``enterprise_warp_tpu_torch/ops/csrc`` with ``nvcc`` for ``sm_90a``,
   and the native IO core (``native/fastio.cpp``, the ``.tim`` parser and
   chain tables) with ``g++`` into the port's ``_build/``: it must load;
3. kernels vs plain versions: the megakernels' inputs are captured from
   the two real likelihoods of ``examples/example_params/system_noise.dat``
   (``--num 0``: J1234-5678, nb = 250, the solve kernel; ``--num 1``:
   fake_psr_0, nb = 120, the likelihood kernel) at walker points near the
   injected noise parameters, at the walker count the paramfile's
   sampler uses; each kernel and its plain PyTorch version run on the
   same CUDA tensors (plus the three-tier fixture, for the solve kernel
   also at the main path's order n = 250) and must agree within the
   stated tolerance; both are timed with CUDA events. The solve kernel
   runs as phase launches: each phase is timed alone, beside the same
   phases on the earlier one-block-per-walker routines, and the whole
   call is timed against the earlier single-launch design in turns. The
   likelihood kernel runs as a pipeline too (a tiled Gram, a factor in
   shared memory, then the solve phases, forked over two streams); at
   each of its path shapes (here and in phase 4) its phases are timed
   alone (Stage A: the one-block Gram prologue and the solve phases as
   they are; Stage B: the pipeline's own), its Gram's Sn and its factor's
   U are held bit for bit against the one-block prologue's and
   ``solve_factor_kernel``'s, and the whole call is timed against the
   earlier single-launch design in turns; it is also held against its
   plain version and that design on a three-tier fixture at nb = 120 and
   at the caps (ntoa 4096, nb 192);
4. the gradient path of ``examples/example_params/hmc_single_psr.dat``
   (``--num 0``, nb = 60) at 64 near-typical points: value and gradient
   through the card's route (forward: the likelihood kernel; backward:
   the classic chain and its fused preconditioner kernel) against the
   float64 gradient on the CPU; the likelihood kernel's and the
   preconditioner kernel's inputs are captured from that gradient and
   from one at the ADVI batch of 16, and each is held against its plain
   version at both shapes; the preconditioner also on the three-tier
   fixtures (n = 16, and all three tiers at (64, 60, 60)), where float64
   arbitrates a gap that float32 rounding opens. The preconditioner has
   two designs: at these orders the wrapper takes the shared-memory
   kernel, whose U and V must equal ``chol_precond_kernel``'s bit for bit
   on every one of these inputs; at both path shapes the old kernel's
   routines are timed alone (Stage A), E's error is taken product by
   product against float64 for the old routines, the new kernel and the
   plain version, the new kernel's phases are timed by difference of
   prefix launches (Stage B), and the whole call is timed, old against
   new, in turns. A seeded (8, 250, 250) batch goes through the
   global-memory kernel (over the shared-memory cap) and is held against
   the plain version, and both designs are timed at the cap;
5. main paths: ``enterprise_warp_tpu_torch.cli.main`` runs both pulsars
   of ``system_noise.dat`` (temporary copies of the paramfile with
   ``nsamp: 1200``, so that the ``covUpdate``=1000 adaptation fires),
   then the HMC path (``hmc_single_psr.dat --num 0`` at its full width,
   64 chains and 16 leapfrog steps, with the ADVI warm start, 40 steps
   of which 20 warmup), with the launch counters zeroed just before
   each run and read just after (the HMC run also where the ADVI warm
   start ends); the expected kernels must have launched in each run and
   phase, and the chain must be finite with a plausible acceptance rate.
   After the two PT runs, the noise reconstruction (``results/
   reconstruct.py``, :func:`recon_check`): ``get_tempo2_prediction`` on
   ``examples/data/J1234-5678`` with its injected noise file, on the card
   and on the CPU, all five ``general2`` columns within 1e-9 of each
   column's largest magnitude, both timed; ``realizations_batch`` with
   ``--num 0``'s model on 1000 draws of its chain, timed on the card
   (CUDA events) and on the CPU, every draw held within 1e-9 of each
   realization's largest magnitude. Then the PT sampler's warm starts on
   ``--num 1``: the CLI with ``anneal_init`` (the tempered bridge 64 -> 2,
   600 steps more through the likelihood kernel), and with two rungs,
   ``writeHotChains`` and ``advi_init`` (the ADVI fit's gradients also
   run the preconditioner kernel):
   launches counted as on the plain run,
   chains finite with a plausible acceptance, the hot rung's
   ``chain_<T>.txt`` in the cold file's form with the tempered lnpost;
   each run's last likelihood-kernel inputs (per walker batch: the ADVI
   fit's 8 draws and the PT step's 16 walkers in the second) and the ADVI
   fit's last preconditioner input held against their plain versions,
   each run with its rows in the ``kernels`` line. The same for ``--num
   1`` with the ensemble families set in the paramfile (``IndWeight``,
   ``CGWeight``, ``KDEWeight``, ``NSWeight``): every family proposed and
   accepted on the cold rung, each family's acceptance printed;
6. model selection, the sampled timing model and folded Grams: the CLI
   runs ``sampled_timing_model.dat --num 0`` (the solve kernel at
   (8, 40, 40) with k = 1; the likelihood kernel's route declines with no
   timing-model matrix), ``default_hypermodel.dat --num 0`` (the
   product-space hypermodel: each member's likelihood kernel on the
   walkers that select it, nb = 1 and nb = 60, batch sizes that change
   from step to step; the per-call batch sizes and the share of samples
   in each ``nmodel`` bin are printed) and ``fixed_white_noise.dat --num
   0`` (Grams folded at build time: the solve kernel at (8, 250, 250),
   no likelihood kernel), each with ``nsamp: 600`` and its launch
   counts zeroed just before and read just after. Each kernel is held
   against its plain version on the inputs of the run's last step, where
   the chain stood then, walker by walker: a walker whose equilibrated
   system has a condition number above 1e4 is beyond a float32 solve and
   only reported; the others agree within 5e-4 or, where float32
   rounding of a large Z puts the versions further apart, a float64
   arbiter with a relative limit decides. The likelihood kernel is also
   held at nb = 1 on a seeded non-null basis column at the path's ntoa
   and each batch the run gave member 0, whose own column is null (Z = 0
   there). Within 5e-4 and timed, each kernel is held on inputs captured
   from the path's likelihood at points near typical noise values, at
   the walker batch the run gave that order most often; then
   ``python -m enterprise_warp_tpu_torch.results``
   post-processes the three output directories (noise files, credible
   levels, logBF, ``covm``) and must exit 0 and write each noise file.
   Each chain's largest lnL is held against the float64 oracle on the
   CPU in the lnL class (rtol 1e-3, atol 5e-2), the hypermodel's too;
7. nested sampling: the CLI runs ``default_model_nested.dat --num 0``
   as it stands (800 live points, 160 walkers a call, 60 calls an
   iteration) to convergence, with the launch counts zeroed just before
   and read just after: the likelihood kernel must have launched
   ``1 + redraws + it * nsteps`` times and the other two kernels not at
   all. Held: convergence, a finite lnZ within ``log_evidence_err`` of
   the float64 re-scoring of every dead point on the card (on the run's
   own ln X schedule), the insertion-rank KS, the likelihood kernel
   against its plain version walker by walker (under the condition
   bound) on the inputs of the run's last iteration (W 160) and of the
   fresh live set (W 800), both timed, and ``python -m
   enterprise_warp_tpu_torch.results --bilby 1`` on the output. Printed:
   iterations, walker-evals/s, ms per iteration, the dispatch stats, the
   synchronising calls in one block, the posterior means beside the
   injected values. The likelihood kernel's Schur test
   (``schur_reject``) is recorded on every walker of the runs through
   that kernel (pt1, advi, hmc, hyper, nested): its distributions are
   printed, every chain's accepted walkers must pass it, CORNER must be
   rejected, and 8000 prior draws are re-scored in float64 to show where
   the threshold falls;
8. the joint correlated-GWB likelihood (``parallel/pta.py``): first the
   solve kernel at right-hand sides wider than its refine phase's
   8-column panel, k = 9, 24 and 44 at (8, 100, 100), and on a fixture
   whose refinement diverges in one panel only (the divergence guard
   keeps or reverts a walker's whole Z), and the likelihood kernel at
   k = 33 (J1234-5678's basis S (334, 60) with a seeded 32-column timing
   model), each against its plain version within 5e-4. Then the CLI runs
   ``gwb_array.dat --num 0`` (two pulsars, Hellings-Downs ``gwb``; 600
   steps; ``CGWeight``, ``KDEWeight`` and ``NSWeight`` set, every family
   proposed and accepted): two solve-kernel launches per likelihood call
   (stage 1 at
   (16, 20, 20), k 24; stage 3 at (8, 40, 40), k 1) and no other
   kernel, each stage held walker by walker on the run's last inputs
   and, on every call of the run, the kernel's refined Z against float64
   beside the plain version's (:func:`refine_floor`: the kernel, whose
   residual is summed in float64, never the worse by more than twice plus
   5e-4),
   the chain's largest lnL held against the float64 dense oracle on the
   CPU (5e-2 + 1e-7 |lnL|; outside it, ``corner_attribution`` prints the
   per-pulsar gaps and the smoke fails) with the CLI's own float64 check
   silent, ``mask_stats.json`` (the reference's keys; site + common +
   full = nchains x steps; site + common above the cold prior draws and
   noise slides, which always stay in one block, by the cg and kde
   subsets whose dimensions share one, and at most all of them), the
   subset classes on the card against the reference's rule, the
   results CLI on the output. Then the float32 corners on the card: 400
   prior draws scored by the split Schur path (the reference's clamp,
   the float64 redo of flagged pairs) and by the dense float64 oracle on
   the card, each gap attributed to its pairs (:func:`corner_scan`),
   and ``GWB_CORNER`` held in the class; the evaluation cache
   (``CachedEvaluator``) through 64 seeded site, common, full and
   rejected updates, each held against a full recompute in the class,
   its site updates' one-system stage-1 launches held walker by walker
   and timed, one update of each kind timed; ``python -m
   enterprise_warp_tpu_torch.results --optimal_statistic 1`` on the
   paramfile, which must exit 0 and write ``optimal_statistic.pkl`` with
   the reference's payload keys. Then
   BASELINE config 3, 45 fake pulsars of 1000 TOAs
   (``make_fake_pta(45, 1000, seed 45)``, efac/equad, spin noise 30
   modes, DM noise 20, a Hellings-Downs ``gwb`` of 20 modes; 272
   parameters), written to ``.par``/``.tim`` by the port's
   ``save_pulsar_pair`` and read back with their residuals, each
   ``.tim`` parsed by the native core equal to the Python engine's
   (integer MJDs, names, sites and flags exactly, seconds within 1e-9 s;
   both engines timed) (:func:`config3_on_disk`), then a paramfile and
   noise-model JSON with the same terms through the CLI (8 walkers, 600
   steps; its set-up wall time printed apart from the sampling, its TIM
   engine the native core, and the verdict of its float64 check of the
   chain): one solve-kernel launch per call (stage 1 at
   (360, 100, 100), k 44, held on the last inputs and timed phase by
   phase) and stage 3 (n = 1800) over the kernels' cap on the classic
   chain, counted as ``over-cap`` routes; two near-typical points
   against the dense float64 oracle on the card (n 6435), differences
   within 0.5 + 5e-4 |dlnL|; the corner scan on 32 prior draws; the
   evaluation cache as on ``gwb_array.dat`` (64 updates; the site, common
   and full update timed at one theta); ``python -m
   enterprise_warp_tpu_torch.results --optimal_statistic 1`` on the
   paramfile; the optimal statistic (990 pairs) at the chain's median and
   over 250 of its draws on the card, timed and set against the same
   function on the CPU in float64, both measured against a long-double
   witness at the draws where they differ most (:func:`os_witness`), and
   at 250 near-typical draws and their median,
   held there (rho and sig within 1e-6 of the CPU's sig); prior corners inset by
   1e-3 of the range give no NaN. Each joint path prints its stages'
   shares of a call (CUDA events);
9. the north star's pipeline leg (``tools/north_star.py``, ``LEGS
   ["pipeline"]``) on the port (:func:`run_north_star`): the
   J1832-0836-scale pulsar of :func:`north_star_problem` (334 TOAs, 12
   parameters), ``PTSampler`` with 256 chains on one rung and the
   ensemble jump mix, ``anneal_init`` (64, 16, 4; 100 steps each), then
   ``sample_to_convergence`` to ESS >= 1000 and R-hat <= 1.01 (checks
   every 100 steps growing by 1.08, diagnostics on at most 2000 kept
   steps), capped at 40000 steps, with the launch counts zeroed just
   before and read just after: one likelihood-kernel launch at W 256 per
   step. Held: convergence; every family's cold acceptance finite and
   above 0; the posterior against ``NORTH_STAR.json``'s float64 CPU leg
   by a copy of the reference's ``_posterior_match`` (:func:`
   posterior_match`: adjusted mean shift <= 0.25 sigma, width ratio <=
   1.25); the likelihood kernel against its plain version walker by
   walker on the leg's last step (row ``mega_like@north_star``).
   Printed: steps, wall and steady wall, ms per step, ESS per second,
   the time of the anneal, the blocks, the chain writes, the host fits
   and the checks, each family's acceptance, every parameter's shift and
   ratio also against the TPU leg, and one more block of 50 steps under
   ``torch.profiler`` (:func:`profile_block`: the device's busy share,
   the kernels by device time);
10. the run plane (:func:`phase_run_plane`). Every CLI run of phases 5 to
   9 has already had its ``events.jsonl`` checked through the port's copy
   of ``tools/report.py --check``'s rules (:func:`stream_check`): clean,
   one heartbeat per block, no demotion, retry, anomaly or health event.
   Then: (10.1) ``system_noise.dat --num 0`` with
   ``EWT_KERNEL_HEALTH=1`` and ``EWT_FLIGHTREC=1`` (600 steps): only
   kernel 3 runs, at (8, 250, 250) on its global design; its last input
   held against the plain version (walkers above condition 1e4 reported),
   timed (median of 50) as row ``chol_precond@health``; the chain's last
   rows against the float64 oracle; the health counters and ms/step
   over the run (the default route's: phase 5's ``--num 0`` line);
   (10.2) after one counted run not compared, ``--num 0`` and ``--num
   1``, 400 steps each in blocks of 200, ``EWT_TELEMETRY`` off and on
   (two runs a pulsar): the host synchronisations of the second
   block (``torch.cuda.set_sync_debug_mode``, on for that block only;
   each by its thread and calling line) equal, the chains bit for bit
   equal (the plane's cost in time:
   ``enterprise_warp_tpu_torch/bench/ab.py``); (10.3) fault plans on
   ``--num 1`` (300 steps): a ``pt.dispatch`` error retried to the clean
   chain bit for bit, a ``pt.ckpt`` kill in a subprocess resumed to it,
   a watchdog hang demoting ``mega -> classic`` in process onto the
   classic chain with kernel 3 (no kernel switched to its plain version)
   and completing, retries exhausted at the bottom exiting 75 and a
   resume on the kernels completing, a planted ``pt.nonfinite`` dumping
   ``anomaly/anomaly.json`` beside a ``torch.profiler`` trace; (10.4)
   SIGTERM on a CLI run: ``run_end(reason="preempted")`` and a resume
   that completes; (10.5) nested (``default_model_nested.dat``, walk
   kernel, 16 iterations) with ``block_iters`` 0 (one iteration a block)
   bit for bit the blocked walk at 8, both timed;
11. the sampled chromatic index and the device diagnostics plane
   (:func:`phase_chromatic`, :func:`phase_plane`): (11.1) J1234-5678 with
   white noise by backend, spin and DM noise and ``chromred:
   vary_30_nfreqs`` (nb 180, the index sampled) through the CLI, PT at
   the paramfile's defaults, 1200 steps: the likelihood kernel declines
   every call (route ``per-walker-basis``, 0 launches) and the solve
   kernel takes the Sigma solve (row ``mega_solve@chrom``, also held on
   the run's last step); ms/step and walker-evals/s; the chain's last
   rows and its largest lnL against the float64 oracle on the CPU; the
   index's posterior finite and inside its prior [0, 6]; (11.2)
   ``gwb_array.dat``'s model with J1234-5678's entry adding ``chromred:
   vary_10_nfreqs`` (fake_psr_0, one band, keeps the universal model),
   600 steps: the last rows against the dense float64 oracle, no
   evaluation cache, the stage-1 and stage-3 solve launches (rows
   ``mega_solve@chrom_gwb_stage1``/``_stage3``); (11.3) the plane, on by
   default on every path: after one counted run not compared,
   ``system_noise.dat --num 1`` (the likelihood kernel), 200 steps in
   blocks of 100, ``EWT_DEVICE_DIAG`` on, off, off, on: the chains bit
   for bit equal and the host synchronisations of the second block
   equal; every CLI run's stream carries one
   ``mixing`` event a PT block and ``mixing_stats.json`` (in
   :func:`stream_check`); the north star leg (phase 9) runs with the
   streaming gate at its default, its streaming R-hat and ESS held
   against the exact estimators on its kept steps at the reference's
   gates (for the parameters the streaming figures rank worst), and its
   count of exact folds printed; (11.4) the OpenMetrics
   textfile and one request to ``/metrics`` on 127.0.0.1, the same text;
12. the pulsar axis across processes (:func:`phase_pulsar_axis`), ranks
   launched as subprocesses through the ``EWT_*`` contract, each with its
   own time limit (one failed rank fails the phase): (12.1) config 3 from
   disk through the CLI with ``psr_shard: 1`` over two gloo ranks sharing
   the card, 200 steps: rank 0 writes the run's files and rank 1 only
   ``events.1.jsonl`` and ``mesh_stats.1.json``, the ranks' final states
   equal, kernel 1 launched on both (rows ``mega_solve@psr_shard_r0``/
   ``_r1``, each rank's stage-1 shape on its last step), one
   ``all_reduce`` an evaluation and no gather, the sharded lnL at the
   chain's last 8 states within the joint class of the unsharded build,
   ms/step, one evaluation and its collective alone timed; (12.2) one
   NCCL rank, the sharded build at those states, started beside the pair
   but building and timing only after the pair is done; (12.3)
   ``gwb_array.dat`` over the two ranks: the autograd gradient at 4
   states against the unsharded one within 1e-3 max(1, |g|), an HMC leg
   (W 16, 20 steps) with equal final states, the health twin
   (``EWT_KERNEL_HEALTH=1``, 40 steps: kernel 3 on each rank's stage 1,
   rows ``chol_precond@psr_shard_health_r0``/``_r1``, held on the run's
   last step; its stage 3 on kernel 1, row
   ``mega_solve@psr_shard_health_stage3``; the ranks' health ledgers
   equal), and
   ``sample_to_convergence`` with three checks (every resume after the
   first taken from rank 0; the ranks' states equal at every check);
   (12.4) ``system_noise.dat --num 0`` with ``chain_shard: 1``: the
   gathered start lnL within 1e-9 relative of the whole batch's, equal
   states, and whether the chain is bit for bit the unsharded run's (its
   ms/step beside); (12.5) where more than one card is visible, 12.1
   with NCCL on ``min(count, 4)`` cards, one rank a card (else it prints
   ``multi-GPU: not run``);
13. the ``kernels`` JSON line, one entry per kernel and main path that
   runs it (``name`` is ``kernel@path``), each with that path's launches,
   error, times and bound at that path's shapes; then the result line
   ``{"ok": true, "device": {...}}``, after the smoke's wall time.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "enterprise_warp_tpu_torch"
SOURCE = f"{PKG}/ops/csrc/megakernel.cu"
REPLACES = {
    "mega_solve": "enterprise_warp_tpu/ops/megakernel.py:262",
    "mega_like": "enterprise_warp_tpu/ops/megakernel.py:449",
    "chol_precond": "enterprise_warp_tpu/ops/cholfuse.py:120",
}
# H100 SXM peaks (NVIDIA data sheet, dense): float32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# the reference probe's tolerance on Z and ld (ops/megakernel.py:823-827)
ATOL = 5e-4
# a sampler's last step: walkers whose equilibrated system has a 2-norm
# condition number above KAPPA_MAX are beyond a float32 solve (its
# first-order forward error, cond * 2^-23, passes 1.2e-3 there); below
# it the kernel may lie at most ARB_REL = KAPPA_MAX * 2^-23 of the
# float64 value from it
KAPPA_MAX = 1e4
ARB_REL = KAPPA_MAX * 2.0 ** -23
# the likelihood kernel's float32 Gram, on a walker arbitrated on its own
# system: within this share of the worst-case rounding bound of float32
# dot products (own_system). Run 13d of PR 13 read 0.03-0.07 on the
# arbitrated walkers of the H100 80GB HBM3, so a Gram some 4x worse than
# the kernel's own fails
GRAM_BOUND_FRAC = 0.25
# sampler steps of the system_noise.dat main paths (and phase 10's health
# and plane-cost runs): past the paramfile's covUpdate = 1000, so the
# covariance adaptation fires (blocks of 1000 and 200 steps)
NSAMP = 1200
# the other PT paths through the CLI (the warm starts, the families, phase
# 6, the joint paths): past covUpdate = SHORT_COV_UPDATE, blocks of 500
# and 100 steps, so the adaptation still fires and each run's launch
# counts hold. They are cut to this depth so that the script, the north
# star leg at its full targets and phase 10 included, ends well inside
# its 1200 s limit on a card whose host is slower: at 2000 steps, 1000
# optimal-statistic draws and 200 HMC steps it ran past the limit, and
# with every PT path at 1200 steps and phase 10 it took 859.9 s on the
# NVIDIA H100 80GB HBM3 (PERF.md)
SHORT_NSAMP, SHORT_COV_UPDATE = 600, 500
# the reference's interpret-vs-XLA limits on the preconditioner trio
# (tests/test_cholfuse.py): U, V, E
CHOL_ATOL = (2e-5, 2e-4, 2e-5)
# the shared-memory preconditioner's E against float64 products of its
# own U and V, per walker: within E_OWN_RTOL of the walker's largest |E|,
# plus E_OWN_ATOL. With D summed in float64 only the float32 products'
# rounding is left (about 1e-7 of max|E| on the gradient path); D summed
# in float32, as chol_precond_kernel sums it, is about 2e-2 there
E_OWN_RTOL, E_OWN_ATOL = 1e-4, 1e-12
# the HMC path: the paramfile's full width (64 chains, 16 leapfrog
# steps), 40 steps of which 20 warmup (explicit, so run_hmc keeps it)
# after the ADVI warm start (1500 steps of 16 draws); cut as NSAMP is,
# and from 100/50 and 60/30 for the smoke's time on slower hosts
HMC_KEYS = dict(nsamp=40, warmup=20, nchains=64, n_leapfrog=16)
# the PT warm start's ADVI fit on --num 1's hot run: 300 steps (the
# paramfile default is 800; cut for the smoke's time)
HOT_ADVI_STEPS = 300
# the main-path runs, each with its own launch counts
PATHS = {"pt0": "system_noise.dat --num 0: PT-MCMC, 8 walkers",
         "pt1": "system_noise.dat --num 1: PT-MCMC, 8 walkers",
         "anneal": "system_noise.dat --num 1 with anneal_init: PT-MCMC "
                   "after a tempered warm start, 8 walkers",
         "hot": "system_noise.dat --num 1 with ntemps 2, writeHotChains and "
                "advi_init: PT-MCMC after an ADVI warm start, 16 walkers",
         "advi": "hmc_single_psr.dat --num 0: ADVI warm start, 16 draws",
         "hmc": "hmc_single_psr.dat --num 0: HMC, 64 chains",
         "tm": "sampled_timing_model.dat --num 0: PT-MCMC, 8 walkers",
         "hyper": "default_hypermodel.dat --num 0: PT-MCMC over the "
                  "product-space hypermodel, 8 walkers",
         "fixed": "fixed_white_noise.dat --num 0: PT-MCMC, 8 walkers",
         "health0": "system_noise.dat --num 0 with EWT_KERNEL_HEALTH=1: "
                    "PT-MCMC on the classic chain (the health plane's pin), "
                    "8 walkers",
         "nested": "default_model_nested.dat --num 0: nested sampling, "
                   "800 live points, 160 walkers a call",
         "nested_live": "default_model_nested.dat --num 0: nested "
                        "sampling, the fresh live set of 800 prior draws",
         "gwb": "gwb_array.dat --num 0 with CGWeight, KDEWeight and "
                "NSWeight: PT-MCMC over the joint correlated-GWB "
                "likelihood of two pulsars, 8 walkers",
         "pta45": "BASELINE config 3, 45 fake pulsars of 1000 TOAs "
                  "written to .par/.tim by the port: the paramfile through "
                  "the CLI, PT-MCMC, 8 walkers",
         "gwb_site": "gwb_array.dat --num 0: the evaluation cache's site "
                     "updates (CachedEvaluator, one theta, one pulsar "
                     "re-solved)",
         "pta45_site": "BASELINE config 3: the evaluation cache's site "
                       "updates (CachedEvaluator, one theta, one pulsar "
                       "re-solved)",
         "families": "system_noise.dat --num 1 with IndWeight, CGWeight, "
                     "KDEWeight and NSWeight: PT-MCMC with the ensemble "
                     "families, 8 walkers",
         "north_star": "the north star's pipeline leg: J1832-0836-scale "
                       "pulsar (334 TOAs, 12 parameters), 256 chains, SMC "
                       "anneal, ensemble families, sample_to_convergence "
                       "to ESS >= 1000 and R-hat <= 1.01",
         "wide_k": "seeded fixtures: right-hand sides wider than the refine "
                   "phase's 8-column panel (no main-path launches: the "
                   "paths' own rows carry those)",
         "chrom": "system_noise.dat --num 0 with a sampled chromatic "
                  "index (chromred: vary_30_nfreqs, nb 180): PT-MCMC on "
                  "the classic chain, 8 walkers",
         "chrom_gwb": "gwb_array.dat --num 0 with J1234-5678's sampled "
                      "chromatic index (chromred: vary_10_nfreqs): PT-MCMC "
                      "over the joint likelihood, 8 walkers",
         "shard_r0": "BASELINE config 3 through the CLI with psr_shard: 1 "
                     "over two gloo ranks sharing the card: rank 0's "
                     "stage 1 (pulsars 0-22), PT-MCMC, 8 walkers",
         "shard_r1": "BASELINE config 3 through the CLI with psr_shard: 1 "
                     "over two gloo ranks sharing the card: rank 1's "
                     "stage 1 (pulsars 23-44), PT-MCMC, 8 walkers",
         "shard_health_r0": "gwb_array.dat's joint likelihood sharded over "
                            "two gloo ranks sharing the card, "
                            "EWT_KERNEL_HEALTH=1: rank 0's stage 1 on the "
                            "health twin's classic chain, PT-MCMC, 8 "
                            "walkers",
         "shard_health_r1": "gwb_array.dat's joint likelihood sharded over "
                            "two gloo ranks sharing the card, "
                            "EWT_KERNEL_HEALTH=1: rank 1's stage 1 on the "
                            "health twin's classic chain, PT-MCMC, 8 "
                            "walkers",
         "shard_health_s3": "gwb_array.dat's joint likelihood sharded over "
                            "two gloo ranks sharing the card, "
                            "EWT_KERNEL_HEALTH=1: stage 3, replicated on "
                            "both ranks (rank 0's), PT-MCMC, 8 walkers"}
# the joint paths: right-hand-side widths past the refine phase's 8-column
# panel, BASELINE config 3's size, and the agreement of lnL differences
# with the dense float64 oracle there (tests/test_parallel.py:612)
WIDE_K = (9, 24, 44)
PTA45 = dict(npsr=45, ntoa=1000, seed=45)
DIFF45_ATOL, DIFF45_RTOL = 0.5, 5e-4
# config 3 on disk: a noise model with config3_array's terms, and the
# round trip of the written pulsars' residuals. The reference's limit is
# 1e-7 s (tests/test_writers.py:29-46); the loader's float64 pulse phase
# rounds to eps |t - PEPOCH| s, and config 3's 1000 TOAs at a 14-day
# cadence span 38 years, so its limit is the larger of the two
PTA45_MODEL = {"model_name": "pta45",
               "common_signals": {"gwb": "hd_vary_gamma_20_nfreqs"},
               "universal": {"white_noise": "by_backend",
                             "spin_noise": "powerlaw_30_nfreqs",
                             "dm_noise": "powerlaw_20_nfreqs"}}
ROUNDTRIP_ATOL = 1e-7
# the joint Schur path's lnL against float64 (tests/test_parallel.py)
JOINT_ATOL, JOINT_RTOL = 5e-2, 1e-7
# the evaluation cache: seeded updates held against a full recompute at
# each of the joint paths; prior draws of the corner scans
CACHE_UPDATES = 64
CORNER_DRAWS = {"gwb": 400, "pta45": 32}
# the corner scans: a gap beyond CORNER_FAR nats above float64 is an
# attractive corner for a PT chain; the float64 redo is also scored at
# these thresholds beside the shipped CORNER_C
CORNER_FAR = 1e3
CORNER_THRESHOLDS = (0.0, 1e-6)
# the redo's cost: batches of a joint chain's rows timed
REDO_BATCHES = 4
# systems per batched eigenvalue call of refine_floor
EIG_BATCH = 4096
# the optimal statistic at config 3: the draws held against the CPU in
# float64 (the results CLI's default is 1000; cut as SHORT_NSAMP is,
# since the CPU's float64 side takes some 60 s per 1000 draws, and from
# 250 for the smoke's time), and its card-against-CPU limit on sig and on
# rho relative to sig
OS_DRAWS = 100
OS_RTOL = 1e-6
# the optimal statistic's factor (the reference's algebra) against a
# long-double witness at the chain's draws, and the limit a repair must
# meet there: at each witnessed draw the card within max(OS_WITNESS_FACTOR
# x the CPU's distance, OS_WITNESS_FLOOR) of the witness, in units of its
# sig. Reported, not held: no repair measured so far met it (PERF.md)
OS_WITNESS_FACTOR, OS_WITNESS_FLOOR = 2.0, 1e-6
# the noise reconstruction: chain draws on the card, each held against the
# CPU within the limit (a fraction of each column's largest magnitude)
RECON_DRAWS, RECON_TOL = 1000, 1e-9
# a prior draw of gwb_array.dat where the reference's split Schur path
# lies 3.9e10 above float64 (tests/test_torch_pta.py); the port's float64
# redo of the flagged pair must bring it into the class
GWB_CORNER = [9.550267261985898, 9.864879953879617, 0.21294984471825207,
              7.983805557016662, -7.573009349530989, -9.090666556223736,
              -5.3159387846797745, -8.518091457654648, -15.409271725939389,
              9.74767137573976, -14.455641670495108, 9.643583519953092,
              0.006367229449742995, -9.329792781673513, -12.034782490427611,
              5.720836340350981]
# mask_stats.json: the reference's keys (utils/diagnostics.py:
# cache_hit_summary)
MASK_KEYS = (["cache_hit_rate", "proposals", "total"],
             ["common", "full", "site"])
# the widest right-hand side of the earlier single-launch solve design
# (one 8-column panel), which only this script still launches
SINGLE_LAUNCH_KMAX = 8
# the lnL class of the reference's megakernel route against float64
# (tests/test_megakernel.py): |dlnL| <= LNL_ATOL + LNL_RTOL |lnL|
LNL_ATOL, LNL_RTOL = 5e-2, 1e-3
# a prior corner of default_hypermodel.dat's member 1 (CASPSR efac 7.8e-4,
# red-noise log10_A -6.89) where the equilibrated Sigma is far beyond
# float32 and the timing-model Schur complement comes out indefinite;
# the likelihood kernel's route must reject it
# (tests/test_torch_hypermodel.py)
CORNER = [0.0007849382887030049, 8.404088323451239, 4.915462071268632,
          9.132290993384434, -9.255658796563068, -7.779135706917557,
          -5.462763583946961, -8.434894532696779, -6.888397086499135,
          5.466953296230443]
# nested sampling: prior draws for the Schur test's threshold, and the
# batch of the float64 re-scoring of the dead points
PRIOR_DRAWS = 8000
RESCORE_BATCH = 1000
# the north star's pipeline leg (tools/north_star.py: LEGS["pipeline"],
# TARGET_ESS, RHAT_MAX, META["diag_max_kept"]): 256 chains of one rung,
# the ensemble jump mix, an SMC anneal, then convergence-gated sampling
# to ESS >= 1000 and R-hat <= 1.01; NORTH_STAR_MAX_STEPS caps the phase
NORTH_STAR_SAMPLER = dict(ntemps=1, nchains=256, seed=0, scam_weight=8,
                          am_weight=2, de_weight=10, prior_weight=12,
                          ind_weight=0, cg_weight=15, cg_k=3, kde_weight=18,
                          ns_weight=35)
NORTH_STAR_ANNEAL = dict(schedule=[64.0, 16.0, 4.0], steps_per=100)
NORTH_STAR_GATE = dict(target_ess=1000.0, rhat_max=1.01, check_every=100,
                       block_size=100, check_growth=1.08, diag_max_kept=2000)
NORTH_STAR_MAX_STEPS = 40000
# the ensemble families through the CLI: the pipeline leg's weights for
# cg, kde and ns, and an independence weight besides the paramfile's own
FAMILY_KEYS = {"IndWeight": 10, "CGWeight": 15, "KDEWeight": 18,
               "NSWeight": 35}
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


class KeepSamplers:
    """Keep every sampler the CLI's ``run_ptmcmc`` returns while it runs
    (``samplers``), and the likelihood and parsed paramfile it was given
    (``calls``)."""

    def __enter__(self):
        import enterprise_warp_tpu_torch.samplers as samplers_pkg
        self.pkg, self.orig = samplers_pkg, samplers_pkg.run_ptmcmc
        self.samplers, self.calls = [], []

        def run(like, *a, **k):
            self.calls.append((like, k.get("params")))
            self.samplers.append(self.orig(like, *a, **k))
            return self.samplers[-1]
        samplers_pkg.run_ptmcmc = run
        return self

    def __exit__(self, *exc):
        self.pkg.run_ptmcmc = self.orig


def family_report(label, sampler, expect):
    """Each proposal family's cold proposals and acceptance of a PT run;
    every family in ``expect`` must have been proposed and accepted (a
    finite rate above 0), and no other proposed."""
    from enterprise_warp_tpu_torch.samplers.ptmcmc import _FAM_NAMES
    rates = {n: (int(p), a / p if p else None) for n, a, p in zip(
        _FAM_NAMES, sampler.fam_accept, sampler.fam_propose) if p}
    print(f"{label}: cold proposals and acceptance per family {rates}")
    if sorted(rates) != sorted(expect) or not all(
            r is not None and 0 < r <= 1 for _, r in rates.values()):
        fail(f"{label}: the families proposed and accepted are not "
             f"{list(expect)}")
    return rates


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


def write_paramfile(tmp, name, dest=None, extra=None, cov_update=None,
                    **keys):
    """A copy of ``examples/example_params/<name>``, written as
    ``tmp/<dest>`` (default ``name``), with absolute input paths, the
    output under ``tmp/out/<dest>``, the sampler ``keys`` set (every key
    must already be in the file) and the ``extra`` keys (and
    ``covUpdate: cov_update``, if given) added before the model
    section."""
    if cov_update is not None:
        extra = dict(extra or {}, covUpdate=cov_update)
    ex = os.path.join(HERE, "examples")
    dest = dest or name
    with open(os.path.join(ex, "example_params", name)) as fh:
        src = fh.read()
    out = []
    for line in src.splitlines():
        key = line.split(":")[0].strip()
        if key == "datadir":
            line = f"datadir: {os.path.join(ex, 'data')}"
        elif key == "out":
            line = f"out: {os.path.join(tmp, 'out', dest)}"
        elif key in keys:
            line = f"{key}: {keys.pop(key)}"
        elif key in ("noise_model_file", "noisefiles"):
            line = f"{key}: " + os.path.join(
                ex, line.split(":", 1)[1].strip())
        elif line.strip() == "{0}":
            out += [f"{k}: {v}" for k, v in (extra or {}).items()]
        out.append(line)
    if keys:
        fail(f"{name} has no line for {sorted(keys)}")
    path = os.path.join(tmp, dest)
    with open(path, "w") as fh:
        fh.write("\n".join(out) + "\n")
    return path


def load_likes(prfile, num, dev, gram_mode="split", mesh=False):
    """The parsed paramfile and its ``{model_id: likelihood}`` (``mesh``:
    the pulsar axis over the process group)."""
    import types
    from enterprise_warp_tpu_torch.config import Params
    from enterprise_warp_tpu_torch.models.assemble import \
        init_model_likelihoods
    from enterprise_warp_tpu_torch.parallel import make_psr_mesh
    opts = types.SimpleNamespace(num=num, drop=0, mpi_regime=2,
                                 wipe_old_output=0, extra_model_terms=None)
    params = Params(prfile, opts=opts)
    return params, init_model_likelihoods(
        params, gram_mode=gram_mode, write_pars=False, device=dev,
        mesh=make_psr_mesh(len(params.psrs), device=dev) if mesh else None)


def near_typical(like, nwalk, seed):
    """Points near typical noise values: efac 1, log10 equad -7, log10_A
    -13.5, gamma 3.5 (sigma 0.05)."""
    import numpy as np
    base = [1.0 if p.name.endswith("efac") else
            -7.0 if "equad" in p.name else
            -13.5 if p.name.endswith("log10_A") else 3.5
            for p in like.params]
    rng = np.random.default_rng(seed)
    return np.asarray(base) + 0.05 * rng.standard_normal((nwalk, like.ndim))


def near_middle(like, nwalk, seed):
    """Typical noise values (as :func:`near_typical`) and every other
    parameter near the middle of its prior: spread 2% of the width for the
    timing-model offsets, 1e-5 of the width (or of the prior sigma) for
    the physical ephemeris offsets, whose prior scale moves the residuals
    by seconds against microsecond TOA errors."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = near_typical(like, nwalk, seed)
    for i, p in enumerate(like.params):
        if p.name.endswith(("efac", "log10_A", "gamma")) or "equad" in p.name:
            continue
        z = rng.standard_normal(nwalk)
        if hasattr(p.prior, "sigma"):
            out[:, i] = p.prior.mu + 1e-5 * p.prior.sigma * z
        else:
            rel = 0.02 if "tmparams" in p.name else 1e-5
            out[:, i] = (0.5 * (p.prior.lo + p.prior.hi)
                         + rel * (p.prior.hi - p.prior.lo) * z)
    return out


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


class Record(Capture):
    """Record every call of a kernel wrapper during a run: the last inputs
    per matrix order ``n`` (the last axis of the first input) and the
    batch sizes of all calls per order (``batch_arg``: the input whose
    first axis is the walker batch)."""

    def __init__(self, mk, name, batch_arg):
        super().__init__(mk, name)
        self.batch_arg = batch_arg
        self.last = {}
        self.sizes = collections.defaultdict(collections.Counter)

    def __enter__(self):
        def rec(*args):
            n = args[0].shape[-1]
            self.last[n] = args
            self.sizes[n][args[self.batch_arg].shape[0]] += 1
            return self.orig(*args)
        setattr(self.mk, self.name, rec)
        return self


class RecordBatches(Record):
    """:class:`Record` keyed by walker batch: the last inputs per batch
    size (``last``), and the calls per order and batch size."""

    def __enter__(self):
        def rec(*args):
            W = args[self.batch_arg].shape[0]
            self.last[W] = args
            self.sizes[args[0].shape[-1]][W] += 1
            return self.orig(*args)
        setattr(self.mk, self.name, rec)
        return self


class RecordShapes(Record):
    """:class:`Record` that also keeps every call's inputs, per matrix
    order and walker batch (``calls[(n, W)]``)."""

    def __enter__(self):
        self.calls = collections.defaultdict(list)

        def rec(*args):
            n, W = args[0].shape[-1], args[self.batch_arg].shape[0]
            self.calls[(n, W)].append(args)
            self.last[n] = args
            self.sizes[n][W] += 1
            return self.orig(*args)
        setattr(self.mk, self.name, rec)
        return self


class SchurRecord(Capture):
    """Record the timing-model Schur test of the likelihood kernel's
    route (``ops/megakernel.py:schur_reject``) for every walker it sees,
    under the label in ``run`` (nothing while ``run`` is None): the ratio
    min(evA)/max|evA|, the quadratic form and the verdict."""

    def __init__(self, mk):
        super().__init__(mk, "schur_reject")
        self.run = None
        self.rows = collections.defaultdict(list)

    def __enter__(self):
        import torch

        def rec(evA, quad):
            out = self.orig(evA, quad)
            if self.run is not None:
                ratio = evA.amin(dim=-1) / evA.abs().amax(dim=-1)
                self.rows[self.run].append(torch.stack(
                    [ratio, quad, out.to(quad.dtype)], dim=-1))
            return out
        setattr(self.mk, self.name, rec)
        return self

    def table(self, run):
        """``(ratio, quad, rejected)`` numpy columns of ``run``."""
        import numpy as np
        import torch
        if not self.rows[run]:
            return np.zeros((0, 3))
        return torch.cat(self.rows[run]).cpu().numpy()

    def report(self, run):
        """Print the distribution of ``run``'s walkers; returns how many
        the test rejected."""
        import numpy as np
        t = self.table(run)
        rej = t[:, 2] > 0
        ok = t[~rej]
        q = (np.quantile(ok[:, 0], [0.0, 1e-4, 1e-2, 0.5]) if len(ok)
             else [np.nan] * 4)
        print(f"Schur test, {run}: {len(t)} walkers, {int(rej.sum())} "
              f"rejected ({int((t[:, 0] < 0).sum())} with a negative "
              f"eigenvalue, {int((t[:, 1] < 0).sum())} with quad < 0); "
              "passing walkers' min(evA)/max|evA| min / 1e-4 / 1e-2 / "
              f"median quantile {q[0]:.3e} / {q[1]:.3e} / {q[2]:.3e} / "
              f"{q[3]:.3e}, smallest quad "
              f"{ok[:, 1].min() if len(ok) else np.nan:.6g}")
        return int(rej.sum())


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


def chol_cost(B, n, tiers):
    """(FLOP, bytes) of one preconditioner launch, per walker: n^3/3 per
    Cholesky attempt, n^3/3 for the triangular inverse, n^3/3 for U^T U,
    n^3 each for V^T D and (V^T D) V; one (n, n) input read and three
    written, plus the tiers."""
    attempts = sum(1 if t == 1 else 2 for t in tiers)
    flops = attempts * n ** 3 / 3.0 + B * (2.0 * n ** 3 / 3.0 + 2.0 * n ** 3)
    nbytes = 4.0 * B * 4 * n * n + 4.0 * B
    return flops, nbytes


def like_cost(S32, Bn, refine, tiers):
    """(FLOP, bytes) of one likelihood-kernel launch: the solve chain of
    :func:`solve_cost` plus, per walker, ``Ss = S sqrt(w)``, the symmetric
    Gram ``Ss^T Ss`` and the Sigma assembly; ``S`` read once, and per
    walker ``w``, ``s``, ``ivb`` and ``Bn`` read, ``Z`` and ``ld``
    written."""
    B, nb, k = Bn.shape
    ntoa = S32.shape[0]
    flops, _ = solve_cost(B, nb, k, refine, tiers)
    flops += B * (ntoa * nb * nb + ntoa * nb + 3 * nb * nb)
    nbytes = 4.0 * (ntoa * nb + B * (ntoa + 2 * nb + nb * k)) \
        + 4.0 * B * (nb * k + 2)
    return flops, nbytes


def exact_solve(Sn, Bn):
    """The float64 solution, log-determinant and 2-norm condition number
    of the equilibrated systems ``Sn Z = Bn`` (an arbiter for the float32
    versions). The solve is a Cholesky-preconditioned one for positive
    definite systems: a system singular or not positive definite in
    float64 gets an infinite condition number."""
    import torch
    S = Sn.double()
    Z, info = torch.linalg.solve_ex(S, Bn.double())
    pd = torch.linalg.cholesky_ex(S)[1] == 0
    kappa = torch.where((info != 0) | ~pd, torch.inf, torch.linalg.cond(S))
    return Z, torch.linalg.slogdet(S)[1], kappa


def like_system(S32, w, s, ivb, Bn):
    """The likelihood kernel's equilibrated system ``Sn = s (Ss^T Ss) s +
    diag(ivb)``, ``Ss = S sqrt(w)``, formed in float64, and its ``Bn``."""
    import torch
    Ss = S32.double()[None] * torch.sqrt(w.double())[:, :, None]
    sd = s.double()
    Sn = (torch.einsum("bik,bil->bkl", Ss, Ss) * sd[:, :, None]
          * sd[:, None, :] + torch.diag_embed(ivb.double()))
    return Sn, Bn


def own_system(args):
    """The likelihood kernel's own float32 systems on ``args``: its ``Sn``
    as its Gram launch formed it (read from the workspace after one call
    of ``mega_like_launch``), and per walker the largest ratio of |Sn -
    Sn64| to the rounding-error bound of float32 dot products,
    gamma_(ntoa+8) (s_i s_j (|Ss|^T |Ss|)_ij + |ivb_i| delta_ij) with
    gamma_m = m u / (1 - m u), u = 2^-24 (Higham, Accuracy and Stability
    of Numerical Algorithms, 3.1: the products, the square roots, the
    scaling and the diagonal add), ``Sn64`` the system formed in float64
    from the same float32 inputs. A float32 Gram lies within the bound
    (ratio <= 1) whatever its summation order. Returns ``(Sn, ratio,
    (Bn, j1, j2, refine))``."""
    import torch
    from enterprise_warp_tpu_torch.ops import cuda_lib
    from enterprise_warp_tpu_torch.ops import megakernel as mk
    S32, w, s, ivb, Bn, j1, j2, refine = args
    (ntoa, nb), (B, _, k) = S32.shape, Bn.shape
    lib = cuda_lib.load_library()
    bufs = mk._mega_like_buffers(lib, Bn)
    with torch.cuda.device(Bn.device):
        rc = lib.mega_like_launch(
            S32.data_ptr(), w.data_ptr(), s.data_ptr(), ivb.data_ptr(),
            Bn.data_ptr(), *(t.data_ptr() for t in bufs[:4]), B, ntoa, nb,
            k, float(j1), float(j2), int(refine),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        fail(f"mega_like_launch returned cudaError {rc}")
    Sn = bufs[4].clone()
    Sn64, _ = like_system(S32, w, s, ivb, Bn)
    Sa = S32.double().abs()[None] * torch.sqrt(w.double())[:, :, None]
    sd = s.double().abs()
    A = (torch.einsum("bik,bil->bkl", Sa, Sa) * sd[:, :, None]
         * sd[:, None, :] + torch.diag_embed(ivb.double().abs()))
    m = ntoa + 8
    gamma = m * 2.0 ** -24 / (1.0 - m * 2.0 ** -24)
    err = (Sn.double() - Sn64).abs()
    ratio = torch.where(A > 0, err / (gamma * A),
                        torch.where(err > 0, torch.inf, 0.0))
    return Sn, ratio.flatten(1).amax(1), (Bn, j1, j2, refine)


def bound(flops, nbytes):
    t_ops = flops / PEAK_F32_FLOPS
    t_mem = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_mem), ("operations" if t_ops >= t_mem
                                     else "bytes")


def refine_floor(label, calls):
    """The solve kernel and its plain version against float64 on every
    system of ``calls`` (the recorded inputs of one order): their errors
    relative to each walker's largest |Z|, and on the walkers within the
    condition bound the count where one lies more than twice as far from
    float64 as the other plus ATOL. The kernel sums the refinement's
    residual in float64, the plain version in float32 as the reference
    does, so the kernel may never be the worse one."""
    import torch
    from enterprise_warp_tpu_torch.ops import megakernel as mk
    Sn = torch.cat([c[0] for c in calls])
    Bn = torch.cat([c[1] for c in calls])
    j1, j2, refine = calls[-1][2:]
    Zk = mk._mega_solve_cuda(Sn, Bn, j1, j2, refine)[0]
    Zp = mk._mega_solve_torch(Sn, Bn, j1, j2, refine)[0]
    S = Sn.double()
    Za, info = torch.linalg.solve_ex(S, Bn.double())
    # the 2-norm condition number of the symmetric systems, from their
    # eigenvalues (a batched SVD of every system is slow), in batches of
    # EIG_BATCH (cuSOLVER's batched eigensolver refused 32016 systems of
    # order 20 at once); non-finite, singular or not positive definite:
    # infinite
    finite = torch.isfinite(S).flatten(1).all(1)
    eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
    ev = torch.cat([torch.linalg.eigvalsh(c) for c in
                    torch.where(finite[:, None, None], S, eye)
                    .split(EIG_BATCH)])
    kappa = torch.where(finite & (ev[:, 0] > 0) & (info == 0),
                        ev[:, -1] / ev[:, 0], torch.inf)
    zmax = Za.abs().flatten(1).amax(1)
    ek = (Zk.double() - Za).abs().flatten(1).amax(1)
    ep = (Zp.double() - Za).abs().flatten(1).amax(1)
    held = kappa <= KAPPA_MAX
    qs = torch.tensor([0.5, 0.99, 0.999, 1.0], dtype=torch.float64,
                      device=Sn.device)
    kq = torch.quantile((ek / zmax)[held], qs).tolist()
    pq = torch.quantile((ep / zmax)[held], qs).tolist()
    k_worse = int((held & (ek > 2 * ep + ATOL)).sum())
    p_worse = int((held & (ep > 2 * ek + ATOL)).sum())
    print(f"{label}: the refined Z of {len(Sn)} systems {tuple(Sn.shape[1:])} "
          f"({int(held.sum())} within cond {KAPPA_MAX:g}) against float64, "
          f"|error| / max|Z| at the median, 0.99, 0.999 and max: kernel "
          f"(float64 residual) {['%.2e' % q for q in kq]}, plain version "
          f"(float32 residual) {['%.2e' % q for q in pq]}; walkers where "
          f"the kernel lies more than twice as far from float64 as the plain "
          f"version plus atol {k_worse}, the plain version so far from the "
          f"kernel's {p_worse}")
    if k_worse:
        fail(f"{label}: the kernel's refined Z is less accurate than the "
             "plain version's")


def three_tier_fixture(torch, dev, n=16, k=2):
    """Walker 0 clean; walker 1 indefinite at j1 but PD at j2; walker 2
    hopeless (identity tier) — the reference test's fixture (n = 16)."""
    import numpy as np
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
    Bn = rng.standard_normal((3, n, k)).astype(np.float32)
    return (torch.as_tensor(Sn, device=dev), torch.as_tensor(Bn, device=dev))


def precond_fixture(torch, dev, n=60, B=64):
    """All three tiers at the HMC path's shape (64, 60, 60), for the
    jitters (1e-6, 1e-3): unit-diagonal SPD walkers, walker 3 indefinite
    at the first jitter but PD at the second (smallest eigenvalue -5e-5,
    so condition ~1.6e3 once jittered), walker 7 hopeless (diagonal -0.2,
    the identity tier)."""
    import numpy as np
    rng = np.random.default_rng(5)
    out = []
    for i in range(B):
        A = rng.standard_normal((n, n))
        S = A @ A.T / n + np.eye(n) * (0.5 + 0.01 * i)
        d = np.sqrt(np.diag(S))
        out.append(S / d[:, None] / d[None, :])
    Sb = np.stack(out).astype(np.float32)
    Sb[7] -= 1.2 * np.eye(n, dtype=np.float32)
    rng = np.random.default_rng(13)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    ev = np.linspace(0.5, 1.5, n)
    ev[0] = -5e-5
    Sb[3] = ((Q * ev) @ Q.T).astype(np.float32)
    tiers = [1] * B
    tiers[3], tiers[7] = 2, 3
    return torch.as_tensor(Sb, device=dev), tiers


def solve_pipeline(torch, mk, lib, Sn, Bn, j1, j2, refine, whole_ms, smi,
                   label="mega_solve@pt"):
    """The solve kernel's phase launches on one captured input: each
    phase's time alone, for the pipeline and for the same phases run on
    the earlier one-block-per-walker inverse and products, against
    ``whole_ms``, the time of one whole wrapper call; the launches per
    wrapper call; and, for right-hand sides within one 8-column panel
    (the single-launch design's cap), the A/B against the earlier
    single-launch design in turns (old, new, new, old), or, for wider
    ones, the A/B of the refine phase on tiled products against the
    earlier one on skinny 8-column panels in series, in turns. Returns the
    pipeline's phase times, in ms."""
    B, n, k = Bn.shape
    stream = torch.cuda.current_stream().cuda_stream

    def run(launch):
        rc = launch()
        if rc != 0:
            fail(f"solve pipeline: launch returned cudaError {rc}")

    bufs = mk._mega_solve_buffers(lib, Sn, Bn)
    phases = mk._mega_solve_phases(lib, Sn, Bn, bufs, j1, j2, refine,
                                   stream)
    S, ws = Sn.data_ptr(), bufs[3].data_ptr()
    one_block = dict(phases)
    one_block["inverse"] = (
        lambda: lib.mega_solve_inverse_single_block_launch(ws, B, n, k,
                                                           stream))
    for p, name in enumerate(mk.SOLVE_PRODUCTS):
        one_block[f"product {name}"] = (
            lambda p=p: lib.mega_solve_product_single_block_launch(
                S, ws, B, n, k, p, stream))
    # fill the workspace once: each phase alone then reads valid inputs
    for _, launch in phases:
        run(launch)
    torch.cuda.synchronize()
    print(f"{label}: {len(phases)} CUDA launches per wrapper call "
          f"({', '.join(name for name, _ in phases)})")
    split = {}
    for design, table in (("pipeline", dict(phases)),
                          ("one block per walker", one_block)):
        ms = {name: time_cuda(lambda l=launch: run(l))
              for name, launch in table.items()}
        split[design] = ms
        print(f"{label} phases, {design}, at Sn {tuple(Sn.shape)}, k {k}: "
              + "  ".join(f"{name} {t:.4f}" for name, t in ms.items())
              + f"  sum {sum(ms.values()):.4f} ms (CUDA events, median of "
              f"50 each; whole call {whole_ms:.4f} ms) [{smi}]")

    if k > SINGLE_LAUNCH_KMAX:
        Zs = torch.empty_like(bufs[0])
        R, Zp = Bn.data_ptr(), bufs[0].data_ptr()
        turns = [("panels", lambda: lib.mega_solve_refine_serial_launch(
                      S, R, Zs.data_ptr(), ws, B, n, k, int(refine), stream)),
                 ("tiled", lambda: lib.mega_solve_refine_launch(
                     S, R, Zp, ws, B, n, k, int(refine), stream))]
        turns = turns + turns[::-1]
        ab = [(name, time_cuda(lambda l=launch: run(l)))
              for name, launch in turns]
        # held as hold_last_step holds a kernel: the walkers a float32
        # solve resolves, within ATOL or within ARB_REL of float64
        Za, _, kappa = exact_solve(Sn, Bn)
        torch.cuda.synchronize()
        held = (kappa <= KAPPA_MAX).nonzero().flatten().tolist()
        gaps = (Zs - bufs[0]).abs().amax(dim=(1, 2))
        gap = max((float(gaps[b]) for b in held), default=0.0)
        print(f"{label} refine A/B, skinny 8-column panels in series "
              "(panels) against tiled products over all columns (tiled), "
              "one block per walker each, in turns: "
              + "  ".join(f"{name} {t:.4f}" for name, t in ab)
              + f" ms; panels/tiled "
              f"{(ab[0][1] + ab[3][1]) / (ab[1][1] + ab[2][1]):.2f}x; "
              f"max|panels - tiled| Z {gap:.3e} over the {len(held)} of {B} "
              f"walkers within cond {KAPPA_MAX:g} [{smi}]")
        for b in held:
            lim = ARB_REL * float(Za[b].abs().max())
            if gaps[b] > ATOL and not all(
                    float((Zd[b].double() - Za[b]).abs().max()) <= lim
                    for Zd in (Zs, bufs[0])):
                fail(f"the refine phase's two designs disagree on walker {b}")
        if not held:
            fail("the refine A/B has no walker within the condition bound")
        split["pipeline"]["refine (panels)"] = 0.5 * (ab[0][1] + ab[3][1])
        return split["pipeline"]
    sbufs = mk._mega_solve_buffers(lib, Sn, Bn)
    sptr = [t.data_ptr() for t in sbufs]

    def old():
        run(lambda: lib.mega_solve_single_block_launch(
            S, Bn.data_ptr(), *sptr, B, n, k, float(j1), float(j2),
            int(refine), stream))

    def new():
        mk._mega_solve_cuda(Sn, Bn, j1, j2, refine)

    turns = [("old", old), ("new", new), ("new", new), ("old", old)]
    ab = [(name, time_cuda(fn)) for name, fn in turns]
    Zn, ldn, _ = mk._mega_solve_cuda(Sn, Bn, j1, j2, refine)
    old()
    torch.cuda.synchronize()
    gap = max(float((Zn - sbufs[0]).abs().max()),
              float((ldn - sbufs[1]).abs().max()))
    print(f"{label} A/B, single-launch design (old) against the "
          "pipeline (new), in turns: "
          + "  ".join(f"{name} {t:.4f}" for name, t in ab)
          + f" ms; old/new {(ab[0][1] + ab[3][1]) / (ab[1][1] + ab[2][1]):.2f}"
          f"x; max|old - new| {gap:.3e} [{smi}]")
    if not gap <= ATOL:
        fail("the pipeline and the single-launch design disagree")
    return split["pipeline"]


def like_inputs(torch, dev, ntoa, nb, B, k, seed):
    """Random likelihood-kernel inputs (``tests/test_torch_megakernel.py``'s
    ``_like_inputs``): a basis of unit-scale columns, weights, scales and
    prior terms near 1."""
    import numpy as np
    rng = np.random.default_rng(seed)
    S = (rng.standard_normal((ntoa, nb)) / np.sqrt(ntoa)).astype(np.float32)
    w = (1.0 + 0.3 * rng.random((B, ntoa))).astype(np.float32)
    s = (0.8 + 0.4 * rng.random((B, nb))).astype(np.float32)
    ivb = (0.5 + rng.random((B, nb))).astype(np.float32)
    Bn = rng.standard_normal((B, nb, k)).astype(np.float32)
    return [torch.as_tensor(a, device=dev) for a in (S, w, s, ivb, Bn)]


def like_tier_fixture(torch, dev, n=120, k=4):
    """All three tiers through the likelihood kernel at nb = n: a stacked
    basis S (3n, n) whose block b walker b alone weights (w = 1 on its n
    rows, 0 elsewhere; s = 1), so Sn_b = S_b^T S_b + diag(ivb_b). Walker 0
    is a unit-diagonal SPD matrix (S_0 its Cholesky factor, ivb 0); walker
    1 the three-tier fixture's matrix with smallest eigenvalue -5e-5
    (S_1 = diag(sqrt(ev + 5e-5)) Q^T, ivb -5e-5), indefinite at the first
    jitter and PD at the second; walker 2 is -I (S_2 = 0, ivb -1). The
    right-hand sides are Bn_b = Sn_b X_b (float64) for a standard normal
    X_b, so the solutions are O(1), as on the path."""
    import numpy as np
    rng = np.random.default_rng(13)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    ev = np.linspace(0.5, 1.5, n)
    ev[0] = -5e-5
    A = np.random.default_rng(2).standard_normal((n, n))
    S0 = A @ A.T / n + 0.5 * np.eye(n)
    d = np.sqrt(np.diag(S0))
    S0 = S0 / d[:, None] / d[None, :]
    S = np.zeros((3 * n, n))
    S[:n] = np.linalg.cholesky(S0).T
    S[n:2 * n] = np.sqrt(ev + 5e-5)[:, None] * Q.T
    w = np.zeros((3, 3 * n))
    for b in range(3):
        w[b, b * n:(b + 1) * n] = 1.0
    ivb = np.stack([np.zeros(n), np.full(n, -5e-5), np.full(n, -1.0)])
    Sn = np.stack([S[b * n:(b + 1) * n].T @ S[b * n:(b + 1) * n]
                   + np.diag(ivb[b]) for b in range(3)])
    Bn = Sn @ rng.standard_normal((3, n, k))
    return [torch.as_tensor(a.astype(np.float32), device=dev)
            for a in (S, w, np.ones((3, n)), ivb, Bn)]


def like_single_block(torch, lib, args):
    """The earlier single-launch likelihood kernel on ``args``: returns
    ``(launch, (Z, ld, tier))``; each ``launch()`` runs it once."""
    S32, w, s, ivb, Bn, j1, j2, refine = args
    B, nb, k = Bn.shape
    ntoa, dev = S32.shape[0], Bn.device
    ws = torch.empty(int(lib.mega_like_single_block_ws_floats(ntoa, nb, k))
                     * B, dtype=torch.float32, device=dev)
    out = (torch.empty((B, nb, k), dtype=torch.float32, device=dev),
           torch.empty((B,), dtype=torch.float32, device=dev),
           torch.empty((B,), dtype=torch.int32, device=dev))
    held = (S32, w, s, ivb, Bn, *out, ws)   # alive as long as launch
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        rc = lib.mega_like_single_block_launch(
            *(t.data_ptr() for t in held), B, ntoa, nb, k, float(j1),
            float(j2), int(refine), stream)
        if rc != 0:
            fail(f"mega_like_single_block_launch returned cudaError {rc}")
    return launch, out


def hold_like_fixture(torch, mk, lib, label, args, expect=None):
    """The likelihood pipeline on a fixture against its plain version and
    the single-launch design (``Z`` and ``ld`` within ATOL); ``expect``:
    the tiers it must reach."""
    Zk, ldk, tk = mk._mega_like_cuda(*args)
    Zp, ldp = mk._mega_like_torch(*args)
    old, (Zo, ldo, _) = like_single_block(torch, lib, args)
    old()
    torch.cuda.synchronize()
    ep = max(float((Zk - Zp).abs().max()), float((ldk - ldp).abs().max()))
    eo = max(float((Zk - Zo).abs().max()), float((ldk - ldo).abs().max()))
    print(f"mega_like {label}: tiers {tk.tolist()} max|new - plain| {ep:.3e}"
          f" max|new - old| {eo:.3e} (max|Z| {float(Zp.abs().max()):.3e})")
    if expect is not None and tk.tolist() != expect:
        fail(f"mega_like {label}: tiers {tk.tolist()}, expected {expect}")
    if not (torch.isfinite(Zk).all() and torch.isfinite(ldk).all()):
        fail(f"mega_like {label}: non-finite kernel output")
    if not (ep <= ATOL and eo <= ATOL):
        fail(f"mega_like {label}: the pipeline differs by more than atol "
             f"{ATOL}")


def like_pipeline(torch, mk, lib, args, entry, whole_ms, smi):
    """The likelihood pipeline's launches on one captured input. Stage A:
    the Gram prologue alone as a one-block-per-walker launch, then the
    solve pipeline's phases as they are (the global-memory factor). Stage
    B: the pipeline's own phases, the tiled Gram and the shared-memory
    factor (also timed at 256, 512 and 1024 threads), then the same solve
    phases. Each phase's time alone, CUDA events, median of 50; whether
    the two Grams' Sn and the two factors' U agree bit for bit; whether
    Stage B phase by phase gives one wrapper call's result bit for bit;
    Stage B back to back on one stream against one forked C call; and the
    A/B against the single-launch design in turns (old, new, new, old).
    Returns those times, in ms."""
    S32, w, s, ivb, Bn, j1, j2, refine = args
    B, nb, k = Bn.shape
    ntoa = S32.shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    nt = int(lib.mega_like_factor_threads())

    def run(launch):
        rc = launch()
        if rc != 0:
            fail(f"{entry} pipeline: launch returned cudaError {rc}")

    Z, ld, tier, ws, Sn = bufs = mk._mega_like_buffers(lib, Bn)
    ptr = [t.data_ptr() for t in (S32, w, s, ivb)]
    solve = mk._mega_solve_phases(lib, Sn, Bn, bufs[:4], j1, j2, refine,
                                  stream)
    ss = torch.empty(B * ntoa * nb, dtype=torch.float32, device=Bn.device)

    def factor(threads):
        return lambda: lib.mega_like_factor_launch(
            Sn.data_ptr(), tier.data_ptr(), ws.data_ptr(), B, nb, k,
            float(j1), float(j2), threads, stream)

    stage_a = [("gram", lambda: lib.mega_like_gram_single_block_launch(
        *ptr, Sn.data_ptr(), ss.data_ptr(), B, ntoa, nb, stream))] + solve
    stage_b = [("gram", lambda: lib.mega_like_gram_launch(
        *ptr, Sn.data_ptr(), B, ntoa, nb, stream)),
        ("factor", factor(nt))] + solve[1:]
    sw, nn = int(lib.mega_solve_ws_floats(nb, k)), nb * nb
    U = ws[:B * sw].view(B, sw)[:, nn:2 * nn]

    # Stage A once: its Sn, U and tiers
    for _, launch in stage_a:
        run(launch)
    torch.cuda.synchronize()
    sn_a, u_a, tier_a = Sn.clone(), U.clone(), tier.clone()
    # Stage B phase by phase, then one wrapper call on the same inputs
    for _, launch in stage_b:
        run(launch)
    torch.cuda.synchronize()
    sn_eq = bool(torch.equal(Sn, sn_a))
    u_eq = {}
    for threads in (256, 512, 1024):
        U.fill_(float("nan"))
        run(factor(threads))
        torch.cuda.synchronize()
        u_eq[threads] = bool(torch.equal(U, u_a) and torch.equal(tier,
                                                                  tier_a))
    for _, launch in stage_b:
        run(launch)
    torch.cuda.synchronize()
    Zw, ldw, tw = mk._mega_like_cuda(*args)
    torch.cuda.synchronize()
    call_eq = bool(torch.equal(Zw, Z) and torch.equal(ldw, ld)
                   and torch.equal(tw, tier))
    print(f"{entry}: {len(stage_b)} CUDA launches per wrapper call, one C "
          f"call ({', '.join(name for name, _ in stage_b)}); tiled Gram's Sn"
          f" bit-equal to the one-block prologue's: {sn_eq}; shared-memory "
          f"factor's U bit-equal to solve_factor_kernel's: "
          + ", ".join(f"{t} threads {e}" for t, e in u_eq.items())
          + f"; phase by phase bit-equal to one wrapper call: {call_eq}")
    if not (sn_eq and all(u_eq.values()) and call_eq):
        fail(f"{entry}: the pipeline's phases disagree with their "
             "baselines bit for bit")

    tables = {}
    for label, phases in (("Stage A", stage_a), ("Stage B", stage_b)):
        ms = {name: time_cuda(lambda l=launch: run(l))
              for name, launch in phases}
        tables[label] = ms
        print(f"{entry} phases, {label}, at S {tuple(S32.shape)} Bn "
              f"{tuple(Bn.shape)}: "
              + "  ".join(f"{name} {t:.4f}" for name, t in ms.items())
              + f"  sum {sum(ms.values()):.4f} ms (CUDA events, median of "
              f"50 each; whole call {whole_ms:.4f} ms) [{smi}]")
    fms = {t: time_cuda(lambda t=t: run(factor(t))) for t in (256, 512, 1024)}
    print(f"{entry} shared-memory factor by threads: "
          + "  ".join(f"{t} {v:.4f}" for t, v in fms.items())
          + f" ms (pipeline uses {nt}) [{smi}]")

    # the designs themselves, each one bare C call on preallocated buffers
    # (the wrapper's checks and allocations left out), CUDA events around
    # one call: the pipeline, its phases back to back on one stream, and
    # the single-launch design
    def new():
        run(lambda: lib.mega_like_launch(
            *ptr, Bn.data_ptr(), *(t.data_ptr() for t in bufs[:4]), B, ntoa,
            nb, k, float(j1), float(j2), int(refine), stream))

    def serial():
        for _, launch in stage_b:
            run(launch)

    old, (Zo, ldo, _) = like_single_block(torch, lib, args)
    serial_ms = time_cuda(serial)
    turns = [("old", old), ("new", new), ("new", new), ("old", old)]
    ab = [(name, time_cuda(fn)) for name, fn in turns]
    new()
    old()
    torch.cuda.synchronize()
    gap = max(float((Z - Zo).abs().max()), float((ld - ldo).abs().max()))
    old_ms = (ab[0][1] + ab[3][1]) / 2
    new_ms = (ab[1][1] + ab[2][1]) / 2
    print(f"{entry} A/B, single-launch design (old) against the pipeline "
          "(new), one bare C call each, in turns: "
          + "  ".join(f"{name} {t:.4f}" for name, t in ab)
          + f" ms; old/new {old_ms / new_ms:.2f}x; max|old - new| "
          f"{gap:.3e}; the pipeline's phases back to back on one stream "
          f"{serial_ms:.4f} ms (the fork saves {serial_ms - new_ms:.4f}); "
          f"the wrapper call {whole_ms:.4f} ms [{smi}]")
    if not gap <= ATOL:
        fail(f"{entry}: the pipeline and the single-launch design disagree")
    return dict(phases_ms=tables["Stage B"], stage_a_ms=tables["Stage A"],
                single_block_ms=old_ms, bare_call_ms=new_ms,
                serial_ms=serial_ms)


def precond_buffers(torch, B, n, dev):
    """``(U, V, E, tier)`` buffers of one preconditioner call."""
    return [torch.empty((B, n, n), dtype=torch.float32, device=dev)
            for _ in range(3)] + [torch.empty((B,), dtype=torch.int32,
                                              device=dev)]


def precond_calls(torch, lib, S, j1, j2):
    """Bare C calls of the preconditioner's two designs on ``S``, each on
    its own preallocated buffers: ``(old, new, out_old, out_new)``;
    ``old()`` runs ``chol_precond_kernel`` (global workspace), ``new()``
    the shared-memory kernel as the package launches it, ``new(p)`` its
    chain up to phase ``p`` only."""
    B, n = S.shape[0], S.shape[-1]
    stream = torch.cuda.current_stream().cuda_stream
    out_o = precond_buffers(torch, B, n, S.device)
    out_n = precond_buffers(torch, B, n, S.device)
    ws = torch.empty(int(lib.chol_precond_ws_floats(n)) * B,
                     dtype=torch.float32, device=S.device)
    po = [t.data_ptr() for t in out_o]
    pn = [t.data_ptr() for t in out_n]
    held = (S, ws)   # alive as long as the calls

    def check_rc(rc, name):
        if rc != 0:
            fail(f"{name} returned cudaError {rc}")

    def old():
        check_rc(lib.chol_precond_launch(held[0].data_ptr(), *po,
                                         held[1].data_ptr(), B, n, float(j1),
                                         float(j2), stream),
                 "chol_precond_launch")

    def new(phases=None):
        if phases is None:
            check_rc(lib.chol_precond_smem_launch(
                held[0].data_ptr(), *pn, B, n, float(j1), float(j2), stream),
                "chol_precond_smem_launch")
        else:
            check_rc(lib.chol_precond_smem_phases_launch(
                held[0].data_ptr(), *pn, B, n, float(j1), float(j2), phases,
                stream), "chol_precond_smem_phases_launch")
    return old, new, out_o, out_n


def e_errors(S, U, V, D, K, E):
    """E's float32 error product by product, against float64 products of
    the same float32 ``U`` and ``V``: ``D``, ``K`` and ``E`` against
    ``D64 = Sn - U^T U``, ``K64 = V^T D64`` and ``E64 = K64 V`` (the
    error so far); ``K`` against ``V^T D`` and ``E`` against ``K V`` in
    float64 (what that product alone adds); and ``V^T (D - D64) V``,
    what D's error alone makes of E."""
    d = [t.double() for t in (S, U, V, D, K, E)]
    S64, U64, V64, D32, K32, E32 = d
    D64 = S64 - U64.mT @ U64
    K64 = V64.mT @ D64

    def mx(t):
        return float(t.abs().max())
    return {"D": mx(D32 - D64), "K": mx(K32 - K64),
            "E": mx(E32 - K64 @ V64),
            "K alone": mx(K32 - V64.mT @ D32),
            "E alone": mx(E32 - K32 @ V64),
            "D's error in E": mx(V64.mT @ (D32 - D64) @ V64)}


def e_own_share(S, U, V, E):
    """How much of its limit (``E_OWN_RTOL``, ``E_OWN_ATOL``) E uses in
    the worst walker, against ``V^T (Sn - U^T U) V`` formed in float64
    from the same float32 ``U`` and ``V``: above 1 (or NaN) fails."""
    S64, U64, V64, E32 = (t.double() for t in (S, U, V, E))
    E64 = V64.mT @ (S64 - U64.mT @ U64) @ V64
    err = (E32 - E64).abs().amax((-2, -1))
    lim = E_OWN_RTOL * E64.abs().amax((-2, -1)) + E_OWN_ATOL
    return float((err / lim).max())


def precond_designs(torch, cf, lib, entry, S, j1, j2, whole_ms, smi):
    """The preconditioner's designs on one captured input. Stage A: the
    old kernel's routines run alone as the solve pipeline's one-block
    phase kernels on its workspace (``chol_upper``, ``backsub_inv``, then
    ``block_gemm`` for ``D = Sn - U^T U``, ``K = V^T D``, ``E = K V``),
    each timed, their sum beside the old kernel's whole call. E's error
    product by product (:func:`e_errors`) for those routines, for the
    shared-memory kernel (``D`` and ``K`` from its phases 2 and 3) and
    for the plain version (``_trio``'s products). Stage B: the
    shared-memory kernel's phases, each the difference of two prefix
    launches. The whole call, old against new, as bare C calls in turns
    (old, new, new, old). Returns the times, in ms."""
    B, n = S.shape[0], S.shape[-1]
    stream = torch.cuda.current_stream().cuda_stream
    sp = S.data_ptr()

    def run(launch):
        rc = launch()
        if rc != 0:
            fail(f"{entry}: launch returned cudaError {rc}")

    sw, nn = int(lib.mega_solve_ws_floats(n, 1)), n * n
    ws = torch.empty(B * sw, dtype=torch.float32, device=S.device)
    wt = torch.empty((B,), dtype=torch.int32, device=S.device)
    wp = ws.data_ptr()

    def slot(s):   # the solve workspace's X, U, V, W1, W2 = 0 .. 4
        return ws.view(B, sw)[:, s * nn:(s + 1) * nn].reshape(B, n, n)

    stage_a = [
        ("factor", lambda: lib.mega_solve_factor_launch(
            sp, wt.data_ptr(), wp, B, n, 1, float(j1), float(j2), stream)),
        ("inverse", lambda: lib.mega_solve_inverse_single_block_launch(
            wp, B, n, 1, stream))]
    for p, name in enumerate("DKE"):
        stage_a.append((f"product {name}", lambda p=p: (
            lib.mega_solve_product_single_block_launch(sp, wp, B, n, 1, p,
                                                       stream))))
    for _, launch in stage_a[:3]:
        run(launch)
    torch.cuda.synchronize()
    D_a = slot(3).clone()
    for _, launch in stage_a[3:]:
        run(launch)
    torch.cuda.synchronize()
    parts = {"old routines": (slot(1).clone(), slot(2).clone(), D_a,
                              slot(4).clone(), slot(3).clone())}
    old, new, out_o, out_n = precond_calls(torch, lib, S, j1, j2)
    mid = []
    for p in (2, 3, None):
        new(p)
        torch.cuda.synchronize()
        mid.append(out_n[2].clone())
    parts["shared-memory kernel"] = (out_n[0].clone(), out_n[1].clone(),
                                     *mid)
    Up, Vp, _ = cf._fused_torch(S, j1, j2)
    L, Linv = Up.mT, Vp.mT
    Dp = S - L @ L.mT
    Kp = Linv @ Dp
    parts["plain"] = (Up, Vp, Dp, Kp, Kp @ Linv.mT)
    torch.cuda.synchronize()
    for label, (U, V, D, K, E) in parts.items():
        errs = e_errors(S, U, V, D, K, E)
        print(f"{entry} E's error by product, {label}, against float64 "
              "products of its own U and V: "
              + "  ".join(f"{k} {v:.3e}" for k, v in errs.items()))

    ms_a = {name: time_cuda(lambda l=launch: run(l))
            for name, launch in stage_a}
    old_ms = time_cuda(old)
    print(f"{entry} Stage A, the old kernel's routines alone at Sn "
          f"{tuple(S.shape)}: "
          + "  ".join(f"{k} {v:.4f}" for k, v in ms_a.items())
          + f"  sum {sum(ms_a.values()):.4f} ms; the old kernel's whole "
          f"call {old_ms:.4f} ms (CUDA events, median of 50 each) [{smi}]")
    pre = [time_cuda(lambda p=p: new(p)) for p in range(1, 5)]
    names = ("factor", "inverse beside D", "K", "E")
    ms_b = {name: pre[i] - (pre[i - 1] if i else 0.0)
            for i, name in enumerate(names)}
    print(f"{entry} Stage B, the shared-memory kernel's phases (prefix "
          "launches 1..4: "
          + " ".join(f"{t:.4f}" for t in pre) + " ms; differences: "
          + "  ".join(f"{k} {v:.4f}" for k, v in ms_b.items())
          + f" ms) [{smi}]")
    turns = [("old", old), ("new", new), ("new", new), ("old", old)]
    ab = [(name, time_cuda(fn)) for name, fn in turns]
    old_ab = (ab[0][1] + ab[3][1]) / 2
    new_ab = (ab[1][1] + ab[2][1]) / 2
    print(f"{entry} A/B, global-memory design (old) against the "
          "shared-memory kernel (new), one bare C call each, in turns: "
          + "  ".join(f"{name} {t:.4f}" for name, t in ab)
          + f" ms; old/new {old_ab / new_ab:.2f}x; the wrapper call "
          f"{whole_ms:.4f} ms [{smi}]")
    return dict(phases_ms=ms_b, stage_a_ms=ms_a, bare_call_ms=new_ab,
                global_design_ms=old_ab)


def hold_precond(torch, cf, entry, S, j1, j2, trio_k, tiers):
    """The preconditioner kernel's trio against its plain version on the
    same input: the reference's limits, or, where the input's
    conditioning puts both float32 versions further than that from
    float64, the kernel at most twice as far from float64 as the plain
    version, plus the limit. Returns the largest |kernel - plain|."""
    trio_p = cf._fused_torch(S, j1, j2)
    trio_f = cf._fused_torch(S.double(), j1, j2)
    torch.cuda.synchronize()
    err = [float((k - p).abs().max()) for k, p in zip(trio_k, trio_p)]
    # each float32 version's distance from the float64 trio
    errk = [float((k.double() - f).abs().max())
            for k, f in zip(trio_k, trio_f)]
    errp = [float((p.double() - f).abs().max())
            for p, f in zip(trio_p, trio_f)]
    line = "  ".join(
        f"{x}: |k-p| {e:.3e} |k-f64| {ek:.3e} |p-f64| {ep:.3e} "
        f"max|{x}| {float(p.abs().max()):.3e}"
        for x, e, ek, ep, p in zip("UVE", err, errk, errp, trio_p))
    print(f"{entry} at {tuple(S.shape)}: walkers per tier "
          f"{dict(sorted(collections.Counter(tiers).items()))}; {line}")
    if not all(torch.isfinite(t).all() for t in trio_k):
        fail(f"{entry}: non-finite kernel output")
    for x, e, ek, ep, t in zip("UVE", err, errk, errp, CHOL_ATOL):
        if not (e <= t or ek <= 2.0 * ep + t):
            fail(f"{entry}: {x} of the kernel and the plain version "
                 f"differ by {e:.3e} (limit {t}), and the kernel is "
                 f"{ek:.3e} from float64 against the plain "
                 f"version's {ep:.3e}")
    return max(err)


def hold_precond_run(torch, cf, entry, S, j1, j2, dev):
    """A sampler run's last input ``S`` of the preconditioner kernel held
    against its plain version (:func:`hold_precond`) on the walkers at an
    equilibrated condition of at most KAPPA_MAX; the others are reported,
    not held. Returns ``(max |kernel - plain| held, tiers)``."""
    *trio_k, tk = cf._chol_precond_cuda(S, j1, j2)
    tiers = tk.tolist()
    ev = torch.linalg.eigvalsh(S.double())
    cond = (ev.abs().amax(dim=-1) / ev.amin(dim=-1).clamp(min=1e-300))
    cond = torch.where(ev.amin(dim=-1) > 0, cond,
                       torch.full_like(cond, float("inf"))).cpu()
    held = [i for i in range(S.shape[0]) if cond[i] <= KAPPA_MAX]
    print(f"{entry} inputs: condition per walker "
          f"{[float(f'{c:.3g}') for c in cond.tolist()]}; held "
          f"{len(held)} of {S.shape[0]}")
    err = 0.0
    if held:
        idx = torch.as_tensor(held, device=dev)
        err = hold_precond(torch, cf, entry, S[idx], j1, j2,
                           [t[idx] for t in trio_k],
                           [tiers[i] for i in held])
    if len(held) < S.shape[0]:
        idx = torch.as_tensor([i for i in range(S.shape[0])
                               if i not in held], device=dev)
        trio_p = cf._fused_torch(S[idx], j1, j2)
        print(f"{entry}, walkers above the bound (reported): |k-p| of U, "
              f"V, E {[float((k[idx] - p).abs().max()) for k, p in zip(trio_k, trio_p)]}")
    return err, tiers


def spd_batch(torch, dev, B, n, seed):
    """Unit-diagonal SPD float32 batch (``tests/test_cholfuse.py``)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for i in range(B):
        A = rng.standard_normal((n, n))
        S = A @ A.T / n + np.eye(n) * (0.5 + 0.1 * i)
        d = np.sqrt(np.diag(S))
        out.append(S / d[:, None] / d[None, :])
    return torch.as_tensor(np.stack(out).astype(np.float32), device=dev)


def guard_fixture(torch, dev, n=20, k=16):
    """Two walkers on the identity preconditioner (tier 3: Sn has the
    eigenvalue -0.3), whose refinement converges on columns 0-7 and
    diverges on columns 8-15: walker 0's residual summed over all columns
    falls (the guard keeps the refined Z everywhere), walker 1's rises
    (it reverts to Z0 = Bn everywhere). A guard taken panel by panel
    would split both (``tests/test_torch_megakernel.py``)."""
    import numpy as np
    rng = np.random.default_rng(29)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    ev = np.linspace(0.6, 1.4, n)
    ev[0] = -0.3
    S = (Q * ev) @ Q.T

    def cols(amp_stable, amp_unstable, m):
        c = rng.standard_normal((n, m)) * amp_stable
        c[0] = amp_unstable * rng.choice([-1.0, 1.0], m)
        return Q @ c
    keep = np.concatenate([cols(1.0, 0.0, 8), cols(0.02, 0.1, k - 8)], 1)
    revert = np.concatenate([cols(0.02, 0.0, 8), cols(0.02, 0.1, k - 8)], 1)
    return (torch.as_tensor(np.stack([S, S]).astype(np.float32), device=dev),
            torch.as_tensor(np.stack([keep, revert]).astype(np.float32),
                            device=dev))


def wide_like_args(torch, args, ntm=32, seed=33, W=8):
    """The likelihood kernel's inputs of a real path (``args``: S, w, s,
    ivb, Bn, j1, j2, refine) for its first ``W`` walkers, with the
    right-hand side of a seeded ``ntm``-column timing model: ``Bn = s
    (S^T diag(w) [r | M])``, k = 1 + ntm, formed in float64."""
    import numpy as np
    S32 = args[0]
    w, s, ivb = (a[:W] for a in args[1:4])
    rng = np.random.default_rng(seed)
    U = torch.as_tensor(rng.standard_normal((S32.shape[0], 1 + ntm)),
                        dtype=torch.float64, device=S32.device)
    Sw = S32.double()[None] * w.double()[:, :, None]
    Bn = (s.double()[:, :, None] * (Sw.transpose(1, 2) @ U)).float()
    return (S32, w.contiguous(), s.contiguous(), ivb.contiguous(),
            Bn.contiguous(), *args[5:])


def north_star_problem(gram_mode, dev):
    """The north star's single-pulsar problem, a copy of
    ``tools/north_star.py:build_problem`` on the port: J1832-0836's scale
    (334 TOAs, four backends, three radio frequencies), white noise
    (efac 1.2, equad -6.5) and a red process (log10_A -13, gamma 3.5, 20
    modes) injected from the same numpy generators, and the model efac +
    equad by backend, spin and DM noise of 20 frequencies: 12 parameters.
    """
    from enterprise_warp_tpu_torch.models import (StandardModels, TermList,
                                                  build_pulsar_likelihood)
    from enterprise_warp_tpu_torch.sim.noise import (inject_basis_process,
                                                     inject_white,
                                                     make_fake_pulsar)
    import numpy as np
    psr = make_fake_pulsar(name="J1832-0836", ntoa=334,
                           backends=("CPSR2m", "CPSR2n", "CASPSR", "DFB"),
                           freqs_mhz=(700.0, 1400.0, 3100.0), seed=11)
    psr.residuals = 0.0 * psr.toaerrs
    inject_white(psr, efac=1.2, equad_log10=-6.5,
                 rng=np.random.default_rng(1))
    inject_basis_process(psr, log10_A=-13.0, gamma=3.5, components=20,
                         rng=np.random.default_rng(2))
    m = StandardModels(psr=psr)
    terms = TermList(psr, [m.efac("by_backend"), m.equad("by_backend"),
                           m.spin_noise("powerlaw_20_nfreqs"),
                           m.dm_noise("powerlaw_20_nfreqs")])
    return build_pulsar_likelihood(psr, terms, gram_mode=gram_mode,
                                   device=dev)


def run_north_star(dev, outdir):
    """The north star's pipeline leg on the port, as
    ``tools/north_star.py:run_leg`` drives it: :func:`north_star_problem`
    at ``gram_mode="split"``, ``PTSampler`` with ``NORTH_STAR_SAMPLER``,
    ``anneal_init`` with ``NORTH_STAR_ANNEAL``, then
    ``sample_to_convergence`` with ``NORTH_STAR_GATE`` up to
    ``NORTH_STAR_MAX_STEPS``. Returns the report, the sampler, the
    leg's posterior in ``NORTH_STAR.json``'s form (``mean_err =
    std / sqrt(ESS)``, as the reference computes it) and the wall times
    of its parts (the anneal, the blocks, the chain-file writes on the
    sampler's writer thread, which overlap the next block, the per-block
    host fits and the convergence checks), in seconds."""
    import torch
    from enterprise_warp_tpu_torch.samplers import PTSampler
    from enterprise_warp_tpu_torch.samplers import convergence
    from enterprise_warp_tpu_torch.samplers import ptmcmc
    parts = collections.Counter()

    def timed(key, fn, sync=False):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            parts[key] += time.perf_counter() - t0
            return out
        return run

    t0 = time.perf_counter()
    like = north_star_problem("split", dev)
    parts["build_s"] = time.perf_counter() - t0
    sampler = PTSampler(like, outdir, **NORTH_STAR_SAMPLER)
    sampler._run_block = timed("blocks_s", sampler._run_block, sync=True)
    sampler._host_prep = timed("host_fits_s", sampler._host_prep)
    saved = (ptmcmc.write_table, convergence.summarize_chains)
    ptmcmc.write_table = timed("chain_writes_s", ptmcmc.write_table)
    convergence.summarize_chains = timed("checks_s",
                                         convergence.summarize_chains)
    checks = []
    try:
        t0 = time.perf_counter()
        sampler.anneal_init(verbose=False, **NORTH_STAR_ANNEAL)
        torch.cuda.synchronize()
        parts["anneal_s"] = time.perf_counter() - t0
        parts["blocks_s"] = 0.0
        rep = convergence.sample_to_convergence(
            sampler, max_steps=NORTH_STAR_MAX_STEPS, verbose=False,
            on_check=lambda *a: checks.append(a), **NORTH_STAR_GATE)
    finally:
        ptmcmc.write_table, convergence.summarize_chains = saved
    posterior = {k: {"mean": v["mean"], "std": v["std"],
                     "mean_err": v["std"] / max(v["ess"], 1.0) ** 0.5}
                 for k, v in rep.summary.items() if not k.startswith("_")}
    parts["checks"] = len(checks)
    return rep, sampler, posterior, dict(parts)


def profile_block(sampler, start, steps):
    """One more block of ``steps`` PT steps of ``sampler`` (continuing its
    run from step ``start``) under ``torch.profiler``: the block's wall time, the device time
    summed over its kernels, their ratio (the device's busy share; kernels
    on two streams at once would count twice) and the kernels that took
    most device time. ``None`` for the device figures where the profiler
    records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    act = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=act) as prof:
        t0 = time.perf_counter()
        sampler.sample(start + steps, resume=True, verbose=False,
                       block_size=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0.0))
    # the kernels themselves (a CPU op's device time repeats its kernels')
    ev = [e for e in prof.key_averages()
          if getattr(e, "device_type", None) == DeviceType.CUDA
          and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in ev) * 1e-6
    top = sorted(ev, key=dev_us, reverse=True)[:8]
    return dict(steps=steps, wall_s=wall,
                device_s=busy if ev else None,
                busy_share=busy / wall if ev else None,
                top=[(e.key[:60], e.count, round(dev_us(e) * 1e-3, 3))
                     for e in top])


def posterior_match(leg, cpu_leg):
    """A copy of ``tools/north_star.py:_posterior_match``: the worst mean
    shift (in the larger sigma) and the worst width ratio of a leg's
    posterior against the float64 CPU leg's, each also discounted by 2
    sigma of the estimators' own noise (``mean_err``, ``std_err`` where a
    leg reports them); ``match`` at the reference's gates, adjusted shift
    <= 0.25 and adjusted ratio <= 1.25."""
    worst_mean, worst_mean_adj = 0.0, 0.0
    worst_ratio, worst_adj = 1.0, 1.0
    for k, d in leg["posterior"].items():
        c = cpu_leg["posterior"][k]
        s = max(d["std"], c["std"], 1e-12)
        shift = abs(d["mean"] - c["mean"]) / s
        merr = ((d.get("mean_err", 0.0) ** 2
                 + c.get("mean_err", 0.0) ** 2) ** 0.5) / s
        worst_mean = max(worst_mean, shift)
        worst_mean_adj = max(worst_mean_adj,
                             max(0.0, shift - 2.0 * merr))
        r = d["std"] / max(c["std"], 1e-12)
        r = max(r, 1.0 / max(r, 1e-12))
        rel = (d.get("std_err", 0.0) / max(d["std"], 1e-12)
               + c.get("std_err", 0.0) / max(c["std"], 1e-12))
        worst_ratio = max(worst_ratio, r)
        worst_adj = max(worst_adj, r / (1.0 + 2.0 * rel))
    match = worst_mean_adj <= 0.25 and worst_adj <= 1.25
    return dict(match=match,
                mean=round(worst_mean, 3),
                mean_adj=round(worst_mean_adj, 3),
                ratio=round(worst_ratio, 3),
                ratio_adj=round(worst_adj, 3))


def config3_array():
    """BASELINE config 3 at its full size (``tests/test_parallel.py:
    549-567``): ``make_fake_pta(npsr=45, ntoa=1000, seed=45)``, residuals
    ``toaerrs * N(0, 1)`` from ``default_rng(45)``, per pulsar efac and
    equad by backend, spin noise (30 modes), DM noise (20) and a
    Hellings-Downs ``gwb`` (20 modes). Returns ``(psrs, termlists)``."""
    import numpy as np
    from enterprise_warp_tpu_torch.models import StandardModels, TermList
    from enterprise_warp_tpu_torch.sim import make_fake_pta
    psrs = make_fake_pta(**PTA45)
    rng = np.random.default_rng(PTA45["seed"])
    for p in psrs:
        p.residuals = p.toaerrs * rng.standard_normal(len(p))
    tls = []
    for p in psrs:
        m = StandardModels(psr=p)
        tls.append(TermList(p, [
            m.efac("by_backend"), m.equad("by_backend"),
            m.spin_noise("powerlaw_30_nfreqs"),
            m.dm_noise("powerlaw_20_nfreqs"),
            m.gwb("hd_vary_gamma_20_nfreqs")]))
    return psrs, tls


def config3_theta(like, shift=0.0):
    """The reference test's two near-typical points (shift 0 and 0.3)."""
    import numpy as np
    th = np.empty(like.ndim)
    for i, n in enumerate(like.param_names):
        if n.endswith("efac"):
            th[i] = 1.0 + 0.05 * np.sin(i) + shift * 0.05
        elif "equad" in n:
            th[i] = -7.0 + shift * 0.2
        elif n.endswith("log10_A"):
            th[i] = -13.5 + shift
        else:
            th[i] = 3.0 + shift
    return th


def config3_on_disk(tmp):
    """BASELINE config 3 written by the port: the 45 pulsars of
    :func:`config3_array`, residuals and all, through ``save_pulsar_pair``
    into ``tmp/pta45_data``, a noise-model JSON with the same terms
    (``PTA45_MODEL``) and a paramfile (``array_analysis``,
    ``ptmcmcsampler``, ``SHORT_NSAMP`` steps, 8 chains). Every pulsar read back
    must carry the in-memory residuals, compared after projecting out the
    quadratic spin-down both design matrices span, within the larger of
    ``ROUNDTRIP_ATOL`` and twice the loader's float64 pulse-phase
    rounding (``eps * Tspan``). Returns the paramfile's path."""
    import numpy as np
    from enterprise_warp_tpu_torch.io import load_pulsar, save_pulsar_pair
    psrs, _ = config3_array()
    data = os.path.join(tmp, "pta45_data")
    t0 = time.perf_counter()
    for p in psrs:
        save_pulsar_pair(p, data)
    wrote = time.perf_counter() - t0
    t0 = time.perf_counter()
    errs, lims = [], []
    for p in psrs:
        q = load_pulsar(*(os.path.join(data, f"{p.name}.{ext}")
                          for ext in ("par", "tim")))
        M = p.Mmat

        def proj(r):
            return r - M @ np.linalg.lstsq(M, r, rcond=None)[0]
        errs.append(float(np.max(np.abs(proj(q.residuals)
                                        - proj(p.residuals)))))
        lims.append(max(ROUNDTRIP_ATOL, 2 * np.finfo(float).eps * p.Tspan))
        if len(q) != len(p) or not q.phase_connected or \
                not errs[-1] <= lims[-1]:
            fail(f"config 3: {p.name} read back from disk has not the "
                 f"in-memory residuals (max|d| {errs[-1]:.3e} s, limit "
                 f"{lims[-1]:.3e} s)")
    print(f"config 3 on disk: {len(psrs)} pulsars written in {wrote:.2f} s "
          f"and read back in {time.perf_counter() - t0:.2f} s; residuals "
          f"against memory max|d| {max(errs):.3e} s (median "
          f"{statistics.median(errs):.3e}; {sum(e > ROUNDTRIP_ATOL for e in errs)}"
          f" pulsars above the reference's {ROUNDTRIP_ATOL:g} s, all within "
          f"2 eps Tspan = {max(lims):.3e} s)")
    # the native TIM engine against the Python engine on the written files
    from enterprise_warp_tpu_torch import native
    from enterprise_warp_tpu_torch.io.tim import parse_tim
    if native.load() is None:
        fail("config 3: the native IO core is not loaded")
    secs = {"auto": 0.0, "python": 0.0}
    dsec = 0.0
    for p in psrs:
        path = os.path.join(data, f"{p.name}.tim")
        parsed = {}
        for engine in secs:
            t0 = time.perf_counter()
            parsed[engine] = parse_tim(path, engine=engine)
            secs[engine] += time.perf_counter() - t0
        a, b = parsed["auto"], parsed["python"]
        dsec = max(dsec, float(np.max(np.abs(a.sec - b.sec))))
        same = (np.array_equal(a.mjd_int, b.mjd_int)
                and np.array_equal(a.freqs, b.freqs)
                and np.array_equal(a.errs, b.errs)
                and list(a.names) == list(b.names)
                and list(a.sites) == list(b.sites)
                and sorted(a.flags) == sorted(b.flags)
                and all(list(a.flags[k]) == list(b.flags[k]) for k in a.flags))
        if not same or not dsec <= 1e-9:
            fail(f"config 3: the native parse of {p.name}.tim differs from "
                 f"the Python engine's (seconds {dsec:.3e})")
    print(f"config 3 on disk: the {len(psrs)} .tim files parsed by the native "
          f"core in {secs['auto']:.3f} s, by the Python engine in "
          f"{secs['python']:.3f} s; equal (integer MJDs, frequencies, errors, "
          f"names, sites, flags exactly; seconds within {dsec:.1e} s)")
    # what the CLI's set-up spends on the pulsars (load_pulsar: .par, .tim,
    # audit, timing model) through each TIM engine, in turns
    import functools
    from enterprise_warp_tpu_torch.io import pulsar as io_pulsar
    loads = {"auto": [], "python": []}
    try:
        for engine in ("auto", "python", "auto", "python"):
            io_pulsar.parse_tim = functools.partial(parse_tim, engine=engine)
            t0 = time.perf_counter()
            for p in psrs:
                load_pulsar(*(os.path.join(data, f"{p.name}.{ext}")
                              for ext in ("par", "tim")))
            loads[engine].append(time.perf_counter() - t0)
    finally:
        io_pulsar.parse_tim = parse_tim
    print(f"config 3 on disk: the {len(psrs)} pulsars loaded (load_pulsar) "
          f"in {min(loads['auto']):.3f} s through the native TIM engine, "
          f"{min(loads['python']):.3f} s through the Python engine (the "
          f"better of two turns each; turns {loads})")
    nm = os.path.join(tmp, "pta45_noise.json")
    with open(nm, "w") as fh:
        json.dump(PTA45_MODEL, fh)
    path = os.path.join(tmp, "pta45.dat")
    with open(path, "w") as fh:
        fh.write("\n".join([
            f"datadir: {data}", f"out: {os.path.join(tmp, 'out', 'pta45.dat')}",
            "overwrite: True", "array_analysis: True",
            "sampler: ptmcmcsampler", f"nsamp: {SHORT_NSAMP}",
            f"covUpdate: {SHORT_COV_UPDATE}", "{0}",
            f"noise_model_file: {nm}"]) + "\n")
    return path


def corner_attribution(like, params, row, gap, label):
    """The diagnostic printed when a joint chain's largest lnL lies
    outside the class of float64 (``ROADMAP.md`` Queue 3): at ``row`` the
    card's Schur path lies ``gap`` from float64. The cause the reference
    shares is one pulsar's stage 2: its stage-1 solve on the split Gram
    leaves the timing-model Schur complement indefinite, and the relative
    eigenvalue clamp turns it into a huge quadratic form, which reaches
    stage 3 through that pulsar's GW projection (the port redoes such a
    pair in float64). Printed, against the float64 Schur path on the CPU:
    each pulsar's ``q1`` and ``ld_tm`` gaps; it fails unless the gap is
    that signature (the caller fails either way)."""
    import numpy as np
    import torch
    from enterprise_warp_tpu_torch.models.assemble import \
        build_terms_for_model
    from enterprise_warp_tpu_torch.parallel import build_pta_likelihood
    tls = build_terms_for_model(params.models[0], params.psrs,
                                params.noise_model_obj)
    exact = build_pta_likelihood(params.psrs, tls, gram_mode="f64",
                                 joint_mode="schur", device="cpu")
    out = []
    for lk in (like, exact):
        st = lk._stages
        th = lk.as_theta(row)
        com = st["common"](th)
        s12 = st["stage12"](com[0], com[1], com[5])
        out.append({k: s12[k][0].double().cpu().numpy()
                    for k in ("q1", "ld_tm")})
    dq = out[0]["q1"] - out[1]["q1"]
    dt = out[0]["ld_tm"] - out[1]["ld_tm"]
    a = int(np.argmax(np.abs(dt)))
    others = np.delete(np.abs(dq), a)
    names = [p.name for p in params.psrs]
    print(f"{label}: the chain locked on a float32 corner (ROADMAP Queue 3, "
          f"the reference's): lnL {gap:.6g} above float64; against the "
          f"float64 Schur path per pulsar, q1 gaps "
          f"{dict(zip(names, dq.round(4).tolist()))}, ld_tm gaps "
          f"{dict(zip(names, dt.round(4).tolist()))}")
    if not (gap > 0 and abs(dt[a]) > 1.0 and dq[a] > 0
            and np.all(others <= 1.0)):
        fail(f"{label}: the chain's largest lnL lies {gap:.6g} from float64 "
             "and the gap is not the stage-2 corner of one pulsar")


def stage_shares(like, theta, label, smi):
    """A joint likelihood call and its stages timed alone with CUDA
    events (median of 10): the front end (white noise, PSD programs,
    whitened Grams), stages 1-2 (the noise-block solves and the
    timing-model marginalization) and stage 3 (the ORF-coupled Schur
    system); printed with each stage's share of the call."""
    st = like._stages
    th = like.as_theta(theta)
    com = st["common"](th)
    s12 = st["stage12"](com[0], com[1], com[5])
    ms = dict(
        call=time_cuda(lambda: like.loglike_batch(th), warm=2, reps=10),
        front_end=time_cuda(lambda: st["common"](th), warm=2, reps=10),
        stages_1_2=time_cuda(lambda: st["stage12"](com[0], com[1], com[5]),
                             warm=2, reps=10),
        stage_3=time_cuda(lambda: st["stage3"](th, s12, *com[2:5]), warm=2,
                          reps=10))
    print(f"{label}: a likelihood call at W {th.shape[0]} {ms['call']:.3f} ms;"
          + "".join(f" {k} {v:.3f} ms ({100 * v / ms['call']:.1f}%)"
                    for k, v in ms.items() if k != "call")
          + f" (CUDA events, median of 10) [{smi}]")
    return ms


def chain_batches(post, walkers, nbatch=REDO_BATCHES):
    """``nbatch`` batches of ``walkers`` consecutive rows (one thinned
    step of every walker), evenly spaced over a chain's rows ``post``."""
    import numpy as np
    steps = len(post) // walkers
    return [post[i * walkers:(i + 1) * walkers]
            for i in np.linspace(0, steps - 1, nbatch).astype(int)]


def redo_share(like, rows, label, smi):
    """What the float64 redo of flagged pairs costs on a joint chain's
    own rows: a likelihood call (front end, stages 1-2, stage 3) and its
    stages 1-2 alone, timed with the redo off (``corner_c`` None: the
    reference's clamp, no host sync), with its host sync alone
    (``-inf``: the flag is read, no pair redone), below 1e-6 and below
    the shipped ``CORNER_C``; CUDA events, the median of 10 on each of
    ``rows``' batches of W, averaged over the batches. Returns the ms per
    mode."""
    import math

    import numpy as np
    from enterprise_warp_tpu_torch.parallel.pta import CORNER_C
    st = like._stages
    modes = {"off": None, "sync alone": -math.inf, "1e-06": 1e-6,
             f"CORNER_C {CORNER_C:g}": CORNER_C}
    ms = {k: [] for k in modes}
    ms12 = {k: [] for k in modes}
    flagged = {k: 0 for k in modes}
    for batch in rows:
        th = like.as_theta(batch)
        com = st["common"](th)
        ratio = st["stage12"](com[0], com[1], com[5],
                              corner_c=None)["ev_ratio"]
        for k, c in modes.items():
            if c is not None:
                flagged[k] += int((~(ratio >= c)).sum())

            def call(c=c):
                cm = st["common"](th)
                return st["stage3"](th, st["stage12"](cm[0], cm[1], cm[5],
                                                      corner_c=c), *cm[2:5])
            ms[k].append(time_cuda(call, warm=2, reps=10))
            ms12[k].append(time_cuda(
                lambda c=c: st["stage12"](com[0], com[1], com[5],
                                          corner_c=c), warm=2, reps=10))
        del com
    out = {k: dict(call_ms=float(np.mean(ms[k])),
                   stages_1_2_ms=float(np.mean(ms12[k])),
                   pairs_flagged=flagged[k]) for k in modes}
    nwalk = sum(len(b) for b in rows)
    print(f"{label}: the float64 redo's cost on {len(rows)} batches of the "
          f"chain's rows at W {len(rows[0])} ({nwalk * st['npsr']} pairs): "
          + "; ".join(f"{k}: call {v['call_ms']:.3f} ms, stages 1-2 "
                      f"{v['stages_1_2_ms']:.3f} ms, pairs flagged "
                      f"{v['pairs_flagged']}" for k, v in out.items())
          + f" (CUDA events, median of 10 per batch, mean over batches) "
          f"[{smi}]")
    return out


def _gap_stats(lnl, l64, fin):
    """Walkers outside the class of float64, above it, far above it."""
    import numpy as np
    gap = lnl - l64
    out = fin & ~(np.abs(gap) <= JOINT_ATOL + JOINT_RTOL * np.abs(l64))
    return dict(out_of_class=int(out.sum()),
                out_above=int((out & (gap > 0)).sum()),
                far_above=int((fin & (gap > CORNER_FAR)).sum()),
                max_gap_above=float(gap[out].max()) if out.any() else 0.0,
                max_abs_gap=float(np.abs(gap[fin]).max()) if fin.any()
                else 0.0,
                nan=int(np.isnan(lnl).sum()))


def corner_scan(like, oracle, theta, chunk=64):
    """The joint likelihood's float32 corners against float64: score
    ``theta`` (N, ndim) with the Schur path of ``like`` several ways and
    with the dense float64 ``oracle``, and attribute each gap of the
    reference's algebra to its (walker, pulsar) pairs.

    The ways: ``reference``, the reference's algebra (the split Gram and
    the relative eigenvalue clamp); ``clamp``, the port's float64 Gram and
    the clamp; ``repaired``, the port's likelihood (float64 Gram, the
    float64 stage-1 redo of pairs below ``CORNER_C``); ``every_pair_f64``,
    every pair's stage 1 in float64; and the redo below each of
    ``CORNER_THRESHOLDS``. For each, the walkers outside the lnL class of
    float64, above it, and far (``CORNER_FAR``) above it. Per pair:
    ``ev_ratio``, the timing-model complement's smallest eigenvalue over
    its largest magnitude on the port's Gram (what the repair reads) and
    on the reference's, and ``share``, the part of the reference
    algebra's gap that goes when that pair alone takes its
    ``every_pair_f64`` values. Returns ``(summary, arrays)``: the summary
    is JSON-ready (with the split Gram's relative error and what a
    rejection of negative ratios would remove); ``arrays`` holds
    ``lnl_reference``, ``lnl``, ``lnl_f64``, ``ev_ratio``,
    ``ev_ratio_reference`` and ``share``."""
    import math

    import numpy as np
    import torch
    from enterprise_warp_tpu_torch.parallel.pta import CORNER_C
    st = like._stages
    npsr = st["npsr"]
    ways = dict(clamp=None, repaired=CORNER_C, every_pair_f64=math.inf,
                **{f"{c:g}": c for c in CORNER_THRESHOLDS})
    lnl = {k: [] for k in ["reference", *ways]}
    ratio, ratio_ref, share, l64, gram_err = [], [], [], [], 0.0
    for i in range(0, len(theta), chunk):
        th = like.as_theta(theta[i:i + chunk])
        com_ref = st["common"](th, gram="split")
        com = st["common"](th)
        gram_err = max(gram_err, float(
            ((com_ref[0] - com[0]).abs().amax(dim=(-2, -1))
             / com[0].abs().amax(dim=(-2, -1))).max()))
        ref = st["stage12"](com_ref[0], com_ref[1], com_ref[5],
                            corner_c=None)
        lnl["reference"].append(st["stage3"](th, ref, *com[2:5]).cpu())
        outs = {}
        for k, c in ways.items():
            outs[k] = st["stage12"](com[0], com[1], com[5], corner_c=c)
            lnl[k].append(st["stage3"](th, outs[k], *com[2:5]).cpu())
        ratio.append(outs["clamp"]["ev_ratio"].cpu())
        ratio_ref.append(ref["ev_ratio"].cpu())
        lr = lnl["reference"][-1]
        lf = oracle.loglike_batch(th.to(oracle.device)).cpu()
        l64.append(lf)
        sh = torch.empty_like(ratio[-1])
        for a in range(npsr):
            mix = {k: v.clone() for k, v in ref.items()}
            for k in mix:
                mix[k][:, a] = outs["every_pair_f64"][k][:, a]
            sh[:, a] = (lr - st["stage3"](th, mix, *com[2:5]).cpu()) \
                / (lr - lf)
        share.append(sh)
        del com, com_ref, ref, outs
    cat = {k: torch.cat(v).numpy() for k, v in lnl.items()}
    arrays = dict(lnl_reference=cat["reference"], lnl=cat["repaired"],
                  lnl_f64=torch.cat(l64).numpy(),
                  ev_ratio=torch.cat(ratio).numpy(),
                  ev_ratio_reference=torch.cat(ratio_ref).numpy(),
                  share=torch.cat(share).numpy())
    l64, r = arrays["lnl_f64"], arrays["ev_ratio"]
    r_ref = arrays["ev_ratio_reference"]
    fin = np.isfinite(l64)
    gap_r = cat["reference"] - l64
    out_r = fin & ~(np.abs(gap_r) <= JOINT_ATOL + JOINT_RTOL * np.abs(l64))
    carrier = np.argmax(np.nan_to_num(arrays["share"], nan=-np.inf), axis=1)
    r_car = r_ref[np.arange(len(r_ref)), carrier][out_r]
    far = gap_r[out_r] > CORNER_FAR
    r_in = r_ref[fin & ~out_r].min(axis=1)
    neg = (r_ref < 0).any(axis=1)
    summary = dict(
        draws=len(theta), finite_f64=int(fin.sum()),
        split_gram_rel_err=gram_err,
        reference=_gap_stats(cat["reference"], l64, fin),
        **{k: _gap_stats(cat[k], l64, fin) for k in ways},
        flagged=dict(corner_c=CORNER_C, pairs=int(r.size),
                     **{k: int((~(r >= c)).sum()) for k, c in ways.items()
                        if c is not None and c != math.inf}),
        walkers_flagged=int((~(r >= CORNER_C)).any(axis=1).sum()),
        ev_ratio_in_class_min=float(r_in.min()) if r_in.size else None,
        ev_ratio_carriers=dict(
            min=float(r_car.min()) if r_car.size else None,
            max=float(r_car.max()) if r_car.size else None,
            below_corner_c=int((r_car < CORNER_C).sum()),
            far_above_max=float(r_car[far].max()) if far.any() else None),
        reject_negative=dict(walkers=int(neg.sum()),
                             in_class=int((neg & fin & ~out_r).sum())))
    return summary, arrays


def corner_report(like, oracle, theta, label, chunk):
    """The joint likelihood's float32 corners on the card
    (:func:`corner_scan`), printed as one JSON object and returned."""
    t0 = time.perf_counter()
    summary, _ = corner_scan(like, oracle, theta, chunk=chunk)
    print(f"{label}: corner scan of {len(theta)} prior draws in "
          f"{time.perf_counter() - t0:.3f} s: {json.dumps(summary)}")
    return summary


def cache_sequence(like, theta0, nupd, seed, label):
    """Drive ``CachedEvaluator`` through ``nupd`` seeded updates, a
    quarter each of site (one pulsar's parameters), common (the GW
    block), full, and site updates that are then rejected; hold every
    lnL against a full recompute at the same theta within the joint
    class and every rejection to the value before it. Returns the
    evaluator and the largest difference."""
    import numpy as np
    from enterprise_warp_tpu_torch.samplers.evalproto import (
        BLOCK_COMMON, CachedEvaluator)
    pb = np.asarray(like.param_blocks)
    npsr = int(pb.max()) + 1
    rng = np.random.default_rng(seed)
    ev = CachedEvaluator(like, theta0)
    th = ev.theta.copy()

    def full(t):
        return float(like.loglike_batch(t[None])[0])

    worst = abs(ev.lnl - full(th))
    kinds = rng.permutation(np.resize(np.arange(4), nupd))
    for kind in kinds:
        nxt = th.copy()
        if kind in (0, 3):
            a = int(rng.integers(npsr))
            idx = np.nonzero(pb == a)[0]
            nxt[idx] += 0.01 * rng.standard_normal(len(idx))
            mask = ("psr", a)
        elif kind == 1:
            idx = np.nonzero(pb == BLOCK_COMMON)[0]
            nxt[idx] += 0.01 * rng.standard_normal(len(idx))
            mask = ("common",)
        else:
            nxt += 0.002 * rng.standard_normal(len(th))
            mask = None
        before = ev.lnl
        lnl, ref = ev.update(nxt, mask), full(nxt)
        if not abs(lnl - ref) <= JOINT_ATOL + JOINT_RTOL * abs(ref):
            fail(f"{label}: a {mask} update gave lnL {lnl!r} against "
                 f"{ref!r} from a full recompute")
        worst = max(worst, abs(lnl - ref))
        if kind == 3:
            if ev.reject() != before:
                fail(f"{label}: reject did not restore lnL")
        else:
            th = nxt
    print(f"{label}: {len(kinds)} cached updates {ev.counters}, cache hit "
          f"rate {ev.cache_hit_rate:.3f}; largest |cached - full "
          f"recompute| {worst:.3e} (class {JOINT_ATOL:g} + {JOINT_RTOL:g} "
          "|lnL|)")
    return ev, worst


def cache_times(like, ev, label, smi):
    """One site, one common and one full update of the evaluation cache
    at the evaluator's theta, each timed alone (CUDA events, median of
    10), in ms."""
    import torch
    th = torch.as_tensor(ev.theta, dtype=torch.float64, device=like.device)
    cache = ev._cache
    ms = dict(site=time_cuda(lambda: like._cache_site(th, 0, cache), warm=2,
                             reps=10),
              common=time_cuda(lambda: like._cache_common(th, cache),
                               warm=2, reps=10),
              full=time_cuda(lambda: like._cache_init(th), warm=2, reps=10))
    print(f"{label}: one update of the evaluation cache at one theta, "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
          + f" (CUDA events, median of 10) [{smi}]")
    return ms


def os_longdouble(inputs, theta):
    """The optimal statistic's pair values at one draw ``theta`` (ndim,)
    by the reference's algebra (``results/optstat.py:make_os_fn``) in
    numpy long double (x86 80-bit, eps 1.1e-19): a third computation
    beside the card's and the CPU's float64, from the same CPU inputs
    (:func:`os_inputs`; the noise variances from ``os_noise`` in float64).
    Returns ``(rho, sig, kappa)``, ``kappa`` the largest 2-norm condition
    number of a pulsar's equilibrated Sigma (float64 estimate, saturating
    near 1e16); ``rho`` and ``sig`` NaN where a long-double factor
    fails."""
    import numpy as np
    import torch
    from enterprise_warp_tpu_torch.results.optstat import os_noise
    LD = np.longdouble
    per_psr, phihat, _ = inputs

    def chol(A):
        n = len(A)
        L = np.zeros_like(A)
        for j in range(n):
            d = A[j, j] - L[j, :j] @ L[j, :j]
            if not d > 0:
                return None
            L[j, j] = np.sqrt(d)
            L[j + 1:, j] = (A[j + 1:, j] - L[j + 1:, :j] @ L[j, :j]) / L[j, j]
        return L

    def cho_solve(L, B):
        n = len(L)
        y = np.zeros_like(B)
        for i in range(n):
            y[i] = (B[i] - L[i, :i] @ y[:i]) / L[i, i]
        x = np.zeros_like(B)
        for i in range(n - 1, -1, -1):
            x[i] = (y[i] - L[i + 1:, i] @ x[i + 1:]) / L[i, i]
        return x

    ph = phihat.cpu().numpy().astype(LD)
    th = torch.as_tensor(np.asarray(theta, dtype=np.float64)[None])
    X, Z, kappa = [], [], 0.0
    for pp in per_psr:
        nw, phi = os_noise(th, pp)
        w = 1 / nw[0].numpy().astype(LD)
        T = pp["T"].numpy().astype(LD)
        Tw = T * w[:, None]
        S = np.diag(1 / phi[0].numpy().astype(LD)) + np.einsum(
            "ik,il->kl", T, Tw)
        d = 1 / np.sqrt(np.diag(S))
        kappa = max(kappa, float(np.linalg.cond(
            (S * d[:, None] * d[None, :]).astype(np.float64))))
        L = chol(S)
        if L is None:
            nan = np.full(len(per_psr) * (len(per_psr) - 1) // 2, np.nan)
            return nan, nan, kappa
        F = pp["F_w"].numpy().astype(LD)
        y = np.concatenate([pp["r_w"].numpy().astype(LD)[:, None], F],
                           axis=1) * w[:, None]
        Px = np.einsum("ik,il->kl", F,
                       y - Tw @ cho_solve(L, np.einsum("ik,il->kl", T, y)))
        X.append(Px[:, 0])
        Z.append(Px[:, 1:] * ph)                        # Z_a phihat
    rho, sig = [], []
    for a in range(len(X)):
        for b in range(a + 1, len(X)):
            den = np.sum(Z[a] * Z[b].T)
            rho.append(np.sum(X[a] * ph * X[b]) / den)
            sig.append(1 / np.sqrt(den) if den > 0 else np.nan)
    return np.asarray(rho, LD), np.asarray(sig, LD), kappa


def os_gap(r, s_, rc, sc):
    """Per draw, ``max(|d rho|, |d sig|)`` over the second result's sig,
    NaN where either is not finite."""
    import numpy as np
    fin = np.isfinite(s_).all(axis=1) & np.isfinite(sc).all(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        g = np.max(np.maximum(np.abs(r - rc), np.abs(s_ - sc))
                   / np.abs(sc), axis=1)
    return np.where(fin, g, np.nan)


def os_check(psrs, tls, like, chain, nmarg, label, smi):
    """The optimal statistic of ``psrs`` on the card, timed, and against
    the same function on the CPU in float64 (``max(|d rho|, |d sig|)``
    over the CPU's sig, per draw; rho crosses zero), on two sets: the
    chain's median and ``nmarg`` seeded draws of it, as
    ``OptimalStatisticWarp`` picks them, and ``nmarg`` near-typical draws
    and their median (held within OS_RTOL at every draw and pair). On the
    chain's draws the card and the CPU are measured against a long-double
    witness (:func:`os_witness`). Returns the
    card's wall time on the chain's draws, in s."""
    import numpy as np
    import torch
    from enterprise_warp_tpu_torch.results.optstat import (combine_os,
                                                           make_os_fn)
    fn, pairs, xi, sampled = make_os_fn(psrs, tls, device="cuda")
    fn_cpu = make_os_fn(psrs, tls, device="cpu")[0]
    if sorted(p.name for p in sampled) != sorted(like.param_names):
        fail(f"{label}: the optimal statistic's parameters are not the "
             "likelihood's")
    # the chain's columns in the statistic's parameter order
    cols = [like.param_names.index(p.name) for p in sampled]
    draws = chain[len(chain) // 4:, cols]
    sel = np.random.default_rng(0).choice(len(draws), size=nmarg,
                                          replace=False)
    typical = near_typical(like, nmarg, 46)[:, cols]
    pos = np.stack([p.pos for p in psrs])
    walls = {}
    for name, th in (("chain", draws[sel]), ("near-typical", typical)):
        med = np.median(th, axis=0)
        fn(med)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rho, sig = fn(med)
        rho_m, sig_m = fn(th)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rho_c, sig_c = fn_cpu(med)
        rho_mc, sig_mc = fn_cpu(th)
        cpu_wall = time.perf_counter() - t0
        r = np.vstack([rho, rho_m])
        s_ = np.vstack([sig, sig_m])
        rc = np.vstack([rho_c, rho_mc])
        sc = np.vstack([sig_c, sig_mc])
        fk, fc = np.isfinite(s_).all(axis=1), np.isfinite(sc).all(axis=1)
        g = os_gap(r, s_, rc, sc)
        g = g[np.isfinite(g)]
        a2, a2e, snr = combine_os(rho, sig, xi, "hd", pos)
        print(f"{label}, {name} draws: optimal statistic over "
              f"{len(pairs)} pairs at the median and {nmarg} draws on the card "
              f"in {walls[name]:.3f} s (the CPU in float64: {cpu_wall:.3f} s); "
              f"hd A^2 at the median {a2:.4e} +- {a2e:.4e}, S/N {snr:.3f}; "
              f"max(|d rho|, |d sig|) / sig against the CPU over the "
              f"{len(g)} of {len(r)} points finite on both: max "
              f"{g.max(initial=0.0):.3e}, median "
              f"{np.median(g) if len(g) else 0.0:.3e}, "
              f"{int((g > OS_RTOL).sum())} above {OS_RTOL:g}; finite on the "
              f"card only {int((fk & ~fc).sum())}, on the CPU only "
              f"{int((fc & ~fk).sum())} [{smi}]")
        if name == "near-typical" and not (len(g) == len(r)
                                           and g.max() <= OS_RTOL):
            fail(f"{label}: the optimal statistic on the card disagrees with "
                 "the CPU in float64 at near-typical draws")
        if name == "chain":
            os_witness(psrs, tls, np.vstack([med, th]), r, s_, rc, sc,
                       label)
    return walls["chain"]


def os_witness(psrs, tls, th, r, s_, rc, sc, label):
    """The optimal statistic's factor (the reference's algebra) measured
    on the chain's draws ``th`` (row 0 the median) against
    :func:`os_longdouble`, the same algebra in long double. ``r, s_`` are
    the card's results, ``rc, sc`` the CPU's. Witnessed (distinct draws
    only; a PT chain repeats a rejected state): the median, the two draws
    where card and CPU lie farthest apart, and the first draw finite on
    the card only and on the CPU only. At each, the distance ``max(|d
    rho|, |d sig|)`` of the card and of the CPU from the witness over its
    sig, and the largest condition number of a pulsar's equilibrated
    Sigma; the repair's limit at every witnessed draw where the
    long-double factor and the CPU's float64 factor succeed: card within
    ``max(OS_WITNESS_FACTOR x`` the CPU's distance``, OS_WITNESS_FLOOR)``;
    and at the median, card against CPU within ``OS_RTOL``. Reported, not
    held: the reference's algebra does not meet it on the card
    (``PERF.md``)."""
    import numpy as np
    from enterprise_warp_tpu_torch.results.optstat import os_inputs
    inputs = os_inputs(psrs, tls, device="cpu")
    fk, fc = np.isfinite(s_).all(axis=1), np.isfinite(sc).all(axis=1)
    g = os_gap(r, s_, rc, sc)
    g = np.where(np.isfinite(g), g, -np.inf)
    picks = [0] + [int(i) + 1 for i in np.argsort(-g[1:])[:2]
                   if np.isfinite(g[i + 1])]
    for only in (fk & ~fc, fc & ~fk):
        if only[1:].any():
            picks.append(int(np.argmax(only[1:])) + 1)
    _, first = np.unique(th[picks], axis=0, return_index=True)
    picks = [picks[i] for i in sorted(first)]
    print(f"{label}: the optimal statistic's witnessed chain draws {picks}")
    t0 = time.perf_counter()
    held = []
    for i in picks:
        rl, sl, kappa = os_longdouble(inputs, th[i])
        ok = np.isfinite(sl).all()
        dist = {d: float(os_gap(rr[i:i + 1], ss[i:i + 1],
                                rl[None].astype(float),
                                sl[None].astype(float))[0]) if ok else np.nan
                for d, rr, ss in (("card", r, s_), ("cpu", rc, sc))}
        lim = max(OS_WITNESS_FACTOR * dist["cpu"], OS_WITNESS_FLOOR)
        ok = ok and np.isfinite(lim)
        if ok:
            held.append(dist["card"] <= lim)
        print(f"{label}, chain draw {'median' if i == 0 else i}: "
              f"largest equilibrated cond(Sigma) {kappa:.3e}; distance from "
              f"the long-double witness in sig, card {dist['card']:.3e}, CPU "
              f"{dist['cpu']:.3e}"
              + (f"; limit {lim:.3e}" if ok else
                 "; no limit (the long-double or the CPU's factor fails)"))
    med = os_gap(r[:1], s_[:1], rc[:1], sc[:1])[0]
    met = bool(held) and all(held) and med <= OS_RTOL
    print(f"{label}: the card within the repair's limit at {sum(held)} of "
          f"{len(held)} witnessed draws; at the median card against CPU "
          f"{med:.3e} of sig (limit {OS_RTOL:g}); criterion "
          f"{'met' if met else 'not met'}; long-double witness at "
          f"{len(picks)} chain draws in {time.perf_counter() - t0:.1f} s")


def recon_check(prfile, chain, names, smi):
    """The noise reconstruction on the card (``results/reconstruct.py``):
    ``get_tempo2_prediction`` on ``examples/data/J1234-5678`` with its
    injected noise file, every column within ``RECON_TOL`` of its largest
    magnitude of the same call on the CPU, both timed (host clock: parse,
    build and solve); then ``realizations_batch`` with the model of
    ``prfile --num 0`` on ``RECON_DRAWS`` draws of that run's chain
    (``names`` its columns), timed on the card (CUDA events, median of 5)
    and on the CPU (host clock), and held against the CPU at every draw
    within ``RECON_TOL`` of each realization's largest magnitude."""
    import types
    import numpy as np
    import torch
    from enterprise_warp_tpu_torch.config import Params
    from enterprise_warp_tpu_torch.models.assemble import \
        build_terms_for_model
    from enterprise_warp_tpu_torch.results.reconstruct import (
        NoiseReconstructor, get_tempo2_prediction)
    ex = os.path.join(HERE, "examples")
    par, tim = (os.path.join(ex, "data", f"J1234-5678.{e}")
                for e in ("par", "tim"))
    with open(os.path.join(ex, "example_noisefiles",
                           "J1234-5678_noise.json")) as fh:
        noise = json.load(fh)
    cols, walls = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        cols[dev], _ = get_tempo2_prediction(par, tim, noise, device=dev)
        torch.cuda.synchronize()
        walls[dev] = time.perf_counter() - t0
    err = [float(np.max(np.abs(cols["cuda"][:, j] - cols["cpu"][:, j]))
                 / np.max(np.abs(cols["cpu"][:, j]))) for j in range(5)]
    print(f"get_tempo2_prediction on J1234-5678 ({len(cols['cpu'])} TOAs): "
          f"wall {walls['cuda']:.3f} s on the card, {walls['cpu']:.3f} s on "
          f"the CPU; columns bat post posttn tndm tnrn, max|card - CPU| / "
          f"max|column| {', '.join(f'{e:.2e}' for e in err)}; rms tnrn "
          f"{np.std(cols['cpu'][:, 4]):.3e} s, tndm "
          f"{np.std(cols['cpu'][:, 3]):.3e} s [{smi}]")
    if not (np.isfinite(cols["cuda"]).all() and max(err) <= RECON_TOL):
        fail("get_tempo2_prediction on the card disagrees with the CPU")
    opts = types.SimpleNamespace(num=0, drop=0, mpi_regime=2,
                                 wipe_old_output=0, extra_model_terms=None)
    params = Params(prfile, opts=opts)
    psr = params.psrs[0]
    terms = build_terms_for_model(params.models[min(params.models)], [psr],
                                  params.noise_model_obj)[0]
    recs = {dev: NoiseReconstructor(psr, terms, device=dev)
            for dev in ("cuda", "cpu")}
    if recs["cuda"].param_names != list(names):
        fail("the reconstruction's parameters are not the chain's")
    post = chain[len(chain) // 4:, :len(names)]
    th = post[np.random.default_rng(0).choice(
        len(post), RECON_DRAWS, replace=len(post) < RECON_DRAWS)]
    out = recs["cuda"].realizations_batch(th)
    ms = time_cuda(lambda: recs["cuda"].realizations_batch(th), warm=2,
                   reps=5)
    t0 = time.perf_counter()
    out_c = recs["cpu"].realizations_batch(th)
    cpu_s = time.perf_counter() - t0
    worst = max(float(np.max(
        np.max(np.abs(out[k] - out_c[k]), axis=1)
        / np.maximum(np.max(np.abs(out_c[k]), axis=1), 1e-300)))
        for k in out_c)
    print(f"realizations_batch of {psr.name} ({', '.join(out)}) over "
          f"{len(th)} draws of the chain: {ms:.3f} ms on the card (CUDA "
          f"events, median of 5), {cpu_s:.3f} s on the CPU; max|card - "
          f"CPU| / max|realization| {worst:.3e} over every draw [{smi}]")
    if not (all(np.isfinite(v).all() for v in out.values())
            and worst <= RECON_TOL):
        fail("realizations_batch on the card disagrees with the CPU")


# ---- phase 10: the run plane --------------------------------------------
# the events that mean a rung fired or a fault surfaced: none may appear in
# a run that planted no fault
RUNG_EVENTS = ("demotion", "retry", "anomaly", "kernel_health",
               "psr_quarantined")
# phase 10's fault-plan runs: system_noise.dat --num 1 (kernel 2), 300
# steps in blocks of 100
PLAN_NSAMP, PLAN_BLOCK = 300, 100
# phase 10's telemetry off/on runs: two blocks of 200 steps, the host
# syncs counted in the second (the plane's cost in time is measured by
# enterprise_warp_tpu_torch/bench/ab.py, alternated runs in one call)
PLANE_NSAMP, PLANE_BLOCK = 400, 200
# the hang's watchdog: well above a 100-step block of --num 1 (< 1 s)
HANG_WATCHDOG_S = 2
# the health path's condition proxy: the reference's threshold (log10 14)
# trips on every run whose walkers visit the red-noise prior corners
# (both packages; ROADMAP Queue 3), so the health phase holds the jitter
# and divergence rungs only
HEALTH_ENV = dict(EWT_KERNEL_HEALTH="1", EWT_FLIGHTREC="1",
                  EWT_HEALTH_LOGCOND_MAX="1000")
NESTED_ITERS = 16


def last_session(path):
    """The events of the last session (from its ``run_start``) of an
    ``events.jsonl``."""
    with open(path) as fh:
        events = [json.loads(ln) for ln in fh]
    starts = [i for i, e in enumerate(events) if e["type"] == "run_start"]
    return events[starts[-1]:] if starts else events


def stream_check(outdir, label, allow=(), blocks=None):
    """A run's ``events.jsonl`` through the port's own copy of the stream
    vocabulary (``utils/telemetry.py:check_stream``, the rules of
    ``tools/report.py --check``): no problem, a ``run_start`` and a
    ``run_end`` per session, one heartbeat per checkpoint (a block each)
    or ``blocks`` heartbeats, and no rung event (:data:`RUNG_EVENTS`)
    beyond ``allow``. A PT session (a ``ptmcmcsampler`` CLI run or a
    ``sample_to_convergence`` run) with the device diagnostics plane on (the
    environment at the call) carries one ``mixing`` event per checkpoint
    and ``mixing_stats.json``; with it off, neither. Returns the last
    session's events."""
    from enterprise_warp_tpu_torch.utils import devicemetrics, telemetry
    path = os.path.join(outdir, "events.jsonl")
    if not os.path.exists(path):
        fail(f"{label}: no events.jsonl in {outdir}")
    problems, msgs = telemetry.check_stream(path)
    if problems:
        fail(f"{label}: events.jsonl has {problems} problem(s): {msgs}")
    events = last_session(path)
    types = collections.Counter(e["type"] for e in events)
    rungs = {t: types[t] for t in RUNG_EVENTS if types[t] and t not in allow}
    hb = types["heartbeat"]
    want = blocks if blocks is not None else types["checkpoint"]
    print(f"{label}: events.jsonl clean, last session {dict(types)}")
    if types["run_start"] != 1 or types["run_end"] != 1 or not hb:
        fail(f"{label}: the stream's last session is not one run_start, "
             "heartbeats and one run_end")
    if hb != want:
        fail(f"{label}: {hb} heartbeats for {want} blocks")
    if rungs:
        fail(f"{label}: {rungs} in a run that planted no fault")
    if events[0].get("sampler") in ("ptmcmcsampler", "convergence"):
        plane = devicemetrics.enabled()
        want = types["checkpoint"] if plane else 0
        stats = os.path.exists(os.path.join(outdir, "mixing_stats.json"))
        if types["mixing"] != want or stats != plane:
            fail(f"{label}: {types['mixing']} mixing events for "
                 f"{types['checkpoint']} blocks, mixing_stats.json "
                 f"{'present' if stats else 'absent'}, with the plane "
                 f"{'on' if plane else 'off'}")
    return events


@contextlib.contextmanager
def run_env(plan=None, **env):
    """Set ``env`` (None deletes) and install the fault ``plan`` for one
    run; afterwards restore the environment, disarm the plan, clear a
    pending preemption and start a fresh flight recorder."""
    from enterprise_warp_tpu_torch.resilience import faults, supervisor
    from enterprise_warp_tpu_torch.utils import flightrec, telemetry
    keys = set(env) | {"EWT_PALLAS", "EWT_PALLAS_MEGA"}
    saved = {k: os.environ.get(k) for k in keys}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    faults.install_plan(plan)
    flightrec._RECORDER = None
    telemetry.set_flight_hook(None)
    try:
        yield
    finally:
        faults.install_plan(None)
        supervisor.clear_preemption()
        flightrec._RECORDER = None
        telemetry.set_flight_hook(None)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class CliRuns:
    """``cli.main`` runs on the card, with each run's block statistics
    (from the PT sampler's log records) and, on request, the host
    synchronisations of its second block counted by
    ``torch.cuda.set_sync_debug_mode`` (:meth:`run`). Sync counting covers
    the second block only: the debug mode and the recording of every
    warning cost host time at each synchronising call, so both start at
    the first block's end (ms/step comes from the first block) and stop at
    the second's. Each synchronising call is recorded by its thread and
    the innermost frame outside torch (``counting["sites"]``). ``close``
    removes the log handler."""

    def __init__(self, tmp, dev, smi):
        self.tmp, self.dev, self.smi = tmp, dev, smi
        self.blocks = []
        self.counting = {"on": False, "cm": None, "n": None, "sites": None}
        runs = self

        class Blocks(logging.Handler):
            def emit(self, record):
                st = getattr(record, "block_stats", None)
                if st is not None:
                    runs._block(st)

        self.handler = Blocks()
        logging.getLogger("ewt.ptmcmc").setLevel(logging.INFO)
        logging.getLogger("ewt.ptmcmc").addHandler(self.handler)

    def close(self):
        logging.getLogger("ewt.ptmcmc").removeHandler(self.handler)

    def _caller(self, message, category, filename, lineno, file=None,
                line=None):
        import threading
        import traceback
        if "synchroniz" not in str(message):
            return
        site = f"{os.path.relpath(filename, HERE)}:{lineno}"
        for fr in reversed(traceback.extract_stack()[:-1]):
            if f"{os.sep}torch{os.sep}" not in fr.filename and \
                    not fr.filename.endswith("warnings.py"):
                site = f"{os.path.relpath(fr.filename, HERE)}:{fr.lineno}"
                break
        self.counting["sites"][
            f"{threading.current_thread().name} {site}"] += 1

    def _block(self, st):
        import warnings
        import torch
        counting = self.counting
        self.blocks.append(st)
        if counting["on"] and len(self.blocks) == 1:
            counting["cm"] = warnings.catch_warnings()
            counting["cm"].__enter__()
            warnings.simplefilter("always")
            warnings.showwarning = self._caller
            torch.cuda.set_sync_debug_mode("warn")
        elif counting["cm"] is not None and len(self.blocks) == 2:
            self._stop_counting()

    def _stop_counting(self):
        import torch
        counting = self.counting
        torch.cuda.set_sync_debug_mode("default")
        if counting["cm"] is not None:
            counting["n"] = sum(counting["sites"].values())
            counting["cm"].__exit__(None, None, None)
            counting["cm"] = None

    def run(self, pf, num, label, expect_rc=0, sync_count=False):
        """``cli.main`` on the card; returns (the run's directory, its
        launches, routes, designs, the ms/step of the first block and of
        all blocks, the host synchronisations of the second block,
        counted by ``torch.cuda.set_sync_debug_mode``, and the number of
        blocks)."""
        import gc
        import torch
        from enterprise_warp_tpu_torch import cli
        from enterprise_warp_tpu_torch.ops import routes
        blocks, counting = self.blocks, self.counting
        del blocks[:]
        routes.reset_counts()
        nsync = None
        t0 = time.perf_counter()
        if sync_count:
            # the handler starts and stops the count around block 2;
            # finalizers of earlier runs' objects and the device's queue
            # settle first, outside the count
            gc.collect()
            torch.cuda.synchronize()
            counting.update(on=True, cm=None, n=None,
                            sites=collections.Counter())
            try:
                rc = cli.main(["--prfile", pf, "--num", str(num)],
                              device=self.dev)
            finally:
                self._stop_counting()
                counting["on"] = False
            nsync = counting["n"]
        else:
            rc = cli.main(["--prfile", pf, "--num", str(num)],
                          device=self.dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if rc != expect_rc:
            fail(f"{label}: cli.main exited {rc}, not {expect_rc}")
        out = [r for r, _, fs in os.walk(os.path.join(
            self.tmp, "out", os.path.basename(pf))) if "state.npz" in fs]
        steps = sum(b["steps"] for b in blocks)
        ms = (1e3 * blocks[0]["block_s"] / blocks[0]["steps"] if blocks
              else 0.0)
        ms_all = (1e3 * sum(b["block_s"] for b in blocks) / steps if blocks
                  else 0.0)
        print(f"{label}: rc {rc} wall {wall:.1f} s, {steps} steps in "
              f"{len(blocks)} blocks, {ms:.3f} ms/step in the first, "
              f"{ms_all:.3f} over all, launches "
              f"{dict(routes.LAUNCHES)} routes "
              f"{ {f'{k}/{p}': v for (k, p), v in routes.ROUTES.items()} } "
              f"designs { {f'{k}/{d}': v for (k, d), v in routes.DESIGNS.items()} }"
              + (f", host syncs in the second block {nsync}"
                 if nsync is not None else "") + f" [{self.smi}]")
        return (out[0], dict(routes.LAUNCHES), dict(routes.ROUTES),
                dict(routes.DESIGNS), (ms, ms_all), nsync, len(blocks))

    @staticmethod
    def chain_bytes(outdir):
        with open(os.path.join(outdir, "chain_1.txt"), "rb") as fh:
            return fh.read()

    @staticmethod
    def step_of(outdir):
        import numpy as np
        return int(np.load(os.path.join(outdir, "state.npz"))["step"])


def phase_run_plane(tmp, dev, smi, results):
    """Phase 10: the run plane on the card (module docstring); the
    ``chol_precond@health`` row goes into ``results``."""
    import signal
    import threading

    import numpy as np
    import torch
    from enterprise_warp_tpu_torch.ops import cholfuse as cf
    from enterprise_warp_tpu_torch.ops import routes
    from enterprise_warp_tpu_torch.resilience import supervisor
    from enterprise_warp_tpu_torch.samplers import run_nested

    runs = CliRuns(tmp, dev, smi)
    run, counting = runs.run, runs.counting
    chain_bytes, step_of = runs.chain_bytes, runs.step_of

    try:
        # ---- 10.1: the health plane on the card ------------------------
        pf = write_paramfile(tmp, "system_noise.dat",
                             dest="system_noise_health.dat",
                             nsamp=SHORT_NSAMP, cov_update=SHORT_COV_UPDATE)
        with run_env(**HEALTH_ENV), Record(cf, "chol_precond_health", 0) \
                as rec:
            hdir, hl, hr, hd, health_ms, _, nblk = run(
                pf, 0, "10.1 system_noise.dat --num 0, EWT_KERNEL_HEALTH=1")
        # with the flight recorder on, a non-finite evaluation at a prior
        # corner is an anomaly dump, as the reference's (the classic
        # chain's failed factor of the timing-model block); nothing else
        events = stream_check(hdir, "10.1 health", allow=("anomaly",),
                              blocks=nblk)
        reasons = {e["reason"] for e in events if e["type"] == "anomaly"}
        if reasons - {"nonfinite_eval"}:
            fail(f"10.1: anomaly dumps {reasons}")
        end = [e for e in events if e["type"] == "run_end"][0]
        print("10.1 counters: " + ", ".join(
            f"{k} {v}" for k, v in sorted(end["metrics"]["counters"].items())
            if k.startswith(("nonfinite_eval", "schur_rejected",
                             "jitter_engaged", "refine_diverged"))))
        hb = [e for e in events if e["type"] == "heartbeat"][-1]
        print(f"10.1 kernel health: jitter_engaged {hb['jitter_engaged']}, "
              f"refine_diverged {hb['refine_diverged']}, kernel_cond "
              f"{hb['kernel_cond']} (run-cumulative, {hl['chol_precond']} "
              "launches)")
        n_pc = sorted(rec.sizes)
        if hl["mega_solve"] or hl["mega_like"] or not hl["chol_precond"] \
                or n_pc != [250] or dict(rec.sizes[250]) != {8: hl[
                    "chol_precond"]} \
                or hd.get(("chol_precond", "global")) != hl["chol_precond"]:
            fail(f"10.1: the health path did not run kernel 3 alone at (8, "
                 f"250, 250) on its global design: launches {hl}, orders "
                 f"{ {n: dict(c) for n, c in rec.sizes.items()} }, designs "
                 f"{hd}")
        S_, a, b = (x.detach() if torch.is_tensor(x) else x
                    for x in rec.last[250])
        S_ = S_.contiguous()
        err, tiers = hold_precond_run(torch, cf, "chol_precond@health", S_,
                                      a, b, dev)
        ms = time_cuda(lambda: cf._chol_precond_cuda(S_, a, b))
        plain_ms = time_cuda(lambda: cf._fused_torch(S_, a, b))
        flops, nbytes = chol_cost(S_.shape[0], 250, tiers)
        bms, bby = bound(flops, nbytes)
        print(f"chol_precond@health at {tuple(S_.shape)} (global design): "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound "
              f"{bms:.4f} ms ({bby}; {flops / 1e9:.4f} GFLOP, "
              f"{nbytes / 1e6:.3f} MB) median of 50 [{smi}]")
        results["chol_precond@health"] = dict(
            run="health0", shape=f"Sn {tuple(S_.shape)}", max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
            launches=hl["chol_precond"])
        chain = np.loadtxt(os.path.join(hdir, "chain_1.txt"))
        if not np.isfinite(chain).all():
            fail("10.1: non-finite chain rows")
        oracle = load_likes(pf, 0, "cpu", gram_mode="f64")[1][0]
        last = chain[-8:]
        ref = oracle.loglike_batch(last[:, :oracle.ndim]).numpy()
        gap = np.abs(last[:, -3] - ref)
        print(f"10.1 the chain's last 8 rows against the float64 oracle on "
              f"the CPU: max|dlnL| {gap.max():.3e}")
        if not np.all(gap <= LNL_ATOL + LNL_RTOL * np.abs(ref)):
            fail("10.1: the health path's chain disagrees with the float64 "
                 "oracle")

        print(f"10.1 health path {health_ms[1]:.3f} ms/step over its "
              f"{SHORT_NSAMP} steps (the default route: phase 5's main path "
              f"--num 0 line) [{smi}]")

        # ---- 10.2: host syncs with the plane off and on ----------------
        # a first counted run, not compared: a synchronising call made
        # once a process (torch.cuda.synchronize, not by the sampler)
        # landed in the first count of two card runs
        pf = write_paramfile(tmp, "system_noise.dat",
                             dest="system_noise_plane_warm.dat",
                             nsamp=PLANE_NSAMP, cov_update=PLANE_BLOCK)
        with run_env(EWT_TELEMETRY="1"):
            run(pf, 0, "10.2 warm-up --num 0 (not compared)",
                sync_count=True)
        print(f"10.2 warm-up: host syncs by site {dict(counting['sites'])}")
        cost, sites, chains = {}, {}, {}
        for num, flags in ((0, ("0", "1")), (1, ("1", "0"))):
            for i, flag in enumerate(flags):
                pf = write_paramfile(tmp, "system_noise.dat",
                                     dest=f"system_noise_plane{num}_{i}.dat",
                                     nsamp=PLANE_NSAMP,
                                     cov_update=PLANE_BLOCK)
                with run_env(EWT_TELEMETRY=flag):
                    d, _, _, _, ms, ns, nb = run(
                        pf, num, f"10.2 --num {num} EWT_TELEMETRY={flag}",
                        sync_count=True)
                cost.setdefault((num, flag), []).append((ms[0], ns))
                sites.setdefault((num, flag), []).append(counting["sites"])
                chains.setdefault(num, set()).add(chain_bytes(d))
                has = os.path.exists(os.path.join(d, "events.jsonl"))
                if has != (flag == "1"):
                    fail(f"10.2: EWT_TELEMETRY={flag} and the stream "
                         f"{'exists' if has else 'is missing'}")
                if flag == "1":
                    stream_check(d, f"10.2 --num {num}", blocks=nb)
        for num in (0, 1):
            off, on = cost[(num, "0")], cost[(num, "1")]
            print(f"10.2 --num {num}: ms/step (first block) telemetry off "
                  f"{[round(m, 3) for m, _ in off]} on "
                  f"{[round(m, 3) for m, _ in on]}; host syncs in the "
                  f"second block off {[s for _, s in off]} on "
                  f"{[s for _, s in on]}; the two chains "
                  f"{'bit for bit equal' if len(chains[num]) == 1 else 'differ'}"
                  f" [{smi}]")
            if len({s for _, s in off + on}) != 1 or not off[0][1]:
                runs = sites[(num, "0")] + sites[(num, "1")]
                every = set().union(*runs)
                print(f"10.2 --num {num}: host syncs by site, off then on: "
                      + "; ".join(f"{k} {[c[k] for c in runs]}"
                                  for k in sorted(every)
                                  if len({c[k] for c in runs}) > 1))
                fail(f"10.2 --num {num}: host syncs per block differ with "
                     "telemetry on and off")

        # ---- 10.3: fault plans on --num 1 (kernel 2) -------------------
        def plan_pf(dest):
            return write_paramfile(tmp, "system_noise.dat", dest=dest,
                                   extra={"covUpdate": PLAN_BLOCK},
                                   nsamp=PLAN_NSAMP)

        pf = plan_pf("plan_clean.dat")
        with run_env():
            cdir, *_ = run(pf, 1, "10.3 clean")
        stream_check(cdir, "10.3 clean")
        clean = chain_bytes(cdir)

        pf = plan_pf("plan_error.dat")
        with run_env(plan={"faults": [{"site": "pt.dispatch",
                                       "kind": "error", "at": 2}]}):
            edir, *_ = run(pf, 1, "10.3 pt.dispatch error at 2")
        ev = stream_check(edir, "10.3 error", allow=("retry",))
        if [e["type"] for e in ev].count("retry") != 1 or \
                chain_bytes(edir) != clean:
            fail("10.3: the injected dispatch error was not retried once "
                 "to the clean run's chain")
        print("10.3 pt.dispatch error at 2: one retry, the chain bit for "
              "bit the clean run's")

        pf = plan_pf("plan_kill.dat")
        env = dict(os.environ, EWT_FAULT_PLAN=json.dumps(
            {"faults": [{"site": "pt.ckpt", "kind": "kill", "at": 2}]}))
        code = (f"import sys; sys.path.insert(0, {HERE!r}); "
                "from enterprise_warp_tpu_torch import cli; "
                f"sys.exit(cli.main(['--prfile', {pf!r}, '--num', '1'], "
                f"device={str(dev)!r}))")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, timeout=300)
        if r.returncode != -signal.SIGKILL:
            fail(f"10.3: the pt.ckpt kill did not kill the run (exit "
                 f"{r.returncode}): {r.stderr.decode()[-2000:]}")
        kdir = [rr for rr, _, fs in os.walk(os.path.join(tmp, "out",
                                                         "plan_kill.dat"))
                if "state.npz" in fs][0]
        killed_at = step_of(kdir)
        with run_env():
            run(pf, 1, "10.3 resume after the pt.ckpt kill")
        ev = stream_check(kdir, "10.3 resume")
        lin = [e["reason"] for e in ev if e["type"] == "run_lineage"]
        if chain_bytes(kdir) != clean or lin != ["resume"]:
            fail(f"10.3: the resumed run (killed at step {killed_at}, "
                 f"lineage {lin}) is not the uninterrupted chain")
        print(f"10.3 pt.ckpt kill at 2 (a subprocess, killed at step "
              f"{killed_at}, {time.perf_counter() - t0:.1f} s with the "
              "resume): the resumed chain bit for bit the clean run's")

        pf = plan_pf("plan_hang.dat")
        with run_env(plan={"faults": [{"site": "pt.dispatch", "kind": "hang",
                                       "at": 2, "hang_s": 60}]},
                     EWT_WATCHDOG_S=str(HANG_WATCHDOG_S)):
            t0 = time.perf_counter()
            hgdir, hgl, hgr, hgd, *_ = run(
                pf, 1, "10.3 pt.dispatch hang at 2, EWT_WATCHDOG_S="
                f"{HANG_WATCHDOG_S}")
            switches = (os.environ.get("EWT_PALLAS"),
                        os.environ.get("EWT_PALLAS_MEGA"))
        # the in-process re-entry joins the CLI's run scope: one session.
        # The classic rung pins the classic chain (EWT_PALLAS_MEGA=0) and
        # keeps the preconditioner kernel: no kernel runs its plain
        # version. With no megakernel route possible, the re-entered
        # sampler arms the health plane by default, as the reference's
        # does: its observe/reeval events may follow
        ev = stream_check(hgdir, "10.3 hang",
                          allow=("demotion", "kernel_health"))
        acts = {e["action"] for e in ev if e["type"] == "kernel_health"}
        if acts - {"observe", "reeval"}:
            fail(f"10.3 hang: health actions {acts} after the demotion")
        dem = [e for e in ev if e["type"] == "demotion"]
        lin = [e["reason"] for e in ev if e["type"] == "run_lineage"]
        if len(dem) != 1 or (dem[0]["from"], dem[0]["to"]) != \
                ("mega", "classic") or switches != (None, "0") or \
                hgr.get(("chol_precond", "disabled")) or \
                not hgl["chol_precond"] or \
                hgr.get(("chol_precond", "kernel")) != hgl["chol_precond"] \
                or hgl["mega_like"] != PLAN_BLOCK + 1 or \
                step_of(hgdir) != PLAN_NSAMP or lin != ["fresh"]:
            fail(f"10.3: the hang did not demote mega -> classic onto the "
                 f"preconditioner kernel and complete: demotions {dem}, "
                 f"EWT_PALLAS/EWT_PALLAS_MEGA {switches}, launches {hgl}, "
                 f"routes {hgr}, lineage {lin}")
        print(f"10.3 hang: demotion {dem[0]['from']} -> {dem[0]['to']} "
              f"(device_ok {dem[0]['device_ok']}), then the classic chain "
              f"on kernel 3 ({hgl['chol_precond']} launches, designs "
              f"{ {f'{k}/{d}': v for (k, d), v in hgd.items()} }), run "
              f"complete in {time.perf_counter() - t0:.1f} s")

        pf = plan_pf("plan_bottom.dat")
        with run_env(plan={"faults": [{"site": "pt.dispatch",
                                       "kind": "error", "at": 2}]},
                     EWT_PALLAS_MEGA="0", EWT_DISPATCH_RETRIES="0"):
            bdir, *_ = run(pf, 1, "10.3 retries exhausted at the bottom",
                           expect_rc=supervisor.EXIT_DEMOTED)
        at = step_of(bdir)
        with run_env():
            run(pf, 1, "10.3 resume after exit 75")
        if step_of(bdir) != PLAN_NSAMP:
            fail("10.3: the resume after exit 75 did not complete")
        print(f"10.3 bottom of the ladder: exit 75 at step {at}, no "
              "re-execution; the resume on the card completed")

        pf = plan_pf("plan_nonfinite.dat")
        cap = os.path.join(tmp, "capture")
        with run_env(plan={"faults": [{"site": "pt.nonfinite",
                                       "kind": "nonfinite", "at": 2}]},
                     EWT_FLIGHTREC="1", EWT_PROFILE_CAPTURE=cap,
                     EWT_PROFILE_BLOCKS="1"):
            ndir, *_ = run(pf, 1, "10.3 pt.nonfinite at 2, "
                           "EWT_PROFILE_CAPTURE")
        stream_check(ndir, "10.3 nonfinite", allow=("anomaly",))
        apath = os.path.join(ndir, "anomaly", "anomaly.json")
        traces = sorted(os.listdir(cap)) if os.path.isdir(cap) else []
        if not os.path.exists(apath) or not traces:
            fail(f"10.3: no anomaly dump ({os.path.exists(apath)}) or no "
                 f"trace file ({traces})")
        with open(apath) as fh:
            doc = json.load(fh)
        if doc["reason"] != "nonfinite_eval":
            fail(f"10.3: the anomaly dump's reason is {doc['reason']}")
        print(f"10.3 pt.nonfinite: anomaly dump {doc['reason']} (launches "
              f"in force {doc['kernels']['launches']}), profiler traces "
              f"{traces} ({sum(os.path.getsize(os.path.join(cap, t)) for t in traces) / 1e6:.1f} MB)")

        # ---- 10.4: SIGTERM on a CLI PT run -----------------------------
        pf = write_paramfile(tmp, "system_noise.dat", dest="sigterm.dat",
                             extra={"covUpdate": PLAN_BLOCK},
                             nsamp=2 * PLAN_NSAMP)
        sdir_root = os.path.join(tmp, "out", "sigterm.dat")

        def send_term():
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                hits = [os.path.join(rr, "chain_1.txt")
                        for rr, _, fs in os.walk(sdir_root)
                        if "chain_1.txt" in fs]
                if hits and os.path.getsize(hits[0]) > 0:
                    os.kill(os.getpid(), signal.SIGTERM)
                    return
                time.sleep(0.05)

        with run_env(EWT_FLIGHTREC="1"):
            killer = threading.Thread(target=send_term, daemon=True)
            killer.start()
            sdir, *_ = run(pf, 1, "10.4 SIGTERM")
            killer.join(timeout=5)
        ev = last_session(os.path.join(sdir, "events.jsonl"))
        end = [e for e in ev if e["type"] == "run_end"]
        at = step_of(sdir)
        if len(end) != 1 or end[0].get("reason") != "preempted" or \
                not 0 < at < 2 * PLAN_NSAMP:
            fail(f"10.4: SIGTERM did not preempt cleanly (run_end {end}, "
                 f"checkpoint at step {at})")
        with run_env():
            run(pf, 1, "10.4 resume after SIGTERM")
        ev = stream_check(sdir, "10.4 resume")
        lin = [e["reason"] for e in ev if e["type"] == "run_lineage"]
        if step_of(sdir) != 2 * PLAN_NSAMP or lin != ["preempt-restart"]:
            fail(f"10.4: the resume did not complete ({step_of(sdir)}, "
                 f"lineage {lin})")
        print(f"10.4 SIGTERM: run_end(reason=preempted) at step {at}, the "
              "resume completed (lineage preempt-restart)")

        # ---- 10.5: the per-iteration nested switch ----------------------
        # (HMC's device_state switch keeps the one device-resident path:
        # tests/test_torch_hmc.py holds its chain on the CPU)
        npf = write_paramfile(tmp, "default_model_nested.dat",
                              dest="nested_periter.dat")
        nparams, nls = load_likes(npf, 0, dev)
        kw = nparams.sampler_kwargs
        nkw = dict(nlive=int(kw.get("nlive", 500)), dlogz=1e-12,
                   max_iter=NESTED_ITERS, seed=0, verbose=False,
                   kernel="walk", label="r")
        for key in ("kbatch", "nsteps"):
            if int(kw.get(key, 0) or 0) > 0:
                nkw[key] = int(kw[key])
        nres = {}
        for bi in (0, 8):
            t0 = time.perf_counter()
            d = os.path.join(tmp, "out", f"nested_bi{bi}")
            nres[bi] = run_nested(nls[0], outdir=d, block_iters=bi, **nkw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            print(f"10.5 nested block_iters={bi}: {NESTED_ITERS} iterations "
                  f"in {dt:.2f} s, {1e3 * dt / NESTED_ITERS:.2f} ms per "
                  f"iteration, lnZ {nres[bi]['log_evidence']:.6f} [{smi}]")
            # block_iters 0 runs the blocked walk one iteration a block
            stream_check(d, f"10.5 nested block_iters={bi}",
                         blocks=-(-NESTED_ITERS // max(bi, 1)) + 1)
        if nres[0]["log_evidence"] != nres[8]["log_evidence"] or \
                not np.array_equal(nres[0]["samples"], nres[8]["samples"]):
            fail("10.5: block_iters 0 is not bit for bit the blocked walk")
        print("10.5 block_iters 0 (one iteration a block) bit for bit the "
              "blocked walk at 8")
    finally:
        runs.close()


# ---- phase 11: the sampled chromatic index and the diagnostics plane ----
# the chromatic pulsar's model: J1234-5678's four bands (600-3100 MHz)
# constrain the index
CHROM_MODEL = {"model_name": "chrom",
               "universal": {"white_noise": "by_backend",
                             "spin_noise": "powerlaw_30_nfreqs",
                             "dm_noise": "powerlaw_30_nfreqs",
                             "chromred": "vary_30_nfreqs"}}
CHROM_IDX = "J1234-5678_chromatic_gp_idx"
CHROM_IDX_PRIOR = (0.0, 6.0)
# the array's entry for J1234-5678 (fake_psr_0 has one band, where the
# index is a flat direction: it keeps the universal model)
CHROM_ARRAY_TERM = {"chromred": "vary_10_nfreqs"}
# the plane's off/on runs: system_noise.dat --num 1, two blocks of 100
PLANE_AB_NSAMP, PLANE_AB_BLOCK = 200, 100
# the streaming estimators against the exact ones on the same kept steps:
# the reference's gates (tests/test_devicemetrics.py:225-268)
STREAM_RHAT_ATOL, STREAM_ESS_RATIO = 0.1, 3.0
# the north star leg in an earlier card run with every check exact (run
# "14g" of PERF.md), printed beside this run's
EXACT_NORTH_STAR = {"steps": 22200, "sampling_s": 214.38}


def phase_chromatic(tmp, dev, smi, results, launches, walkers, h):
    """Phase 11.1 and 11.2 (module docstring): the sampled chromatic index
    through the CLI, one pulsar and the joint array. ``h`` holds main's
    helpers (``drive``, ``pt_report``, ``hold_solve``, ``hold_last_step``,
    ``solve_calls``); the rows go into ``results``, each run's launches
    into ``launches``."""
    import numpy as np
    import torch
    from enterprise_warp_tpu_torch.ops import megakernel as mk
    from enterprise_warp_tpu_torch.ops import routes

    # ---- 11.1: the chromatic pulsar ------------------------------------
    nm = os.path.join(tmp, "chromatic_noise.json")
    with open(nm, "w") as fh:
        json.dump(CHROM_MODEL, fh)
    cpf = write_paramfile(tmp, "system_noise.dat", dest="chromatic.dat",
                          nsamp=NSAMP, noise_model_file=nm)
    with Record(mk, "mega_solve_logdet", 0) as rec:
        chain, launches["chrom"], cdir = h.drive(cpf, 0, ["mega_solve"])
    declined = routes.ROUTES.get(("mega_like", "per-walker-basis"), 0)
    other = {p: v for (k, p), v in routes.ROUTES.items()
             if k == "mega_like" and p != "per-walker-basis"}
    h.pt_report("11.1 chromatic J1234-5678", chain)
    names = open(os.path.join(cdir, "pars.txt")).read().split()
    sizes = {n: dict(c) for n, c in rec.sizes.items()}
    print(f"11.1 chromatic J1234-5678: {len(names)} parameters (the index "
          f"{CHROM_IDX} at {names.index(CHROM_IDX)}); the likelihood "
          f"kernel declined {declined} calls as per-walker-basis (other "
          f"routes {other}), launched {launches['chrom']['mega_like']} "
          f"times; solve-kernel calls per order and walker batch {sizes}")
    if launches["chrom"]["mega_like"] or other or not declined:
        fail("11.1: the likelihood kernel did not decline the per-walker "
             "basis on every call")
    if launches["chrom"]["chol_precond"] or sorted(sizes) != [180] or \
            sum(sizes[180].values()) != launches["chrom"]["mega_solve"]:
        fail("11.1: the Sigma solve did not run the solve kernel at n = 180 "
             "on every call")
    oracle = load_likes(cpf, 0, "cpu", gram_mode="f64")[1][0]
    if oracle.param_names != names:
        fail("11.1: the oracle's parameters are not the run's")
    top = int(np.argmax(chain[:, -3]))
    rows = np.concatenate([chain[-8:], chain[top:top + 1]])
    ref = oracle.loglike_batch(rows[:, :oracle.ndim]).numpy()
    gap = np.abs(rows[:, -3] - ref)
    print(f"11.1: the chain's last 8 rows and its largest lnL "
          f"{chain[top, -3]:.6g} against the float64 oracle on the CPU: "
          f"max|dlnL| {gap.max():.3e}")
    if not np.all(gap <= LNL_ATOL + LNL_RTOL * np.abs(ref)):
        fail("11.1: the chromatic chain disagrees with the float64 oracle")
    col = chain[len(chain) // 4:, names.index(CHROM_IDX)]
    lo, hi = CHROM_IDX_PRIOR
    print(f"11.1: the index's posterior (last 3/4 of the chain) mean "
          f"{col.mean():.4f} std {col.std():.4f}, range [{col.min():.4f}, "
          f"{col.max():.4f}], prior [{lo:g}, {hi:g}]")
    if not (np.isfinite(col).all() and col.min() >= lo and col.max() <= hi):
        fail("11.1: the index's posterior is not finite inside its prior")
    kern, plain, shape, exact = h.solve_calls(rec.last[180])
    h.hold_last_step("mega_solve@chrom n=180, the run's last step", kern,
                     plain, shape, exact)
    like = load_likes(cpf, 0, dev)[1][0]
    th = near_middle(like, walkers, 21)
    with Record(mk, "mega_solve_logdet", 0) as cap:
        if not torch.isfinite(like.loglike_batch(th)).all():
            fail("11.1: non-finite lnL near typical values")
    # near typical values the chromatic block leaves some walkers' Sigma
    # at cond 1e3-1e4, where float32 rounding alone puts the two versions
    # more than ATOL apart: held walker by walker with the float64 arbiter
    # (hold_last_step's rule), as the last step is
    a = cap.last[180]
    kern, plain, shape, exact = h.solve_calls(a)
    h.hold_solve("mega_solve@chrom", "chrom", kern, plain,
                 lambda tiers: solve_cost(*a[1].shape, a[4], tiers), shape,
                 exact=exact, what="points near typical values")
    results["mega_solve@chrom"].update(batch_sizes=sizes[180])

    # ---- 11.2: the chromatic array ---------------------------------------
    with open(os.path.join(HERE, "examples", "example_noisemodels",
                           "gwb_noise.json")) as fh:
        anm = json.load(fh)
    anm["J1234-5678"] = dict(anm["universal"], **CHROM_ARRAY_TERM)
    apath = os.path.join(tmp, "chromatic_array_noise.json")
    with open(apath, "w") as fh:
        json.dump(anm, fh)
    apf = write_paramfile(tmp, "gwb_array.dat", dest="chromatic_array.dat",
                          nsamp=SHORT_NSAMP, cov_update=SHORT_COV_UPDATE,
                          noise_model_file=apath)
    glike = load_likes(apf, 0, dev)[1][0]
    st = glike._stages
    n1, n3 = st["NW"], st["npsr"] * st["n_g"]
    with RecordBatches(mk, "mega_solve_logdet", 0) as rec:
        chain, launches["chrom_gwb"], adir = h.drive(apf, 0, ["mega_solve"])
    h.pt_report("11.2 chromatic array", chain)
    W = walkers
    b1, b3 = W * st["npsr"], W
    calls = {n: dict(c) for n, c in rec.sizes.items()}
    print(f"11.2 chromatic array: stage 1 at order {n1} (batch {b1}), "
          f"stage 3 at order {n3} (batch {b3}); solve-kernel calls per "
          f"order and batch {calls}; launches {launches['chrom_gwb']}")
    c1 = calls.get(n1, {}).get(b1, 0)
    c3 = calls.get(n3, {}).get(b3, 0)
    if not c1 or c1 != c3 or launches["chrom_gwb"]["mega_solve"] \
            != c1 + c3 or launches["chrom_gwb"]["mega_like"] \
            or launches["chrom_gwb"]["chol_precond"]:
        fail("11.2: not one stage-1 and one stage-3 solve launch per "
             "likelihood call")
    if getattr(glike, "param_blocks", None) is not None or \
            os.path.exists(os.path.join(adir, "mask_stats.json")):
        fail("11.2: an evaluation cache was installed on a walker-dependent "
             "basis")
    names = open(os.path.join(adir, "pars.txt")).read().split()
    if CHROM_IDX not in names:
        fail("11.2: the array has no chromatic index")
    goracle = load_likes(apf, 0, "cpu", gram_mode="f64")[1][0]
    top = int(np.argmax(chain[:, -3]))
    rows = np.concatenate([chain[-8:], chain[top:top + 1]])
    ref = goracle.loglike_batch(rows[:, :goracle.ndim]).numpy()
    gap = np.abs(rows[:, -3] - ref)
    print(f"11.2: the chain's last 8 rows and its largest lnL "
          f"{chain[top, -3]:.6g} against the dense float64 oracle on the "
          f"CPU: max|dlnL| {gap.max():.3e}; no evaluation cache")
    if not np.all(gap <= JOINT_ATOL + JOINT_RTOL * np.abs(ref)):
        fail("11.2: the chromatic array's chain lies outside the class of "
             "the dense float64 oracle")
    for b, stage in ((b1, "stage1"), (b3, "stage3")):
        kern, plain, shape, exact = h.solve_calls(rec.last[b])
        h.hold_last_step(f"mega_solve@chrom_gwb_{stage}, the run's last "
                         "step", kern, plain, shape, exact)
    th = near_typical(glike, W, 31)
    with RecordBatches(mk, "mega_solve_logdet", 0) as cap:
        glike.loglike_batch(th)
    for b, stage, c in ((b1, "stage1", c1), (b3, "stage3", c3)):
        a = cap.last[b]
        kern, plain, shape, exact = h.solve_calls(a)
        entry = f"mega_solve@chrom_gwb_{stage}"
        h.hold_solve(entry, "chrom_gwb", kern, plain,
                     lambda tiers, a=a: solve_cost(*a[1].shape, a[4], tiers),
                     shape, exact=exact, what="points near typical values")
        results[entry].update(launches=c)


def phase_plane(tmp, dev, smi):
    """Phase 11.3's off/on runs and 11.4 (module docstring)."""
    import urllib.request

    from enterprise_warp_tpu_torch.utils import metricsexport

    runs = CliRuns(tmp, dev, smi)
    try:
        cost, chains, sites = {}, set(), {}
        # a first counted run, not compared (as 10.2's): the first count of
        # a process can hold a synchronising call the sampler did not make
        for i, flag in enumerate(("1", "1", "0", "0", "1")):
            pf = write_paramfile(tmp, "system_noise.dat",
                                 dest=f"system_noise_diag{i}.dat",
                                 nsamp=PLANE_AB_NSAMP,
                                 cov_update=PLANE_AB_BLOCK)
            with run_env(EWT_TELEMETRY="1", EWT_DEVICE_DIAG=flag):
                d, _, _, _, ms, ns, nb = runs.run(
                    pf, 1, f"11.3 --num 1 EWT_DEVICE_DIAG={flag}"
                    + (" (warm-up, not compared)" if i == 0 else ""),
                    sync_count=True)
                stream_check(d, f"11.3 --num 1 EWT_DEVICE_DIAG={flag}",
                             blocks=nb)
            if i == 0:
                continue
            cost.setdefault(flag, []).append((ms[0], ns))
            sites.setdefault(flag, []).append(runs.counting["sites"])
            chains.add(runs.chain_bytes(d))
            has = os.path.exists(os.path.join(d, "mixing_stats.json"))
            if has != (flag == "1"):
                fail(f"11.3: EWT_DEVICE_DIAG={flag} and mixing_stats.json "
                     f"{'exists' if has else 'is missing'}")
            if flag == "1":
                ms_json = json.load(open(os.path.join(d,
                                                      "mixing_stats.json")))
                folded = ms_json["steps_folded"]
                hist = sum(sum(v["hist"]) for v in
                           ms_json["params"].values())
                if folded != PLANE_AB_NSAMP or \
                        hist != PLANE_AB_NSAMP * 8 * len(ms_json["params"]):
                    fail(f"11.3: mixing_stats.json folded {folded} steps "
                         f"and {hist} histogram counts")
        off, on = cost["0"], cost["1"]
        print(f"11.3 --num 1: ms/step (first block) plane on "
              f"{[round(m, 3) for m, _ in on]} off "
              f"{[round(m, 3) for m, _ in off]}; host syncs in the second "
              f"block on {[s for _, s in on]} off {[s for _, s in off]}; "
              f"the four chains "
              f"{'bit for bit equal' if len(chains) == 1 else 'differ'} "
              f"[{smi}]")
        if len(chains) != 1:
            fail("11.3: the chains differ with the plane on and off")
        if len({s for _, s in off + on}) != 1:
            counts = sites["0"] + sites["1"]
            every = set().union(*counts)
            print("11.3 host syncs by site, off then on: " + "; ".join(
                f"{k} {[c[k] for c in counts]}" for k in sorted(every)
                if len({c[k] for c in counts}) > 1))
            fail("11.3: host syncs per block differ with the plane on and "
                 "off")

        # ---- 11.4: the exporter ----------------------------------------
        prom = os.path.join(tmp, "ewt_metrics.prom")
        pf = write_paramfile(tmp, "system_noise.dat",
                             dest="system_noise_export.dat",
                             nsamp=PLANE_AB_NSAMP, cov_update=PLANE_AB_BLOCK)
        with run_env(EWT_TELEMETRY="1", EWT_METRICS_TEXTFILE=prom,
                     EWT_METRICS_PORT="0", EWT_METRICS_ADDR="127.0.0.1"):
            d, *_ = runs.run(pf, 1, "11.4 --num 1 with the exporters armed")
        ev = last_session(os.path.join(d, "events.jsonl"))
        exp = {e["mode"]: e for e in ev if e["type"] == "metrics_export"}
        if sorted(exp) != ["http", "textfile"]:
            fail(f"11.4: metrics_export events {sorted(exp)}")
        text = open(prom).read()
        url = f"http://127.0.0.1:{exp['http']['port']}/metrics"
        with urllib.request.urlopen(url, timeout=30) as r:
            body = r.read().decode()
        metricsexport.stop_http_server()
        fams = sum(ln.startswith("# TYPE") for ln in text.splitlines())
        print(f"11.4: the textfile {len(text)} bytes, {fams} metric "
              f"families (stream_rhat in it: "
              f"{'ewt_stream_rhat ' in text}); GET {url}: {len(body)} "
              f"bytes, {'the same text' if body == text else 'differs'}")
        if body != text or not text.endswith("# EOF\n") or \
                "ewt_stream_rhat " not in text:
            fail("11.4: the exporters' texts differ or lack the plane's "
                 "gauges")
    finally:
        runs.close()


# ---- phase 12: the pulsar axis across processes ------------------------ #

#: steps of the sharded config 3 run (one block) and of the chain-axis run
SHARD_NSAMP = 200
#: the HMC leg over two ranks (gwb_array.dat's joint likelihood)
SHARD_HMC = dict(nchains=16, warmup=10, n_leapfrog=8, nsamp=20)
#: the health twin's run (two blocks) and sample_to_convergence's
#: (``checks`` checks of one block each) over the same two ranks
SHARD_CONV = dict(nchains=8, block=20, checks=3)
#: each rank's and the NCCL rank's time limit, in seconds
RANK_TIMEOUT_S = 420
#: the joint class (PERF.md section 2): |dlnL| <= 5e-2 + 1e-7 |lnL|
JOINT_CLASS = (5e-2, 1e-7)


def _variant(prfile, dest, tmp, **keys):
    """A copy of a paramfile with ``out`` under ``tmp/out/<dest>`` and
    ``keys`` set: replaced where the file has the key, else added before
    the model section."""
    lines = []
    with open(prfile) as fh:
        for line in fh.read().splitlines():
            key = line.split(":")[0].strip()
            if key == "out":
                line = f"out: {os.path.join(tmp, 'out', dest)}"
            elif key in keys:
                line = f"{key}: {keys.pop(key)}"
            elif line.strip() == "{0}":
                lines += [f"{k}: {v}" for k, v in keys.items()]
                keys = {}
            lines.append(line)
    path = os.path.join(tmp, dest)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def _run_dir(root):
    """The run directory under an output root: the one holding
    ``chain_1.txt``."""
    found = [r for r, _, fs in os.walk(root) if "chain_1.txt" in fs]
    if len(found) != 1:
        fail(f"{root}: {len(found)} run directories")
    return found[0]


def _digest(*arrs):
    """A short sha256 of the arrays' bytes (the ranks' state digests)."""
    import hashlib
    import numpy as np
    import torch
    h = hashlib.sha256()
    for a in arrs:
        h.update(np.ascontiguousarray(
            torch.as_tensor(a).detach().cpu().numpy()).tobytes())
    return h.hexdigest()[:16]


def pulsar_axis_rank(spec_path):
    """One rank of phase 12, launched by :func:`phase_pulsar_axis` through
    the ``EWT_*`` contract with the JSON spec at ``spec_path``: its
    ``parts`` among ``12.1`` (the config 3 paramfile through the CLI with
    ``psr_shard: 1``, then the sharded lnL at the chain's last 8 states),
    ``12.2`` (the sharded build of config 3 at those states), ``12.3``
    (gradients and an HMC leg on ``gwb_array.dat``) and ``12.4`` (the
    CLI with ``chain_shard: 1`` on ``system_noise.dat --num 0``). Writes
    its report to ``<dir>/rank<i>.json``. ``spec["device"]`` ``"cpu"``
    rehearses it on the host (no kernel launches there)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    with open(spec_path) as fh:
        spec = json.load(fh)
    sys.path.insert(0, HERE)
    from enterprise_warp_tpu_torch.parallel import distributed
    on_card = spec.get("device", "cuda") == "cuda"
    rank, world = distributed.init_distributed(
        device="cuda" if on_card else "cpu")
    from enterprise_warp_tpu_torch import cli
    from enterprise_warp_tpu_torch.ops import cuda_lib, routes
    from enterprise_warp_tpu_torch.ops import megakernel as mk
    from enterprise_warp_tpu_torch.samplers import ptmcmc
    if on_card:
        dev = torch.device(f"cuda:{rank % torch.cuda.device_count()}")
        torch.cuda.set_device(dev)
        cuda_lib.load_library()
        sync = torch.cuda.synchronize
    else:
        dev, sync = torch.device("cpu"), (lambda: None)
    rep = dict(rank=rank, world=world, device=str(dev),
               backend=dist.get_backend())
    kept = {}
    run_block, fresh, sample = (ptmcmc.PTSampler._run_block,
                                ptmcmc.PTSampler._fresh_state,
                                ptmcmc.PTSampler.sample)

    def timed_block(self, st, todo, temps=None):
        t0 = time.perf_counter()
        out = run_block(self, st, todo, temps)
        kept["block_s"] = kept.get("block_s", 0.0) \
            + time.perf_counter() - t0
        kept["steps"] = kept.get("steps", 0) + int(todo)
        return out

    def start_state(self):
        st = fresh(self)
        inner = getattr(self.like, "_like", None)
        if inner is not None:
            # the chain axis: the gathered lnL of the start state against
            # the whole batch through the likelihood itself
            l0 = inner.loglike_batch(st.x)
            kept["start_gap"] = float(((st.lnl - l0).abs()
                                       / l0.abs()).max())
        return st

    def kept_sample(self, *a, **k):
        st = sample(self, *a, **k)
        kept.update(like=self.like, st=st)
        return st

    ptmcmc.PTSampler._run_block = timed_block
    ptmcmc.PTSampler._fresh_state = start_state
    ptmcmc.PTSampler.sample = kept_sample

    def cli_run(prfile):
        kept.clear()
        routes.reset_counts()
        distributed.reset_collectives()
        t0 = time.perf_counter()
        rc = cli.main(["--prfile", prfile, "--num", "0"], device=dev)
        sync()
        st = kept["st"]
        return dict(rc=rc, wall_s=time.perf_counter() - t0,
                    launches=dict(routes.LAUNCHES),
                    routes={f"{k}/{p}": v
                            for (k, p), v in routes.ROUTES.items()},
                    coll=dict(distributed.COLLECTIVES),
                    digest=_digest(st.x, st.lnl, st.lnp), steps=int(st.step),
                    ms_step=1e3 * kept["block_s"] / kept["steps"])

    if "12.1" in spec["parts"]:
        with Record(mk, "mega_solve_logdet", 0) as rec:
            r = cli_run(spec["pf45"])
        like = kept["like"]
        r["spmd"] = bool(like._stages.get("spmd"))
        r["nshard"] = like._stages.get("nshard")
        r["stage1_sizes"] = {str(n): dict(c) for n, c in rec.sizes.items()}
        last = rec.last.get(like._stages["NW"])
        if last is not None:        # the wrapper is the card's route
            torch.save([a.cpu() if torch.is_tensor(a) else a for a in last],
                       os.path.join(spec["dir"], f"stage1.{rank}.pt"))
        dist.barrier()          # rank 0's chain is on disk
        chain = np.loadtxt(os.path.join(_run_dir(spec["out45"]),
                                        "chain_1.txt"))
        states = chain[-8:, :like.ndim]
        distributed.reset_collectives()
        lnl = like.loglike_batch(states)
        r["states_coll"] = dict(distributed.COLLECTIVES)
        r["lnl8"] = lnl.cpu().tolist()
        r.update(_axis_times(like, states, sync))
        if rank == 0:
            # whole or absent for the NCCL rank that waits for it
            tmp = spec["states"] + ".tmp.npy"
            np.save(tmp, states)
            os.replace(tmp, spec["states"])
        rep["12.1"] = r
    if "12.2" in spec["parts"]:
        # the states of 12.1; the card to itself once the pair is done,
        # so no time of either is taken beside the other's work
        t0 = time.perf_counter()
        while not os.path.exists(spec["pair_done"]):
            if time.perf_counter() - t0 > RANK_TIMEOUT_S:
                raise TimeoutError(f"no {spec['pair_done']}")
            time.sleep(0.5)
        rep["waited_s"] = time.perf_counter() - t0
        _, likes = load_likes(spec["pf45"], 0, dev, mesh=True)
        like = likes[min(likes)]
        states = np.load(spec["states"])
        routes.reset_counts()
        distributed.reset_collectives()
        lnl = like.loglike_batch(states)
        sync()
        rep["12.2"] = dict(spmd=bool(like._stages.get("spmd")),
                           nshard=like._stages.get("nshard"),
                           coll=dict(distributed.COLLECTIVES),
                           launches=dict(routes.LAUNCHES),
                           lnl8=lnl.cpu().tolist(),
                           **_axis_times(like, states, sync))
    if "12.3" in spec["parts"]:
        from enterprise_warp_tpu_torch.samplers.hmc import HMCSampler
        _, shard = load_likes(spec["gwb"], 0, dev, mesh=True)
        _, whole = load_likes(spec["gwb"], 0, dev)
        likeS, like0 = shard[min(shard)], whole[min(whole)]
        th0 = torch.as_tensor(near_typical(like0, 4, 41), device=dev)

        def value_grad(like):
            th = th0.clone().requires_grad_(True)
            lnl = like.loglike_batch(th)
            g, = torch.autograd.grad(lnl.sum(), th)
            return lnl.detach(), g

        routes.reset_counts()
        distributed.reset_collectives()
        lS, gS = value_grad(likeS)
        coll = dict(distributed.COLLECTIVES)
        l0, g0 = value_grad(like0)
        sync()
        routes.reset_counts()
        hmc_kw = dict(SHARD_HMC)
        nsamp = hmc_kw.pop("nsamp")
        h = HMCSampler(likeS, os.path.join(spec["dir"], "hmc"), seed=0,
                       **hmc_kw)
        hs = h.sample(nsamp, resume=False, verbose=False, block_size=10)
        sync()
        hmc_launches = dict(routes.LAUNCHES)
        # the sharded health twin: kernel 3 on the pinned classic chain
        # of each rank's stage 1, the words riding the collective
        from enterprise_warp_tpu_torch.ops import cholfuse as cf
        routes.reset_counts()
        os.environ["EWT_KERNEL_HEALTH"] = "1"
        try:
            with Record(cf, "chol_precond_health", 0) as hrec, \
                    Record(mk, "mega_solve_logdet", 0) as srec:
                hp = ptmcmc.PTSampler(
                    likeS, os.path.join(spec["dir"], "health"), ntemps=1,
                    nchains=SHARD_CONV["nchains"], seed=0,
                    cov_update=SHARD_CONV["block"])
                hst = hp.sample(SHARD_CONV["block"] * 2, resume=False,
                                verbose=False)
            sync()
        finally:
            os.environ.pop("EWT_KERNEL_HEALTH")
        for tag, rec in (("health", hrec), ("health_s3", srec)):
            for n, args in rec.last.items():
                torch.save([a.cpu() if torch.is_tensor(a) else a
                            for a in args],
                           os.path.join(spec["dir"], f"{tag}.{rank}.{n}.pt"))
        health = dict(
            launches=dict(routes.LAUNCHES),
            routes={f"{k}/{p}": v for (k, p), v in routes.ROUTES.items()},
            sizes={str(n): dict(c) for n, c in hrec.sizes.items()},
            stage3_sizes={str(n): dict(c) for n, c in srec.sizes.items()},
            ledgers=[led.stats() for led in hp.health or []],
            state=_digest(hst.x, hst.lnl, hst.lnp))
        # sample_to_convergence over the sharded likelihood: every check
        # after the first resumes from the checkpoint, which only rank 0
        # writes; rank 1 takes each resume from rank 0
        from enterprise_warp_tpu_torch.samplers.convergence import \
            sample_to_convergence
        states = []
        distributed.reset_collectives()
        cp = ptmcmc.PTSampler(likeS, os.path.join(spec["dir"], "conv"),
                              ntemps=1, nchains=SHARD_CONV["nchains"],
                              seed=1, cov_update=SHARD_CONV["block"])
        orig = cp.sample

        def traced(*a, **k):
            st = orig(*a, **k)
            states.append(f"{_digest(st.x, st.lnl, st.lnp)}@{st.step}")
            return st

        cp.sample = traced
        conv = sample_to_convergence(
            cp, target_ess=1e9, check_every=SHARD_CONV["block"],
            max_steps=SHARD_CONV["block"] * SHARD_CONV["checks"],
            block_size=SHARD_CONV["block"], verbose=False)
        rep["12.3"] = dict(
            spmd=bool(likeS._stages.get("spmd")), coll=coll,
            lnl_gap=float((lS - l0).abs().max()),
            grad_gap=float(((gS - g0).abs()
                            / g0.abs().clamp(min=1.0)).max()),
            grad=_digest(gS), hmc=_digest(hs.z),
            hmc_finite=bool(torch.isfinite(hs.z).all()),
            hmc_launches=hmc_launches, health=health,
            conv=dict(states=states, steps=conv.steps,
                      chains=_digest(conv.chains),
                      coll=dict(distributed.COLLECTIVES)))
    if "12.4" in spec["parts"]:
        r = cli_run(spec["chain_pf"])
        r["split"] = type(kept["like"]).__name__
        r["start_gap"] = kept.get("start_gap")
        rep["12.4"] = r
    with open(os.path.join(spec["dir"], f"rank{rank}.json"), "w") as fh:
        json.dump(rep, fh)
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0 and "12.1" in spec["parts"]:
        open(spec["pair_done"], "w").close()
    return 0


def _axis_times(like, states, sync, reps=10):
    """The sharded evaluation at ``states`` and its collective alone (a
    zero vector of the evaluation's packed length through the same
    wrapper and group), each the mean of ``reps`` after a warm call, in
    ms; every rank runs the same calls."""
    import torch
    import torch.distributed as dist
    from enterprise_warp_tpu_torch.parallel import distributed
    lay = like.mesh_layout
    width = (like._stages["npsr"] * like._stages["n_g"] * (
        like._stages["n_g"] + 1) + 6)
    buf = torch.zeros((len(states), width), dtype=torch.float64,
                      device=like.device)
    out = {}
    for key, fn in (("eval_ms", lambda: like.loglike_batch(states)),
                    ("collective_ms", lambda: distributed.all_reduce_sum(
                        buf, like.mesh.group))):
        fn()
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        out[key] = 1e3 * (time.perf_counter() - t0) / reps
    out["packed_mb"] = 8.0 * buf.numel() / 1e6
    out["payload_bytes_model"] = lay["psum_payload_bytes"]
    return out


def _launch_ranks(groups, threads):
    """Run groups of ranks of :func:`pulsar_axis_rank` side by side, each
    group ``(spec, nproc, label)`` a process group of its own through the
    EWT_* contract (a ``file://`` store in ``spec["dir"]``), each process
    with ``threads`` CPU threads; every rank is stopped at RANK_TIMEOUT_S,
    and one failed rank fails the phase. Returns each group's reports."""
    runs = []
    t0 = time.perf_counter()
    for spec, nproc, label in groups:
        d = spec["dir"]
        os.makedirs(d, exist_ok=True)
        spec_path = os.path.join(d, "spec.json")
        with open(spec_path, "w") as fh:
            json.dump(spec, fh)
        env = dict(os.environ, EWT_COORDINATOR=f"file://{d}/store",
                   EWT_NUM_PROCESSES=str(nproc), EWT_DIST_TIMEOUT_S="300",
                   OMP_NUM_THREADS=str(threads))
        code = (f"import sys; sys.path.insert(0, {HERE!r}); "
                "import chip_smoke; "
                f"sys.exit(chip_smoke.pulsar_axis_rank({spec_path!r}))")
        for i in range(nproc):
            log = open(os.path.join(d, f"rank{i}.log"), "w")
            runs.append((label, d, i, nproc, log, subprocess.Popen(
                [sys.executable, "-c", code], cwd=HERE,
                env=dict(env, EWT_PROCESS_ID=str(i)), stdout=log,
                stderr=subprocess.STDOUT)))
    try:
        for *_, p in runs:
            p.wait(timeout=max(RANK_TIMEOUT_S - (time.perf_counter() - t0),
                               1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for *_, log, p in runs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    reports = {}
    for label, d, i, nproc, _, p in runs:
        if p.returncode != 0:
            print(open(os.path.join(d, f"rank{i}.log")).read()[-3000:])
            fail(f"{label}: rank {i} of {nproc} exited {p.returncode}")
        with open(os.path.join(d, f"rank{i}.json")) as fh:
            reports.setdefault(label, []).append(json.load(fh))
    print(f"{', '.join(reports)}: done in {time.perf_counter() - t0:.1f} s")
    return [reports[label] for _, _, label in groups]


def _in_joint_class(a, ref):
    import numpy as np
    a, ref = np.asarray(a), np.asarray(ref)
    gap = np.abs(a - ref)
    ok = np.isfinite(a).all() and bool(np.all(
        gap <= JOINT_CLASS[0] + JOINT_CLASS[1] * np.abs(ref)))
    return ok, float(gap.max())


def phase_pulsar_axis(tmp, dev, smi, results, pf45, like45, step_ms45, h):
    """Phase 12, the pulsar axis across processes (module docstring);
    ``like45`` is config 3's unsharded likelihood on the card,
    ``step_ms45`` its ms/step in this smoke, ``h`` main's ``hold_solve``
    and ``solve_calls``."""
    import numpy as np
    import torch
    from enterprise_warp_tpu_torch.utils import telemetry
    d = os.path.join(tmp, "axis")
    out45 = os.path.join(tmp, "out", "pta45_shard.dat")
    spec = dict(
        dir=d, out45=out45, states=os.path.join(d, "states.npy"),
        pair_done=os.path.join(d, "pair_done"),
        pf45=_variant(pf45, "pta45_shard.dat", tmp, psr_shard=1,
                      nsamp=SHARD_NSAMP),
        gwb=write_paramfile(tmp, "gwb_array.dat", dest="gwb_shard.dat"),
        chain_pf=write_paramfile(tmp, "system_noise.dat",
                                 dest="sn_chain_shard.dat",
                                 nsamp=SHARD_NSAMP,
                                 extra={"chain_shard": 1}),
        parts=["12.1", "12.3", "12.4"])
    # the NCCL rank of 12.2 starts beside the pair (its process and CUDA
    # start overlap) and waits until the pair is done before it builds
    # and times anything; its process group is its own
    spec2 = dict(spec, dir=os.path.join(d, "nccl"), parts=["12.2"])
    reps, nccl = _launch_ranks(
        [(spec, 2, "12 pulsar axis (two gloo ranks on cuda:0)"),
         (spec2, 1, "12.2 one NCCL rank")],
        max(1, (os.cpu_count() or 1) // 3))
    # ---- 12.1 ----
    r = [rep["12.1"] for rep in reps]
    for i, x in enumerate(r):
        print(f"12.1 rank {i} ({reps[i]['backend']}, {reps[i]['device']}):"
              f" rc {x['rc']} nshard {x['nshard']} launches {x['launches']}"
              f" routes {x['routes']} collectives {x['coll']} stage-1 "
              f"solve calls {x['stage1_sizes']} state {x['digest']} "
              f"{x['ms_step']:.3f} ms/step (unsharded config 3 in this "
              f"smoke: {step_ms45:.3f} ms/step); at the 8 states one "
              f"evaluation "
              f"{x['eval_ms']:.3f} ms, its collective alone "
              f"{x['collective_ms']:.3f} ms ({x['packed_mb']:.3f} MB) "
              f"[{smi}]")
        if x["rc"] != 0 or not x["spmd"] or x["nshard"] != 2:
            fail(f"12.1: rank {i} did not run the sharded path")
        if x["launches"]["mega_solve"] <= 0:
            fail(f"12.1: the solve kernel never launched on rank {i}")
        if x["coll"].get("all_gather") or x["states_coll"] != \
                {"all_reduce": 1}:
            fail(f"12.1: rank {i}: not one all_reduce and no all_gather "
                 f"per evaluation ({x['states_coll']}, run {x['coll']})")
    if r[0]["digest"] != r[1]["digest"] or r[0]["lnl8"] != r[1]["lnl8"]:
        fail("12.1: the ranks' final states differ")
    out45 = _run_dir(out45)
    names = set(os.listdir(out45))
    ranked = {n for n in names if ".1." in n}
    print(f"12.1 output directory: {sorted(names)}")
    if not {"chain_1.txt", "pars.txt", "cov.npy", "events.jsonl",
            "mesh_stats.json"} <= names or \
            ranked != {"events.1.jsonl", "mesh_stats.1.json"}:
        fail("12.1: rank 0 must write the run's files and rank 1 only "
             "events.1.jsonl and mesh_stats.1.json")
    stream_check(out45, "12.1 rank 0")
    problems, msgs = telemetry.check_stream(os.path.join(out45,
                                                         "events.1.jsonl"))
    if problems:
        fail(f"12.1: events.1.jsonl has {problems} problem(s): {msgs}")
    mesh = [json.load(open(os.path.join(out45, n))) for n in
            ("mesh_stats.json", "mesh_stats.1.json")]
    print(f"12.1 mesh_stats: shard work {mesh[0]['shard_work']} evals "
          f"{mesh[0]['shard_evals']} skew {mesh[0]['shard_skew']:.4f} "
          f"(model {mesh[0]['model_skew']:.4f}), collective share of the "
          f"block wall by the cost model "
          f"{mesh[0]['collective_frac_model']:.4f}")
    if mesh[0]["shard_evals"] != mesh[1]["shard_evals"]:
        fail("12.1: the ranks' mesh ledgers differ")
    states = np.load(spec["states"])
    l45 = like45.loglike_batch(states).cpu().numpy()
    print(f"12.1 the unsharded build at the 8 states: one evaluation "
          f"{time_cuda(lambda: like45.loglike_batch(states), 2, 10):.3f} ms "
          f"[{smi}]")
    ok, gap = _in_joint_class(r[0]["lnl8"], l45)
    print(f"12.1 sharded lnL at the chain's last 8 states against the "
          f"unsharded port on the card: largest gap {gap:.3e} (class "
          f"{JOINT_CLASS[0]:g} + {JOINT_CLASS[1]:g} |lnL|)")
    if not ok:
        fail("12.1: the sharded lnL lies outside the joint class")
    # kernel 1 at each rank's stage-1 shape, held on the run's last step
    for i in range(2):
        a = torch.load(os.path.join(d, f"stage1.{i}.pt"))
        a = [t.to(dev) if torch.is_tensor(t) else t for t in a]
        kern, plain, shape, exact = h.solve_calls(a)
        entry = f"mega_solve@psr_shard_r{i}"
        h.hold_solve(entry, f"shard_r{i}", kern, plain,
                     lambda tiers: solve_cost(*a[1].shape, a[4], tiers),
                     shape, exact=exact, what=f"rank {i}'s last step")
        results[entry]["launches"] = r[i]["launches"]["mega_solve"]
    # ---- 12.2: one NCCL rank ----
    x = nccl[0]
    ok, gap = _in_joint_class(x["12.2"]["lnl8"], l45)
    print(f"12.2 one rank ({x['backend']}): nshard {x['12.2']['nshard']} "
          f"collectives {x['12.2']['coll']} launches "
          f"{x['12.2']['launches']}; lnL at the same 8 states against the "
          f"unsharded build: largest gap {gap:.3e}; one evaluation "
          f"{x['12.2']['eval_ms']:.3f} ms, its collective alone "
          f"{x['12.2']['collective_ms']:.3f} ms [{smi}]")
    if x["backend"] != "nccl" or not x["12.2"]["spmd"] or \
            x["12.2"]["coll"] != {"all_reduce": 1} or not ok:
        fail("12.2: the one-rank NCCL build is not the sharded path within "
             "the class with one collective")
    # ---- 12.3 ----
    g = [rep["12.3"] for rep in reps]
    for i, x in enumerate(g):
        print(f"12.3 rank {i}: gwb_array gradient at 4 states, largest "
              f"|dg|/max(1,|g|) {x['grad_gap']:.3e}, |dlnL| "
              f"{x['lnl_gap']:.3e}, collectives {x['coll']}; HMC "
              f"{SHARD_HMC} finite {x['hmc_finite']} state {x['hmc']} "
              f"launches {x['hmc_launches']}")
        if not (x["spmd"] and x["grad_gap"] <= 1e-3 and x["hmc_finite"]
                and x["coll"] == {"all_reduce": 1, "all_reduce_grad": 1}):
            fail(f"12.3: rank {i}: the sharded gradient or the HMC leg")
        # kernel 1 forward; its backward is the plain AD twin of the
        # solve chain (ops/megakernel.py:_MegaSolve), as on one card
        if x["hmc_launches"]["mega_solve"] <= 0:
            fail(f"12.3: rank {i}: the HMC leg did not run kernel 1")
    if g[0]["grad"] != g[1]["grad"] or g[0]["hmc"] != g[1]["hmc"]:
        fail("12.3: the ranks' gradients or HMC states differ")
    # the sharded health twin: kernel 3 on each rank's stage 1, the same
    # words (so the same ledgers and ladder decisions) on both ranks
    from enterprise_warp_tpu_torch.ops import cholfuse as cf
    for i, x in enumerate(g):
        hx = x["health"]
        print(f"12.3 rank {i} health twin (EWT_KERNEL_HEALTH=1, "
              f"{SHARD_CONV['block'] * 2} steps, W {SHARD_CONV['nchains']}):"
              f" launches {hx['launches']} routes {hx['routes']} kernel-3 "
              f"calls by order and batch {hx['sizes']} state {hx['state']}; "
              f"ledgers {hx['ledgers']}")
        if not hx["launches"].get("chol_precond") or not hx["ledgers"] \
                or not all(led["n_evals"] > 0 for led in hx["ledgers"]):
            fail(f"12.3: rank {i}: the sharded health twin did not run "
                 f"kernel 3 or fold its words")
    if g[0]["health"]["ledgers"] != g[1]["health"]["ledgers"] or \
            g[0]["health"]["state"] != g[1]["health"]["state"]:
        fail("12.3: the ranks' health ledgers or states differ")
    for i in range(2):
        sizes = g[i]["health"]["sizes"]
        if len(sizes) != 1:
            fail(f"12.3: rank {i}: kernel 3 at more than one order {sizes}")
        (n, calls), = sizes.items()
        S_, a, b = (t.to(dev) if torch.is_tensor(t) else t
                    for t in torch.load(os.path.join(
                        d, f"health.{i}.{n}.pt")))
        S_ = S_.contiguous()
        entry = f"chol_precond@psr_shard_health_r{i}"
        err, tiers = hold_precond_run(torch, cf, entry, S_, a, b, dev)
        ms = time_cuda(lambda: cf._chol_precond_cuda(S_, a, b))
        plain_ms = time_cuda(lambda: cf._fused_torch(S_, a, b))
        flops, nbytes = chol_cost(S_.shape[0], int(n), tiers)
        bms, bby = bound(flops, nbytes)
        print(f"{entry} at {tuple(S_.shape)}: kernel {ms:.4f} ms  plain "
              f"{plain_ms:.4f} ms  bound {bms:.3g} ms ({bby}; "
              f"{flops / 1e9:.6f} GFLOP, {nbytes / 1e6:.4f} MB) median of "
              f"50 [{smi}]")
        if sum(calls.values()) != g[i]["health"]["launches"]["chol_precond"]:
            fail(f"12.3: rank {i}: kernel-3 calls {calls} against launches "
                 f"{g[i]['health']['launches']}")
        results[entry] = dict(
            run=f"shard_health_r{i}", shape=f"Sn {tuple(S_.shape)}",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=bby, launches=g[i]["health"]["launches"]["chol_precond"])
    # the twin's stage 3, replicated: kernel 1 on the same system on both
    # ranks, held on rank 0's last step
    s3 = [x["health"]["stage3_sizes"] for x in g]
    if s3[0] != s3[1] or len(s3[0]) != 1 or sum(
            next(iter(s3[0].values())).values()) != \
            g[0]["health"]["launches"]["mega_solve"]:
        fail(f"12.3: the health twin's stage-3 solves {s3} against launches "
             f"{[x['health']['launches'] for x in g]}")
    n3, = s3[0]
    a = torch.load(os.path.join(d, f"health_s3.0.{n3}.pt"))
    a = [t.to(dev) if torch.is_tensor(t) else t for t in a]
    kern, plain, shape, exact = h.solve_calls(a)
    h.hold_solve("mega_solve@psr_shard_health_stage3", "shard_health_s3",
                 kern, plain,
                 lambda tiers: solve_cost(*a[1].shape, a[4], tiers), shape,
                 exact=exact, what="rank 0's last step")
    results["mega_solve@psr_shard_health_stage3"]["launches"] = \
        g[0]["health"]["launches"]["mega_solve"]
    # sample_to_convergence over the two ranks: every resume after the
    # first check taken from rank 0, the same state at every check
    for i, x in enumerate(g):
        print(f"12.3 rank {i} sample_to_convergence ({SHARD_CONV['checks']}"
              f" checks of {SHARD_CONV['block']} steps): states "
              f"{x['conv']['states']} collectives {x['conv']['coll']}")
    if g[0]["conv"] != g[1]["conv"] or \
            len(g[0]["conv"]["states"]) != SHARD_CONV["checks"] or \
            g[0]["conv"]["coll"].get("broadcast") != SHARD_CONV["checks"] - 1:
        fail("12.3: the ranks' states differ across sample_to_convergence's "
             "checks")
    # ---- 12.4 ----
    c = [rep["12.4"] for rep in reps]
    whole_pf = write_paramfile(tmp, "system_noise.dat",
                               dest="sn_chain_whole.dat", nsamp=SHARD_NSAMP)
    from enterprise_warp_tpu_torch import cli
    from enterprise_warp_tpu_torch.samplers import ptmcmc
    run_block, blocks = ptmcmc.PTSampler._run_block, [0.0, 0]

    def timed_block(self, st, todo, temps=None):
        t0 = time.perf_counter()
        out = run_block(self, st, todo, temps)
        blocks[0] += time.perf_counter() - t0
        blocks[1] += int(todo)
        return out

    ptmcmc.PTSampler._run_block = timed_block
    try:
        rc = cli.main(["--prfile", whole_pf, "--num", "0"], device="cuda")
    finally:
        ptmcmc.PTSampler._run_block = run_block
    if rc != 0:
        fail("12.4: the unsharded run failed")
    chains = [open(os.path.join(_run_dir(os.path.join(tmp, "out", dest)),
                                "chain_1.txt"), "rb").read()
              for dest in ("sn_chain_shard.dat", "sn_chain_whole.dat")]
    for i, x in enumerate(c):
        print(f"12.4 rank {i}: rc {x['rc']} {x['split']} collectives "
              f"{x['coll']} launches {x['launches']} start-state lnL "
              f"gathered against the whole batch: largest relative gap "
              f"{x['start_gap']:.3e}; state {x['digest']}; "
              f"{x['ms_step']:.3f} ms/step")
        if x["rc"] != 0 or x["split"] != "_ChainSplit" or \
                x["start_gap"] > 1e-9 or x["coll"].get("all_reduce") or \
                x["coll"].get("all_gather", 0) != SHARD_NSAMP + 1:
            fail(f"12.4: rank {i}: the chain axis' evaluation split")
    if c[0]["digest"] != c[1]["digest"]:
        fail("12.4: the ranks' final states differ")
    print(f"12.4 the sharded chain bit for bit the unsharded run's at the "
          f"same seed: {chains[0] == chains[1]}; the unsharded run "
          f"{1e3 * blocks[0] / blocks[1]:.3f} ms/step, one process, after "
          f"the pair [{smi}]")
    # ---- 12.5 ----
    ncard = torch.cuda.device_count()
    if ncard > 1:
        n = min(ncard, 4)
        spec5 = dict(spec, dir=os.path.join(d, "multi"), parts=["12.1"],
                     states=os.path.join(d, "multi", "states.npy"),
                     pair_done=os.path.join(d, "multi", "pair_done"),
                     out45=os.path.join(tmp, "out", "pta45_multi.dat"),
                     pf45=_variant(pf45, "pta45_multi.dat", tmp, psr_shard=1,
                                   nsamp=SHARD_NSAMP))
        m, = _launch_ranks([(spec5, n, f"12.5 {n} NCCL ranks, one a card")],
                           max(1, (os.cpu_count() or 1) // n))
        for i, x in enumerate(m):
            y = x["12.1"]
            print(f"12.5 rank {i} ({x['backend']}, {x['device']}): "
                  f"launches {y['launches']} {y['ms_step']:.3f} ms/step "
                  f"state {y['digest']}")
        if len({x["12.1"]["digest"] for x in m}) != 1 or \
                any(x["backend"] != "nccl" for x in m):
            fail("12.5: the NCCL ranks' final states differ")
    else:
        print(f"multi-GPU: not run ({ncard} device visible)")


def main():
    if not os.path.isdir(os.path.join(HERE, PKG)):
        print(f"chip_smoke: {PKG}/ not found next to this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    laps = [t_start]

    def lap(phase):
        """Print the wall time of the phase that just ended."""
        laps.append(time.perf_counter())
        print(f"chip_smoke: phase {phase} took {laps[-1] - laps[-2]:.1f} s")
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
    # the host IO core (the .tim parser and the chain tables), no kernel
    from enterprise_warp_tpu_torch import native
    t0 = time.perf_counter()
    if native.load() is None:
        fail(f"the native IO core ({native.SRC}) did not build")
    print(f"build: {os.path.relpath(native.SRC, HERE)} with g++ into "
          f"{os.path.relpath(native.SO_PATH, HERE)} in "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- phase 3: kernels vs plain versions at the main path's shapes ----
    lap("1-2")
    from enterprise_warp_tpu_torch.ops import cholfuse as cf
    from enterprise_warp_tpu_torch.ops import routes
    from enterprise_warp_tpu_torch.samplers.ptmcmc import sampler_options
    # one entry of the ``kernels`` line per kernel and main path that
    # runs it, at that path's shapes
    results = {}
    # per likelihood-kernel call held on a sampler's inputs: the largest
    # ratio of its Gram's error to the float32 rounding bound, over every
    # walker of the call
    gram_ratios = {}

    def compare(entry, kern, plain, shape):
        """A megakernel against its plain version on the same CUDA inputs:
        ``Z`` and ``ld`` within ATOL. Returns the errors and the tiers."""
        Zk, ldk, tk = kern()
        Zp, ldp = plain()
        torch.cuda.synchronize()
        ez = float((Zk - Zp).abs().max())
        el = float((ldk - ldp).abs().max())
        print(f"{entry} at {shape}: max|dZ| {ez:.3e} (max|Z| "
              f"{float(Zp.abs().max()):.3e}) max|dld| {el:.3e} tiers "
              f"{tk.tolist()}")
        if not (torch.isfinite(Zk).all() and torch.isfinite(ldk).all()):
            fail(f"{entry}: non-finite kernel output")
        if ez > ATOL or el > ATOL:
            fail(f"{entry}: kernel and plain version differ by more than "
                 f"atol {ATOL}")
        return ez, el, tk

    def hold_last_step(entry, kern, plain, shape, exact):
        """A megakernel against its plain version on the inputs a
        sampler's last step gave, wherever the chain stood, walker by
        walker. ``exact``: the float64 ``(Z, ld, cond)`` of the same
        equilibrated systems, and for the likelihood kernel a fourth
        item, :func:`own_system` of its inputs. A walker whose
        condition number is at most KAPPA_MAX is held: ``Z`` and ``ld``
        within ATOL of the plain version's or, where float32 rounding
        puts the two further apart, the kernel at most twice as far from
        float64 as the plain version plus ATOL and within ARB_REL of the
        walker's largest float64 |Z| (and of max(1, |ld|)). The
        likelihood kernel is held there on its own float32 system: its
        Gram within GRAM_BOUND_FRAC of the worst-case rounding bound of
        float32 dot products (:func:`own_system`; the largest ratio over
        every walker of the call is printed), and its solve of that system against the
        plain version's solve of the same system and the float64 one
        (two float32 Grams of a system at cond 1e3-1e4 move Z by up to
        cond u |Z| in random directions, so the end-to-end comparison
        could not tell a right kernel from a wrong one). A walker above
        KAPPA_MAX (or whose system is not positive
        definite in float64, where the preconditioning Cholesky has no
        factor to find) is beyond what a float32 solve resolves: it is
        reported, and its outputs must only be finite; a call with no
        walker to hold fails. Each walker gets a
        line up to 16 walkers; above that, the summary and any walker
        outside ATOL.
        Returns the held walkers' largest |kernel - plain| in Z and ld,
        and the kernel's tiers."""
        Zk, ldk, tk = kern()
        Zp, ldp = plain()
        Za, lda, kappa, *own = exact()
        torch.cuda.synchronize()
        if not (torch.isfinite(Zk).all() and torch.isfinite(ldk).all()):
            fail(f"{entry}: non-finite kernel output")
        held, err, split = [], 0.0, None
        if own:
            own = own[0]()
            ratio = own[1]
        each = Zk.shape[0] <= 16
        for b in range(Zk.shape[0]):
            dz = float((Zk[b] - Zp[b]).abs().max())
            dl = float((ldk[b] - ldp[b]).abs())
            fk = (float((Zk[b].double() - Za[b]).abs().max()),
                  float((ldk[b].double() - lda[b]).abs()))
            fp = (float((Zp[b].double() - Za[b]).abs().max()),
                  float((ldp[b].double() - lda[b]).abs()))
            zmax = float(Za[b].abs().max())
            kb = float(kappa[b])
            line = (f"{entry} at {shape}, walker {b}: cond {kb:.3e} max|Z| "
                    f"{zmax:.3e} |k-p| Z {dz:.3e} ld {dl:.3e}; from float64 "
                    f"kernel {fk[0]:.3e} / {fk[1]:.3e}, plain {fp[0]:.3e} / "
                    f"{fp[1]:.3e}, tier {int(tk[b])}")
            if kb > KAPPA_MAX:
                if each or dz > ATOL or dl > ATOL:
                    print(line + f": beyond float32 (cond > {KAPPA_MAX:g}, "
                          "or not positive definite in float64), not held")
                continue
            held.append(b)
            err = max(err, dz, dl)
            if each or dz > ATOL or dl > ATOL:
                print(line)
            if dz <= ATOL and dl <= ATOL:
                continue
            lda_b = float(lda[b])
            if own:
                if split is None:
                    Sn_k, _, (Bs, sj1, sj2, sref) = own
                    split = (*mk._mega_solve_torch(Sn_k, Bs, sj1, sj2, sref),
                             *exact_solve(Sn_k, Bs)[:2])
                Zp2, ldp2, Za2, lda2 = split
                fk = (float((Zk[b].double() - Za2[b]).abs().max()),
                      float((ldk[b].double() - lda2[b]).abs()))
                fp = (float((Zp2[b].double() - Za2[b]).abs().max()),
                      float((ldp2[b].double() - lda2[b]).abs()))
                zmax, lda_b = float(Za2[b].abs().max()), float(lda2[b])
                print(f"{entry}, walker {b}, on the kernel's own float32 "
                      f"system: its Gram {float(ratio[b]):.3f} of the "
                      f"float32 rounding bound; from float64 kernel "
                      f"{fk[0]:.3e} / {fk[1]:.3e}, the plain version's solve "
                      f"{fp[0]:.3e} / {fp[1]:.3e}")
                if not float(ratio[b]) <= GRAM_BOUND_FRAC:
                    fail(f"{entry}, walker {b}: the kernel's Gram lies "
                         f"beyond {GRAM_BOUND_FRAC:g} of the rounding bound "
                         "of float32 dot products")
            lim = (ARB_REL * zmax, ARB_REL * max(1.0, abs(lda_b)))
            if not all(k <= 2.0 * q + ATOL and k <= m
                       for k, q, m in zip(fk, fp, lim)):
                fail(f"{entry}, walker {b}: kernel and plain version more "
                     f"than atol {ATOL} apart, and the kernel's distance "
                     "from float64 exceeds twice the plain version's plus "
                     f"atol or {ARB_REL:.3g} of the float64 value")
        if not held:
            fail(f"{entry}: no walker within the condition bound to hold")
        if own:
            gram_ratios[entry] = float(ratio[held].max())
            print(f"{entry}: the kernel's Gram at most "
                  f"{gram_ratios[entry]:.4f} of the float32 rounding bound "
                  f"on the {len(held)} held walkers (median "
                  f"{float(ratio[held].median()):.4f}; "
                  f"{float(ratio.max()):.4f} over all {ratio.numel()})")
        print(f"{entry}: {len(held)} of {Zk.shape[0]} walkers held (cond "
              f"<= {KAPPA_MAX:g}; median cond "
              f"{float(kappa.median()):.3e}); held walkers' largest "
              f"|kernel - plain| {err:.3e}")
        return err, tk

    def hold_solve(entry, run, kern, plain, cost, shape, exact=None,
                   what=None):
        """:func:`compare` within ATOL (or, given the float64 ``exact``,
        :func:`hold_last_step` walker by walker under the condition bound,
        on inputs described by ``what``), both versions timed, and the
        bound from this run's tiers."""
        if exact is None:
            ez, el, tk = compare(entry, kern, plain, shape)
        else:
            ez, tk = hold_last_step(f"{entry}, {what}", kern, plain, shape,
                                    exact)
            el = ez
        ms = time_cuda(kern)
        plain_ms = time_cuda(plain)
        flops, nbytes = cost(tk.tolist())
        bms, bby = bound(flops, nbytes)
        print(f"{entry} at {shape}: kernel {ms:.4f} ms  plain {plain_ms:.4f}"
              f" ms  bound {bms:.4f} ms ({bby}; {flops / 1e9:.4f} GFLOP, "
              f"{nbytes / 1e6:.3f} MB) [{smi}]")
        results[entry] = dict(run=run, shape=shape, max_abs_err=max(ez, el),
                              ms=ms, plain_ms=plain_ms, bound_ms=bms,
                              bound_by=bby)

    def site_row(entry, run, rec, n, ev):
        """The row of the evaluation cache's site updates: their stage-1
        launches, one system each (order ``n``, batch 1), one per site
        update. Every such system of the sequence is held against the
        plain version walker by walker under the condition bound (as one
        stacked batch); the kernel and the plain version are timed at
        batch 1 on the last one."""
        calls = rec.calls[(n, 1)]
        if not 0 < len(calls) == ev.counters["site"] \
                <= launches[run]["mega_solve"]:
            fail(f"{entry}: {len(calls)} one-system stage-1 launches for "
                 f"{ev.counters['site']} site updates and "
                 f"{launches[run]['mega_solve']} counted launches")
        a = calls[-1]
        stack = (torch.cat([c[0] for c in calls]),
                 torch.cat([c[1] for c in calls]), *a[2:])
        shape = f"Sn {tuple(a[0].shape)} Bn {tuple(a[1].shape)}"
        err, _ = hold_last_step(
            f"{entry}, the sequence's {len(calls)} site systems",
            lambda: mk._mega_solve_cuda(*stack),
            lambda: mk._mega_solve_torch(*stack),
            f"Sn {tuple(stack[0].shape)}", lambda: exact_solve(*stack[:2]))
        tk = mk._mega_solve_cuda(*a)[2]
        ms = time_cuda(lambda: mk._mega_solve_cuda(*a))
        plain_ms = time_cuda(lambda: mk._mega_solve_torch(*a))
        flops, nbytes = solve_cost(*a[1].shape, a[4], tk.tolist())
        bms, bby = bound(flops, nbytes)
        print(f"{entry} at {shape}: kernel {ms:.4f} ms  plain {plain_ms:.4f}"
              f" ms  bound {bms:.4f} ms ({bby}; {flops / 1e9:.6f} GFLOP, "
              f"{nbytes / 1e6:.4f} MB) [{smi}]")
        results[entry] = dict(run=run, shape=shape, max_abs_err=err, ms=ms,
                              plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                              launches=len(calls),
                              batch_sizes=dict(rec.sizes[n]))

    def hold_like(entry, run, args):
        S32, w, s, ivb, Bl, j1, j2, refine = args
        hold_solve(entry, run, lambda: mk._mega_like_cuda(*args),
                   lambda: mk._mega_like_torch(*args),
                   lambda tiers: like_cost(S32, Bl, refine, tiers),
                   f"S {tuple(S32.shape)} w {tuple(w.shape)} Bn "
                   f"{tuple(Bl.shape)}")
        results[entry].update(like_pipeline(
            torch, mk, cuda_lib.load_library(), args, entry,
            results[entry]["ms"], smi))

    def precond_row(entry, run, S_, a, b, tiers, err):
        """The preconditioner kernel's row: the kernel and its plain
        version timed on ``S_``, the bound from the kernel's ``tiers``,
        and ``err`` from :func:`hold_precond`."""
        ms = time_cuda(lambda: cf._chol_precond_cuda(S_, a, b))
        plain_ms = time_cuda(lambda: cf._fused_torch(S_, a, b))
        B, n = S_.shape[0], S_.shape[-1]
        flops, nbytes = chol_cost(B, n, tiers)
        bms, bby = bound(flops, nbytes)
        print(f"{entry} at {tuple(S_.shape)}: kernel {ms:.4f} ms  plain "
              f"{plain_ms:.4f} ms  bound {bms:.4f} ms ({bby}; "
              f"{flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.3f} MB) [{smi}]")
        results[entry] = dict(run=run, shape=f"Sn {tuple(S_.shape)}",
                              max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=bms, bound_by=bby)

    def solve_calls(args):
        return (lambda: mk._mega_solve_cuda(*args),
                lambda: mk._mega_solve_torch(*args),
                f"Sn {tuple(args[0].shape)} Bn {tuple(args[1].shape)}",
                lambda: exact_solve(*args[:2]))

    def like_calls(args):
        return (lambda: mk._mega_like_cuda(*args),
                lambda: mk._mega_like_torch(*args),
                f"S {tuple(args[0].shape)} w {tuple(args[1].shape)} Bn "
                f"{tuple(args[4].shape)}",
                lambda: exact_solve(*like_system(*args[:5]))
                + (lambda: own_system(args),))

    with tempfile.TemporaryDirectory() as tmp:
        prfile = write_paramfile(tmp, "system_noise.dat", nsamp=NSAMP)
        likes, walkers = {}, None
        for num in (0, 1):
            params, ls = load_likes(prfile, num, dev)
            likes[num] = ls[0]
            popts, _ = sampler_options(params)
            walkers = popts["ntemps"] * 8
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
            oracle = load_likes(prfile, num, "cpu", gram_mode="f64")[1][0]
            ref = oracle.loglike_batch(near_truth(oracle, walkers, num))
            gap = (lnl.cpu() - ref).abs()
            print(f"lnL --num {num} on the card vs float64 on the CPU: "
                  f"max|dlnL| {float(gap.max()):.3e} over {walkers} walkers")
            if not bool((gap <= 5e-2 + 1e-3 * ref.abs()).all()):
                fail(f"--num {num}: lnL on the card disagrees with the "
                     "float64 oracle")
        Sn, Bn, j1, j2, refine = cap_s.args
        print(f"refine {refine} / {cap_l.args[-1]}")

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
        # the same, at the main path's order: the tier ladder crosses the
        # pipeline's launch boundaries
        St, Bt = three_tier_fixture(torch, dev, n=Sn.shape[-1],
                                    k=Bn.shape[-1])
        Zk, ldk, tk = mk._mega_solve_cuda(St, Bt, 1e-6, 1e-2, refine)
        Zp, ldp = mk._mega_solve_torch(St, Bt, 1e-6, 1e-2, refine)
        torch.cuda.synchronize()
        tier_err = max(float((Zk - Zp).abs().max()),
                       float((ldk - ldp).abs().max()))
        print(f"three-tier fixture n={St.shape[-1]}: tiers {tk.tolist()} "
              f"max|err| {tier_err:.3e} (max|Z| {float(Zp.abs().max()):.3e})")
        if tk.tolist() != [1, 2, 3] or not tier_err <= ATOL:
            fail(f"three-tier fixture n={St.shape[-1]} disagrees with the "
                 "plain version")
        hold_solve("mega_solve@pt", "pt0",
                   lambda: mk._mega_solve_cuda(Sn, Bn, j1, j2, refine),
                   lambda: mk._mega_solve_torch(Sn, Bn, j1, j2, refine),
                   lambda tiers: solve_cost(*Bn.shape, refine, tiers),
                   f"Sn {tuple(Sn.shape)} Bn {tuple(Bn.shape)}")
        results["mega_solve@pt"]["phases_ms"] = solve_pipeline(
            torch, mk, cuda_lib.load_library(), Sn, Bn, j1, j2, refine,
            results["mega_solve@pt"]["ms"], smi)
        hold_like("mega_like@pt", "pt1", cap_l.args)
        # the likelihood pipeline on the three tiers at the path's nb, and
        # at the caps, with the path's jitters and refinement count
        lj1, lj2, lrefine = cap_l.args[-3:]
        lib = cuda_lib.load_library()
        hold_like_fixture(
            torch, mk, lib, "three-tier fixture nb=120",
            like_tier_fixture(torch, dev) + [1e-6, 1e-2, lrefine], [1, 2, 3])
        hold_like_fixture(
            torch, mk, lib, "at the caps (ntoa 4096, nb 192, W 8)",
            like_inputs(torch, dev, 4096, 192, 8, 4, 7)
            + [lj1, lj2, lrefine])

        # ---- phase 4: the gradient path and its kernels ------------------
        lap("3")
        hmc_prfile = write_paramfile(tmp, "hmc_single_psr.dat", **HMC_KEYS)
        hlike = load_likes(hmc_prfile, 0, dev)[1][0]
        horacle = load_likes(hmc_prfile, 0, "cpu", gram_mode="f64")[1][0]
        nch = HMC_KEYS["nchains"]
        th = near_typical(hlike, nch, 3)
        x = torch.tensor(th, device=dev, requires_grad=True)
        routes.reset_counts()
        with Capture(mk, "mega_like") as cap_h:
            lnl = hlike.loglike_batch(x)
        torch.cuda.synchronize()
        fwd = dict(routes.LAUNCHES)
        with Capture(cf, "chol_precond") as cap_c:
            g, = torch.autograd.grad(lnl.sum(), x)
        torch.cuda.synchronize()
        bwd = {k: routes.LAUNCHES[k] - fwd[k] for k in routes.KERNELS}
        print(f"gradient path: forward launches {fwd}, backward launches "
              f"{bwd}")
        if fwd["mega_like"] != 1 or fwd["chol_precond"] != 0:
            fail("the forward did not go through the likelihood kernel")
        if bwd["chol_precond"] != 1:
            fail("the backward did not go through the preconditioner "
                 "kernel")
        xo = torch.tensor(th, requires_grad=True)
        lo = horacle.loglike_batch(xo)
        go, = torch.autograd.grad(lo.sum(), xo)
        dl = (lnl.detach().cpu() - lo.detach()).abs()
        dg = (g.cpu() - go).abs() / go.abs().clamp(min=1.0)
        print(f"gradient on the card vs float64 on the CPU ({nch} points, "
              f"{hlike.ndim} parameters): max|dlnL| {float(dl.max()):.3e}, "
              f"max |dg|/max(1,|g|) {float(dg.max()):.3e}, max|g| "
              f"{float(go.abs().max()):.1f}")
        if not (torch.isfinite(g).all() and bool((dg <= 1e-3).all())):
            fail("the card's gradient disagrees with the float64 gradient")
        if not bool((dl <= 5e-2 + 1e-3 * lo.detach().abs()).all()):
            fail("the card's lnL disagrees with the float64 oracle")

        # where a gradient evaluation's time goes: the forward alone, and
        # forward plus backward, host clock around a synchronized call
        def host_ms(fn, reps=10):
            fn()
            ts = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append(1e3 * (time.perf_counter() - t0))
            return statistics.median(ts)

        def value_and_grad():
            xx = torch.tensor(th, device=dev, requires_grad=True)
            torch.autograd.grad(hlike.loglike_batch(xx).sum(), xx)

        with torch.no_grad():
            fwd_ms = host_ms(lambda: hlike.loglike_batch(th))
        vg_ms = host_ms(value_and_grad)
        print(f"gradient path at W={nch}: forward {fwd_ms:.3f} ms, forward "
              f"+ backward {vg_ms:.3f} ms (host clock, median of 10) "
              f"[{smi}]")
        # the ADVI batch: 16 draws per step
        with Capture(mk, "mega_like") as cap_la, \
                Capture(cf, "chol_precond") as cap_a:
            xa = torch.tensor(near_typical(hlike, 16, 4), device=dev,
                              requires_grad=True)
            torch.autograd.grad(hlike.loglike_batch(xa).sum(), xa)
        hold_like("mega_like@advi", "advi", cap_la.args)
        hold_like("mega_like@hmc", "hmc", cap_h.args)

        Sc, cj1, cj2 = cap_c.args
        Sa = cap_a.args[0].detach()
        Sc = Sc.detach()
        print(f"chol_precond: j1 {cj1} j2 {cj2}")
        Sp, tiers_p = precond_fixture(torch, dev)
        cases = [("chol_precond@advi", "advi", Sa, cj1, cj2, None),
                 ("chol_precond@hmc", "hmc", Sc, cj1, cj2, None),
                 ("three-tier n=16", None, Sf, 1e-6, 1e-3, [1, 2, 3]),
                 ("three-tier n=60", None, Sp, 1e-6, 1e-3, tiers_p)]
        lib = cuda_lib.load_library()
        smem_maxn = int(lib.chol_precond_smem_maxn())
        for entry, run, S_, a, b, expect in cases:
            *trio_k, tk = cf._chol_precond_cuda(S_, a, b)
            tiers = tk.tolist()
            err = hold_precond(torch, cf, entry, S_, a, b, trio_k, tiers)
            if expect is not None and tiers != expect:
                fail(f"{entry}: tiers {tiers}")
            # the wrapper took the shared-memory kernel (n <= its cap):
            # its U and V are the global-memory kernel's bit for bit; its
            # E differs where D's float64 sum does
            old, _, out_o, _ = precond_calls(torch, lib, S_, a, b)
            old()
            torch.cuda.synchronize()
            eq = {x: bool(torch.equal(k, o))
                  for x, k, o in zip("UVE", trio_k, out_o)}
            trio_f = cf._fused_torch(S_.double(), a, b)
            dist = {label: float((t[2].double() - trio_f[2]).abs().max())
                    for label, t in (("new", trio_k), ("old", out_o),
                                     ("plain", cf._fused_torch(S_, a, b)))}
            print(f"{entry}: shared-memory kernel against "
                  f"chol_precond_kernel bit for bit: U {eq['U']}, V "
                  f"{eq['V']}, tiers {torch.equal(tk, out_o[3])}, E "
                  f"{eq['E']} (max|dE| "
                  f"{float((trio_k[2] - out_o[2]).abs().max()):.3e}); E's "
                  "distance from float64: "
                  + "  ".join(f"{k} {v:.3e}" for k, v in dist.items()))
            if not (eq["U"] and eq["V"] and torch.equal(tk, out_o[3])):
                fail(f"{entry}: the shared-memory kernel's U, V or tiers "
                     "differ from chol_precond_kernel's")
            # E is not bit-equal, so it is held to float64 products of the
            # kernel's own U and V, closer than D summed in float32 allows
            # (chol_precond_kernel's E, printed as the control)
            share = {label: e_own_share(S_, *t[:3])
                     for label, t in (("new", trio_k), ("old", out_o))}
            print(f"{entry}: E against float64 products of its own U and "
                  f"V, share of the limit ({E_OWN_RTOL} of the walker's "
                  f"max|E| + {E_OWN_ATOL}) in the worst walker: shared-"
                  f"memory kernel {share['new']:.3e}, chol_precond_kernel "
                  f"(control, D in float32) {share['old']:.3e}")
            if not share["new"] <= 1.0:
                fail(f"{entry}: the shared-memory kernel's E is "
                     f"{share['new']:.3e} of its limit from float64 "
                     "products of its own U and V")
            if run is None:
                continue
            precond_row(entry, run, S_, a, b, tiers, err)
            results[entry].update(precond_designs(
                torch, cf, lib, entry, S_, a, b, results[entry]["ms"], smi))
        # above the shared-memory cap the wrapper takes the global-memory
        # kernel
        Sl = spd_batch(torch, dev, 8, 250, seed=9)
        d0 = routes.DESIGNS[("chol_precond", "global")]
        *trio_k, tk = cf._chol_precond_cuda(Sl, cj1, cj2)
        if routes.DESIGNS[("chol_precond", "global")] != d0 + 1:
            fail("an order over the shared-memory cap did not take "
                 "chol_precond_kernel")
        hold_precond(torch, cf, "chol_precond, large order", Sl, cj1, cj2,
                     trio_k, tk.tolist())
        # the two designs at the shared-memory cap, the order the cap was
        # chosen at
        Sm = spd_batch(torch, dev, 64, smem_maxn, seed=11)
        old, new, out_o, out_n = precond_calls(torch, lib, Sm, cj1, cj2)
        old()
        new()
        torch.cuda.synchronize()
        eq = all(torch.equal(out_n[i], out_o[i]) for i in (0, 1, 3))
        turns = [("old", old), ("new", new), ("new", new), ("old", old)]
        ab = [(name, time_cuda(fn)) for name, fn in turns]
        print(f"chol_precond at the shared-memory cap, Sn "
              f"{tuple(Sm.shape)}: global-memory design (old) against the "
              "shared-memory kernel (new), bare C calls in turns: "
              + "  ".join(f"{k} {v:.4f}" for k, v in ab)
              + f" ms; U, V and tiers bit-equal: {eq} [{smi}]")
        share = e_own_share(Sm, *out_n[:3])
        print(f"chol_precond at the shared-memory cap: E against float64 "
              f"products of its own U and V, share of the limit in the "
              f"worst walker {share:.3e}")
        if not eq:
            fail("at the shared-memory cap the two designs' U, V or tiers "
                 "differ")
        if not share <= 1.0:
            fail(f"at the shared-memory cap the shared-memory kernel's E "
                 f"is {share:.3e} of its limit from float64 products of "
                 "its own U and V")
        # what a call costs besides the chain: a bare call at n = 1 in
        # each design, and the wrapper's host steps before its launch
        # (host clock, mean of 200 calls, few enough that the launch queue
        # does not fill and hold the host back)
        S1 = spd_batch(torch, dev, 16, 1, seed=1)
        old1, new1, _, _ = precond_calls(torch, lib, S1, cj1, cj2)

        def host_us(fn, reps=200):
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            us = 1e6 * (time.perf_counter() - t0) / reps
            torch.cuda.synchronize()
            return us

        B0, n0 = Sc.shape[0], Sc.shape[-1]

        def enter_device():
            with torch.cuda.device(dev):
                pass
        host = {
            "outputs' allocation": host_us(lambda: torch.empty(
                3 * B0 * n0 * n0 + B0, dtype=torch.float32, device=dev)),
            "current_stream(dev)": host_us(
                lambda: torch.cuda.current_stream(dev).cuda_stream),
            "device context": host_us(enter_device),
            "whole wrapper, enqueue only": host_us(
                lambda: cf._chol_precond_cuda(Sc, cj1, cj2)),
        }
        print(f"chol_precond, what a call costs besides the chain: a bare C "
              f"call at Sn {tuple(S1.shape)} {time_cuda(old1):.4f} ms "
              f"(global-memory design) / {time_cuda(new1):.4f} ms "
              "(shared-memory design); the wrapper's host steps at Sn "
              f"{tuple(Sc.shape)} (host clock, mean of 200): "
              + "  ".join(f"{k} {v:.1f} us" for k, v in host.items())
              + f" [{smi}]")

        # ---- phase 5: the main paths through the CLI ----------------------
        lap("4")
        from enterprise_warp_tpu_torch import cli
        stats = []
        # launches per main-path run; the HMC run (while ``hmc`` is set)
        # is split where the ADVI warm start logs its end
        launches = {}

        class BlockStats(logging.Handler):
            hmc = False

            def emit(self, record):
                for key in ("block_stats", "hmc_stats", "advi_stats"):
                    st = getattr(record, key, None)
                    if st is not None:
                        stats.append(dict(st, kind=key))
                if self.hmc and \
                        getattr(record, "advi_stats", None) is not None:
                    launches["advi"] = dict(routes.LAUNCHES)
                    schur.run = "hmc"

        loggers = [logging.getLogger(n) for n in
                   ("ewt.ptmcmc", "ewt.hmc", "ewt.vi")]
        handler = BlockStats()
        for lg in loggers:
            lg.setLevel(logging.INFO)
            lg.addHandler(handler)

        def drive(prfile, num, expect):
            del stats[:]
            routes.reset_counts()
            t0 = time.perf_counter()
            rc = cli.main(["--prfile", prfile, "--num", str(num)],
                          device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(routes.LAUNCHES)
            paths = {f"{k}/{p}": v for (k, p), v in routes.ROUTES.items()}
            designs = {f"{k}/{d}": v for (k, d), v in routes.DESIGNS.items()}
            name = os.path.basename(prfile)
            print(f"main path {name} --num {num}: rc {rc} wall {wall:.1f} s "
                  f"launches {counts} routes {paths} designs {designs}")
            if rc != 0:
                fail(f"cli.main exited {rc} for {name} --num {num}")
            for kname in expect:
                if counts[kname] <= 0:
                    fail(f"{name} --num {num}: {kname} was never launched")
            # the run's directory: ``<num>_<pulsar>`` for one pulsar, the
            # output directory itself for an array
            outdir = [r for r, _, fs in
                      os.walk(os.path.join(tmp, "out", name))
                      if "chain_1.txt" in fs]
            chain = np.loadtxt(os.path.join(outdir[0], "chain_1.txt"))
            if not np.isfinite(chain).all():
                fail(f"{name} --num {num}: non-finite chain rows")
            stream_check(outdir[0], f"{name} --num {num}")
            return chain, counts, outdir[0]

        def pt_report(label, chain):
            """The PT run's acceptance, which must lie in (0, 1), and its
            rates from the sampler's block timings."""
            acc = chain[-1, -2]
            if not 0.0 < acc < 1.0:
                fail(f"{label}: acceptance {acc}")
            blocks = [st for st in stats if st["kind"] == "block_stats"]
            steps = sum(st["steps"] for st in blocks)
            block_s = sum(st["block_s"] for st in blocks)
            W = blocks[-1]["walkers"]
            print(f"main path {label}: {chain.shape[0]} chain rows, "
                  f"largest lnL {chain[:, -3].max():.6g}, "
                  f"acceptance {acc:.3f}, {steps} steps x {W} walkers in "
                  f"{block_s:.2f} s: {W * steps / block_s:.1f} walker-evals/s"
                  f", {1e3 * block_s / steps:.3f} ms/step [{smi}]")

        # the likelihood kernel's Schur test on every walker of the runs
        # that take its route (pt1, advi, hmc, hyper, nested), and on the
        # chains' accepted walkers
        schur = SchurRecord(mk).__enter__()

        def schur_accepted(run, like, theta):
            """Re-evaluate a run's accepted walkers ``theta`` on the card
            under the Schur recorder; none may be rejected."""
            schur.run = f"{run}/accepted"
            for i in range(0, len(theta), RESCORE_BATCH):
                like.loglike_batch(theta[i:i + RESCORE_BATCH])
            schur.run = None
            if schur.report(f"{run}/accepted"):
                fail(f"{run}: an accepted walker trips the Schur test")

        chains = {}
        for num, kname in ((0, "mega_solve"), (1, "mega_like")):
            schur.run = f"pt{num}"
            chains[num], launches[f"pt{num}"], _ = drive(prfile, num, [kname])
            schur.run = None
            pt_report(f"--num {num}", chains[num])
        schur_accepted("pt1", likes[1], chains[1][:, :likes[1].ndim])

        # the noise reconstruction (the tempo2 general2 bridge) on the card,
        # with the model and chain of system_noise.dat --num 0
        recon_check(prfile, chains[0], likes[0].param_names, smi)

        # the PT sampler's warm starts and hot-chain files on --num 1 (the
        # likelihood kernel): an annealed start; then two rungs with
        # hot-chain files after an ADVI start (whose gradients also run
        # the preconditioner kernel). Each run's last likelihood-kernel
        # inputs per walker batch, and the ADVI fit's last preconditioner
        # input, are held against the plain versions: each run's row at
        # the walker batch it gave most calls
        # The same for the ensemble families (ind, cg, kde, ns) set in the
        # paramfile
        for run, extra in (("anneal", {"anneal_init": True}),
                           ("hot", {"ntemps": 2, "writeHotChains": True,
                                    "advi_init": True,
                                    "advi_steps": HOT_ADVI_STEPS}),
                           ("families", FAMILY_KEYS)):
            wpf = write_paramfile(tmp, "system_noise.dat",
                                  dest=f"system_noise_{run}.dat",
                                  extra=extra, nsamp=SHORT_NSAMP,
                                  cov_update=SHORT_COV_UPDATE)
            with RecordBatches(mk, "mega_like", 1) as rec, \
                    Capture(cf, "chol_precond") as cap_w, \
                    KeepSamplers() as kept:
                chain, launches[run], wdir = drive(wpf, 1, ["mega_like"])
            pt_report(f"--num 1 with {extra}", chain)
            if run == "families":
                family_report(f"--num 1 with {extra}", kept.samplers[-1],
                              ("scam", "am", "de", "pd", "ind", "cg",
                               "kde", "ns"))
            if len(rec.sizes) != 1:
                fail(f"--num 1 with {extra}: the likelihood kernel ran at "
                     f"orders {sorted(rec.sizes)}")
            (n, sizes), = rec.sizes.items()
            top = max(sizes, key=sizes.get)
            print(f"--num 1 with {extra}: mega_like calls per walker batch "
                  f"at order {n}: {dict(sizes)}")
            if sum(sizes.values()) != launches[run]["mega_like"]:
                fail(f"--num 1 with {extra}: {sum(sizes.values())} wrapper "
                     f"calls, {launches[run]['mega_like']} launches")
            for W, args in sorted(rec.last.items()):
                args = tuple(x.detach() if torch.is_tensor(x) else x
                             for x in args)
                kern, plain, shape, exact = like_calls(args)
                if W != top:
                    hold_last_step(f"mega_like@{run} W={W}, the run's last "
                                   "call", kern, plain, shape, exact)
                    continue
                hold_solve(f"mega_like@{run}", run, kern, plain,
                           lambda tiers, a=args: like_cost(a[0], a[4], a[7],
                                                           tiers),
                           shape, exact=exact, what="the run's last step")
                results[f"mega_like@{run}"]["batch_sizes"] = dict(sizes)
            if launches[run]["chol_precond"]:
                S_, a, b = cap_w.args
                S_ = S_.detach()
                *trio_k, tk = cf._chol_precond_cuda(S_, a, b)
                err = hold_precond(torch, cf, f"chol_precond@{run}, the "
                                   "ADVI fit's last step", S_, a, b, trio_k,
                                   tk.tolist())
                precond_row(f"chol_precond@{run}", run, S_, a, b,
                            tk.tolist(), err)
            W = 8 * int(extra.get("ntemps", 1))
            advi = [st for st in stats if st["kind"] == "advi_stats"]
            want = SHORT_NSAMP + 1 + (600 if run == "anneal" else
                                advi[0]["steps"] if advi else 0)
            print(f"--num 1 with {extra}: likelihood-kernel launches "
                  f"{launches[run]['mega_like']} (the sampler's {SHORT_NSAMP} "
                  f"steps, its first evaluation and the warm start's: "
                  f"{want}), preconditioner launches "
                  f"{launches[run]['chol_precond']}; walkers {W}")
            if launches[run]["mega_like"] < want or \
                    (run == "hot" and not advi):
                fail(f"--num 1 with {extra}: the warm start did not run "
                     "through the likelihood kernel")
            if run == "hot":
                hot = [f for f in os.listdir(wdir) if f.startswith("chain_")
                       and f != "chain_1.txt"]
                if len(hot) != 1:
                    fail(f"--num 1 with {extra}: hot-chain files {hot}")
                T = float(hot[0][len("chain_"):-len(".txt")])
                rows = np.loadtxt(os.path.join(wdir, hot[0]))
                nd = likes[1].ndim
                th = torch.as_tensor(rows[-8:, :nd], device=dev)
                lp = likes[1].log_prior(th).cpu().numpy()
                gap = np.abs(rows[-8:, nd] - (lp + rows[-8:, nd + 1] / T))
                print(f"--num 1 hot-chain file {hot[0]}: {rows.shape} (cold "
                      f"{chain.shape}), T {T}, rung acceptance "
                      f"{rows[-1, nd + 2]:.3f}, swap rate {rows[-1, nd + 3]:.3f}"
                      f"; |lnpost - (lnprior + lnlike / T)| {gap.max():.2e}")
                if rows.shape != chain.shape or not T > 1 or \
                        not np.isfinite(rows).all() or \
                        not 0 < rows[-1, nd + 2] < 1 or \
                        not 0 <= rows[-1, nd + 3] <= 1 or \
                        not gap.max() <= 1e-9 * np.abs(rows[:, nd]).max():
                    fail(f"--num 1 with {extra}: the hot-chain file is not "
                         "the reference's")

        schur.run, handler.hmc = "advi", True
        chain, counts, _ = drive(hmc_prfile, 0, ["mega_like", "chol_precond"])
        schur.run, handler.hmc = None, False
        schur_accepted("hmc", hlike, chain[:, :hlike.ndim])
        if "advi" not in launches:
            fail("the HMC run logged no ADVI fit")
        launches["hmc"] = {k: counts[k] - launches["advi"][k]
                           for k in routes.KERNELS}
        if routes.DESIGNS[("chol_precond", "smem")] != counts["chol_precond"]:
            fail("the HMC run launched chol_precond_kernel, not the "
                 "shared-memory kernel")
        for run in ("advi", "hmc"):
            print(f"main path HMC, {run} phase: launches {launches[run]}")
            for kname in ("mega_like", "chol_precond"):
                if launches[run][kname] <= 0:
                    fail(f"the {run} phase never launched {kname}")
        nsamp, nch = HMC_KEYS["nsamp"], HMC_KEYS["nchains"]
        if chain.shape != (nsamp * nch, hlike.ndim + 4):
            fail(f"HMC chain shape {chain.shape}")
        advi = [st for st in stats if st["kind"] == "advi_stats"]
        blocks = [st for st in stats if st["kind"] == "hmc_stats"]
        post = [st for st in blocks if not st["warmup"]]
        if len(advi) != 1 or not post:
            fail("the HMC run logged no ADVI fit or no post-warmup block")
        acc = (sum(st["accept"] * st["steps"] for st in post)
               / sum(st["steps"] for st in post))
        if not 0.3 < acc <= 1.0:
            fail(f"HMC acceptance after warmup {acc}")
        steps = sum(st["steps"] for st in blocks)
        grads = sum(st["grads"] for st in blocks)
        block_s = sum(st["block_s"] for st in blocks)
        print(f"main path HMC: ADVI {advi[0]['steps']} steps x "
              f"{advi[0]['mc']} draws in {advi[0]['wall_s']:.2f} s; HMC "
              f"{steps} steps x {nch} chains, {grads} gradient evaluations "
              f"in {block_s:.2f} s: {grads / block_s:.2f} gradient-evals/s, "
              f"{1e3 * block_s / grads:.3f} ms/gradient eval (W={nch}), "
              f"{1e3 * block_s / steps:.3f} ms/HMC step; acceptance after "
              f"warmup {acc:.3f} [{smi}]")

        # ---- phase 6: model selection, the sampled timing model, folded
        # Grams, and the port's results CLI ------------------------------
        lap("5")
        from enterprise_warp_tpu_torch.samplers import HyperModelLikelihood

        run_dirs = []
        # (run, paramfile, the kernel it must launch, that kernel's wrapper
        # in ops/megakernel.py, the wrapper input that carries the batch)
        for run, name, kname, wrapper, batch_arg in (
                ("tm", "sampled_timing_model.dat", "mega_solve",
                 "mega_solve_logdet", 0),
                ("hyper", "default_hypermodel.dat", "mega_like", "mega_like",
                 1),
                ("fixed", "fixed_white_noise.dat", "mega_solve",
                 "mega_solve_logdet", 0)):
            pf = write_paramfile(tmp, name, nsamp=SHORT_NSAMP,
                                 cov_update=SHORT_COV_UPDATE)
            schur.run = run if kname == "mega_like" else None
            with Record(mk, wrapper, batch_arg) as rec:
                chain, launches[run], run_dir = drive(pf, 0, [kname])
            schur.run = None
            pt_report(f"{name} --num 0", chain)
            run_dirs.append(os.path.dirname(run_dir))
            # every evaluation of these paths is one launch of ``kname``
            for other in routes.KERNELS:
                if other != kname and launches[run][other]:
                    fail(f"{name}: {other} was launched")
            sizes = {n: dict(sorted(c.items()))
                     for n, c in sorted(rec.sizes.items())}
            calls = sum(sum(c.values()) for c in sizes.values())
            print(f"{name}: {wrapper} calls per order n and walker batch "
                  f"size: {sizes}")
            if calls != launches[run][kname]:
                fail(f"{name}: {calls} wrapper calls, "
                     f"{launches[run][kname]} launches")
            if run == "hyper":
                pars = open(os.path.join(run_dir, "pars.txt")).read().split()
                k = np.clip(np.round(chain[:, pars.index("nmodel")]), 0, 1)
                print(f"{name}: share of samples per nmodel bin "
                      f"{ {m: float(np.mean(k == m)) for m in (0, 1)} }")
                if sorted(sizes) != [1, 60]:
                    fail(f"{name}: the likelihood kernel ran at orders "
                         f"{sorted(sizes)}, not at both members' [1, 60]")
            # the chain's largest lnL against the float64 oracle on the
            # CPU at the same point, in the reference's megakernel class
            # (rtol 1e-3, atol 5e-2); on the hypermodel path too, since
            # the likelihood kernel's route rejects the prior corners
            # where it used to return a finite lnL far above float64
            oracles = load_likes(pf, 0, "cpu", gram_mode="f64")[1]
            oracle = HyperModelLikelihood(oracles) if run == "hyper" \
                else oracles[0]
            top = int(np.argmax(chain[:, -3]))
            ref = float(oracle.loglike_batch(
                chain[top:top + 1, :oracle.ndim])[0])
            print(f"{name}: largest lnL in the chain {chain[top, -3]:.6g} "
                  f"(row {top}); float64 oracle on the CPU there {ref:.6g}")
            if not abs(chain[top, -3] - ref) <= LNL_ATOL + LNL_RTOL * abs(ref):
                fail(f"{name}: the chain's largest lnL disagrees with the "
                     "float64 oracle")
            if run == "hyper":
                hyper_pf = pf
                schur_accepted("hyper", HyperModelLikelihood(
                    load_likes(pf, 0, dev)[1]), chain[:, :oracle.ndim])
            calls_of = like_calls if kname == "mega_like" else solve_calls
            # the inputs of the run's last step, wherever the chain stood
            for n, args in sorted(rec.last.items()):
                kern, plain, shape, exact = calls_of(args)
                hold_last_step(f"{kname}@{run} n={n}, the run's last step",
                               kern, plain, shape, exact)
            if run == "hyper":
                # member 0's one basis column is null (X = 0, so Z = 0 on
                # the path whatever the kernel does): hold nb = 1 on a
                # seeded non-null column at the path's ntoa, at each walker
                # batch the run gave member 0
                a1 = rec.last[1]
                for B in sorted(sizes[1]):
                    S1, w1, s1, ivb1, Bn1 = like_inputs(
                        torch, dev, a1[0].shape[0], 1, B, a1[4].shape[2],
                        40 + B)
                    args = (S1, w1, s1, ivb1, Bn1, *a1[5:])
                    if float(mk._mega_like_torch(*args)[0].abs().max()) \
                            < 1e-2:
                        fail("the nb = 1 fixture's Z is near 0")
                    kern, plain, shape, _ = like_calls(args)
                    compare("mega_like nb = 1, seeded basis column", kern,
                            plain, shape)
            # the entries of the kernels line: inputs captured from the
            # path's likelihood at points near typical noise values (the
            # last step's inputs may hold walkers beyond float32, where
            # the two versions differ by rounding alone), at the walker
            # batch the run gave each order most often
            likes = load_likes(pf, 0, dev)[1]
            like = HyperModelLikelihood(likes) if run == "hyper" \
                else likes[0]
            for m, n in enumerate(sorted(sizes)):
                W = max(sizes[n], key=sizes[n].get)
                th = near_middle(like, walkers, 8 + m)
                if run == "hyper":
                    # W walkers select member m, the others member 1 - m
                    th[:, -1] = np.where(np.arange(walkers) < W, m, 1 - m)
                with Record(mk, wrapper, batch_arg) as cap:
                    lnl = like.loglike_batch(th)
                if not torch.isfinite(lnl).all():
                    fail(f"{name}: non-finite lnL near typical values")
                args = cap.last[n]
                if args[batch_arg].shape[0] != W:
                    fail(f"{name}: order {n} ran at a batch of "
                         f"{args[batch_arg].shape[0]}, not {W}")
                entry = f"{kname}@{run}{m if run == 'hyper' else ''}"
                kern, plain, shape, _ = calls_of(args)
                cost = (lambda tiers, a=args: like_cost(a[0], a[4], a[7],
                                                        tiers)) \
                    if kname == "mega_like" else \
                    (lambda tiers, a=args: solve_cost(*a[1].shape, a[4],
                                                      tiers))
                hold_solve(entry, run, kern, plain, cost, shape)
                results[entry].update(launches=sum(sizes[n].values()),
                                      batch_sizes=sizes[n])
        for lg in loggers:
            lg.removeHandler(handler)
        for d in run_dirs:
            proc = subprocess.run(
                [sys.executable, "-m", f"{PKG}.results", "--result", d,
                 "--info", "1", "--noisefiles", "1", "--credlevels", "1",
                 "--logbf", "1", "--covm", "1"],
                cwd=HERE, capture_output=True, text=True, timeout=600)
            said = [ln.split(" INFO ", 1)[-1] for ln in
                    proc.stderr.splitlines() if "logBF" in ln
                    or "only model" in ln or "no nmodel" in ln]
            print(f"results CLI on {os.path.basename(d)}: rc "
                  f"{proc.returncode}; {'; '.join(said)}")
            if proc.returncode != 0:
                fail(f"the results CLI exited {proc.returncode} on {d}: "
                     + proc.stderr[-2000:])
            if not os.path.exists(os.path.join(d, "noisefiles",
                                               "J1234-5678_noise.json")):
                fail(f"the results CLI wrote no noise file for {d}")

        # ---- phase 7: nested sampling ------------------------------------
        lap("6")
        from enterprise_warp_tpu_torch.samplers import nested as tnested
        nname = "default_model_nested.dat"
        npf = write_paramfile(tmp, nname)
        nested_log = {}

        class NestedLog(logging.Handler):
            def emit(self, record):
                for key in ("nested_stats", "nested_summary"):
                    st = getattr(record, key, None)
                    if st is not None:
                        nested_log.setdefault(key, []).append(st)

        nlogger = logging.getLogger("ewt.nested")
        nlogger.setLevel(logging.INFO)
        nhandler = NestedLog()
        nlogger.addHandler(nhandler)
        schur.run = "nested"
        with RecordBatches(mk, "mega_like", 1) as recn:
            routes.reset_counts()
            t0 = time.perf_counter()
            rc = cli.main(["--prfile", npf, "--num", "0"], device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches["nested"] = dict(routes.LAUNCHES)
        schur.run = None
        nlogger.removeHandler(nhandler)
        if rc != 0:
            fail(f"cli.main exited {rc} for {nname} --num 0")
        summ = nested_log["nested_summary"][-1]
        blocks = nested_log["nested_stats"]
        it, nsteps = summ["iterations"], summ["nsteps"]
        nnd = [os.path.join(r, d) for r, ds, _ in
               os.walk(os.path.join(tmp, "out", nname)) for d in ds
               if d.startswith("0_")][0]
        label = [f[:-len("_result.json")] for f in os.listdir(nnd)
                 if f.endswith("_result.json")][0]
        # a heartbeat per block and the closing one
        stream_check(nnd, f"{nname} --num 0",
                     blocks=len(nested_log["nested_stats"]) + 1)
        with open(os.path.join(nnd, f"{label}_result.json")) as fh:
            nres = json.load(fh)
        sizes = dict(recn.sizes[60])
        print(f"main path {nname} --num 0: rc {rc} wall {wall:.1f} s "
              f"launches {launches['nested']} calls per walker batch "
              f"{sizes}; {it} iterations of {nsteps} calls at W "
              f"{summ['kbatch']}, fresh live set {summ['fresh_live_calls']} "
              f"call(s) at W {summ['nlive']}")
        want = summ["fresh_live_calls"] + it * nsteps
        if launches["nested"]["mega_like"] != want:
            fail(f"{nname}: {launches['nested']['mega_like']} likelihood "
                 f"kernel launches, not 1 + redraws + it * nsteps = {want}")
        if launches["nested"]["mega_solve"] or \
                launches["nested"]["chol_precond"]:
            fail(f"{nname}: the solve or preconditioner kernel was launched")
        if sizes != {summ["kbatch"]: it * nsteps,
                     summ["nlive"]: summ["fresh_live_calls"]}:
            fail(f"{nname}: likelihood calls per batch {sizes}")
        if not (nres["converged"] and np.isfinite(nres["log_evidence"])):
            fail(f"{nname}: not converged or lnZ not finite")
        block_s = sum(b["block_s"] for b in blocks)
        DISPATCH_KEYS = ("dispatches", "host_syncs", "iterations",
                         "block_iters", "host_syncs_per_iteration")
        print(f"main path {nname}: lnZ {nres['log_evidence']:.6f} +- "
              f"{nres['log_evidence_err']:.6f}; {it} iterations, "
              f"{summ['evals']} walker-evals in {summ['loop_wall_s']:.2f} s "
              f"of sampling ({summ['walker_evals_per_s']:.1f} "
              f"walker-evals/s, {1e3 * block_s / it:.2f} ms/iteration, "
              f"{1e3 * block_s / (it * nsteps):.3f} ms per call at W "
              f"{summ['kbatch']}), CLI wall {wall:.1f} s; dispatch_stats "
              f"{ {k: summ[k] for k in DISPATCH_KEYS} }, commit sync "
              f"{summ['sync_wall_per_block_s'] * 1e3:.3f} ms "
              f"per block [{smi}]")
        ir = nres["insertion_rank"]
        print(f"{nname}: insertion-rank KS {ir}")
        if not ir["pass"]:
            fail(f"{nname}: the insertion-rank KS test fails")
        post = nres["posterior"]
        print(f"{nname}: posterior means beside the injected values: " + ", "
              .join(f"{n.split('J1234-5678_')[-1]} "
                    f"{np.mean(post[n]):.4g} ({TRUTH.get(n, float('nan')):g})"
                    for n in nres["parameter_labels"]))

        # the evidence against float64: every dead point re-scored with
        # the float64 Gram mode on the card, lnZ recomputed on the run's
        # own ln X schedule (log_weights + lnZ - lnL)
        z = np.load(os.path.join(nnd, f"{label}_nested.npz"))
        nlike64 = load_likes(npf, 0, dev, gram_mode="f64")[1][0]
        th = z["samples"]
        l64 = torch.cat([nlike64.loglike_batch(th[i:i + RESCORE_BATCH])
                         for i in range(0, len(th), RESCORE_BATCH)])
        l64 = l64.cpu().numpy()
        x = l64 + z["log_weights"] + nres["log_evidence"] \
            - z["log_likelihoods"]
        lnz64 = float(x.max() + np.log(np.sum(np.exp(x - x.max()))))
        dl = np.abs(z["log_likelihoods"] - l64)
        out_cls = int(np.sum(dl > LNL_ATOL + LNL_RTOL * np.abs(l64)))
        dz = nres["log_evidence"] - lnz64
        print(f"{nname}: lnZ {nres['log_evidence']:.6f}, float64 re-scoring "
              f"of the {len(th)} dead points {lnz64:.6f}: |dlnZ| "
              f"{abs(dz):.3e} (log_evidence_err "
              f"{nres['log_evidence_err']:.4f}); largest |dlnL| "
              f"{dl.max():.4g} (at float64 lnL {l64[np.argmax(dl)]:.6g}), "
              f"{out_cls} points outside the lnL class")
        if not abs(dz) <= nres["log_evidence_err"]:
            fail(f"{nname}: lnZ differs from its float64 re-scoring by more "
                 "than log_evidence_err")

        # the likelihood kernel at the two shapes of the path, held walker
        # by walker under the condition bound and timed
        nlike = load_likes(npf, 0, dev)[1][0]
        for W, entry in ((summ["kbatch"], "mega_like@nested"),
                         (summ["nlive"], "mega_like@nested_live")):
            args = recn.last[W]
            kern, plain, shape, exact = like_calls(args)
            what = ("the run's last iteration" if entry.endswith("nested")
                    else "the fresh live set's prior draws")
            hold_solve(entry, entry.split("@")[1], kern, plain,
                       lambda tiers, a=args: like_cost(a[0], a[4], a[7],
                                                       tiers),
                       shape, exact=exact, what=what)
            results[entry]["launches"] = sizes[W]

        # syncing calls in one block of 16 iterations (not held): the
        # sampler itself reads nothing back inside a block
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        u0, l0, _ = tnested._fresh_live(nlike, summ["nlive"], gen)
        blk = tnested._make_block(nlike, summ["nlive"], summ["kbatch"],
                                  nsteps)
        st0 = [torch.tensor(v, dtype=torch.float64, device=dev)
               for v in (0.5, -np.inf, 0.0)]
        blk(u0, l0, gen, *st0, 1)
        torch.cuda.synchronize()
        import warnings
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            blk(u0, l0, gen, *st0, tnested.DEFAULT_BLOCK_ITERS)
            torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode(0)
        kinds = collections.Counter(
            str(c.message).splitlines()[0][:80] for c in caught)
        print(f"{nname}: {len(caught)} implicitly synchronising calls in "
              f"one block of {tnested.DEFAULT_BLOCK_ITERS} iterations "
              f"({tnested.DEFAULT_BLOCK_ITERS * nsteps} likelihood calls), "
              f"under torch.cuda.set_sync_debug_mode('warn'): "
              f"{dict(kinds)}")

        # the Schur test: its threshold against prior draws re-scored in
        # float64, the corner, and every run's walkers
        rng = np.random.default_rng(17)
        thp = nlike.from_unit(torch.as_tensor(
            rng.uniform(size=(PRIOR_DRAWS, nlike.ndim)), device=dev))
        schur.run = "prior draws"
        lk = torch.cat([nlike.loglike_batch(thp[i:i + RESCORE_BATCH])
                        for i in range(0, PRIOR_DRAWS, RESCORE_BATCH)])
        schur.run = None
        l64 = torch.cat([nlike64.loglike_batch(thp[i:i + RESCORE_BATCH])
                         for i in range(0, PRIOR_DRAWS, RESCORE_BATCH)])
        lk, l64 = lk.cpu().numpy(), l64.cpu().numpy()
        t = schur.table("prior draws")
        rej = t[:, 2] > 0
        in_cls = np.abs(lk - l64) <= LNL_ATOL + LNL_RTOL * np.abs(l64)
        neg = t[:, 0] < 0
        print(f"Schur test on {PRIOR_DRAWS} prior draws of {nname}: "
              f"{int(rej.sum())} rejected, of which "
              f"{int((rej & in_cls).sum())} within the lnL class of "
              f"float64 had they passed; passing walkers outside it "
              f"{int((~rej & ~in_cls).sum())} (largest lnL - float64 "
              f"{np.max((lk - l64)[~rej & ~in_cls], initial=0.0):.4g}, "
              f"their largest lnL "
              f"{np.max(lk[~rej & ~in_cls], initial=-np.inf):.6g}, the "
              f"draws' largest float64 lnL {l64.max():.6g}); "
              f"min(evA)/max|evA| of walkers within the class: smallest "
              f"{t[in_cls, 0].min():.3e}; of walkers with a negative "
              f"eigenvalue: largest {t[neg, 0].max(initial=-np.inf):.3e}, "
              f"{int((neg & in_cls).sum())} within the class "
              f"(SCHUR_REJECT_C {mk.SCHUR_REJECT_C:g})")
        schur.run = "corner"
        hmember = load_likes(hyper_pf, 0, dev)[1][1]
        lc = float(hmember.loglike_batch(np.asarray([CORNER]))[0])
        schur.run = None
        tc = schur.table("corner")
        print(f"Schur test at CORNER (default_hypermodel.dat member 1): "
              f"min(evA)/max|evA| {tc[0, 0]:.3e}, quad {tc[0, 1]:.4g}, "
              f"lnL {lc}")
        if not (tc[0, 2] > 0 and lc == -np.inf):
            fail("the likelihood kernel's route did not reject CORNER")
        for run in ("pt1", "advi", "hmc", "hyper", "nested"):
            schur.report(run)
        schur_accepted("nested", nlike, th)
        schur.__exit__()

        proc = subprocess.run(
            [sys.executable, "-m", f"{PKG}.results", "--result",
             os.path.dirname(nnd), "--bilby", "1", "--info", "1",
             "--noisefiles", "1", "--logbf", "1"],
            cwd=HERE, capture_output=True, text=True, timeout=600)
        said = [ln.split(" INFO ", 1)[-1] for ln in proc.stderr.splitlines()
                if "log_evidence" in ln]
        print(f"results CLI --bilby 1 on {nname}: rc {proc.returncode}; "
              f"{'; '.join(said)}")
        if proc.returncode != 0:
            fail(f"the results CLI exited {proc.returncode} on {nnd}: "
                 + proc.stderr[-2000:])
        if not os.path.exists(os.path.join(os.path.dirname(nnd),
                                           "noisefiles",
                                           "J1234-5678_noise.json")):
            fail(f"the results CLI wrote no noise file for {nnd}")

        # ---- phase 8: the joint correlated-GWB likelihood ----------------
        lap("7")
        from enterprise_warp_tpu_torch.parallel import build_pta_likelihood

        # (a) right-hand sides wider than the refine phase's 8-column panel
        per_k = {}
        for k in WIDE_K:
            Sw = spd_batch(torch, dev, 8, 100, 60 + k)
            Bw = torch.randn(8, 100, k, dtype=torch.float32, device=dev,
                             generator=torch.Generator(dev).manual_seed(k))
            a = (Sw, Bw, 3e-6, 9e-5, 3)
            entry = "mega_solve@wide_k"
            hold_solve(entry, "wide_k", lambda a=a: mk._mega_solve_cuda(*a),
                       lambda a=a: mk._mega_solve_torch(*a),
                       lambda tiers, a=a: solve_cost(*a[1].shape, 3, tiers),
                       f"Sn {tuple(Sw.shape)} Bn {tuple(Bw.shape)}")
            per_k[k] = {key: results[entry][key] for key in
                        ("max_abs_err", "ms", "plain_ms", "bound_ms")}
        results[entry]["per_k"] = per_k
        results[entry]["launches"] = 0
        results[entry]["max_abs_err"] = max(r["max_abs_err"]
                                            for r in per_k.values())
        Sg, Bg = guard_fixture(torch, dev)
        Zk, ldk, tk = mk._mega_solve_cuda(Sg, Bg, 1e-6, 1e-3, 3)
        Zp, ldp = mk._mega_solve_torch(Sg, Bg, 1e-6, 1e-3, 3)
        torch.cuda.synchronize()
        gerr = max(float((Zk - Zp).abs().max()),
                   float((ldk - ldp).abs().max()))
        kept = [not torch.equal(Zk[b], Bg[b]) for b in range(2)]
        print(f"divergence guard fixture (refinement diverging in one panel "
              f"of two): tiers {tk.tolist()}, refined Z kept per walker "
              f"{kept} (expected [True, False]), max|kernel - plain| "
              f"{gerr:.3e}")
        if tk.tolist() != [3, 3] or kept != [True, False] or not gerr <= 1e-4:
            fail("the divergence guard is not per walker over all columns")
        largs = wide_like_args(torch, cap_h.args)
        hold_solve("mega_like@wide_k", "wide_k",
                   lambda: mk._mega_like_cuda(*largs),
                   lambda: mk._mega_like_torch(*largs),
                   lambda tiers: like_cost(largs[0], largs[4], largs[7],
                                           tiers),
                   f"S {tuple(largs[0].shape)} w {tuple(largs[1].shape)} Bn "
                   f"{tuple(largs[4].shape)} (seeded 32-column M)")
        results["mega_like@wide_k"]["launches"] = 0

        for lg in loggers:
            lg.addHandler(handler)
        # (b) gwb_array.dat through the CLI
        gname = "gwb_array.dat"
        gfam = {k: v for k, v in FAMILY_KEYS.items() if k != "IndWeight"}
        gpf = write_paramfile(tmp, gname, nsamp=SHORT_NSAMP, extra=gfam,
                              cov_update=SHORT_COV_UPDATE)
        cli_warnings = []

        class Warnings(logging.Handler):
            def emit(self, record):
                cli_warnings.append(record.getMessage())
        wlog = logging.getLogger(f"{PKG}.cli")
        whandler = Warnings(logging.WARNING)
        wlog.addHandler(whandler)
        with RecordShapes(mk, "mega_solve_logdet", 0) as rec, \
                KeepSamplers() as gkept:
            chain, launches["gwb"], gdir = drive(gpf, 0, ["mega_solve"])
        wlog.removeHandler(whandler)
        pt_report(gname, chain)
        sizes = {n: dict(sorted(c.items())) for n, c in
                 sorted(rec.sizes.items())}
        calls = {n: sum(c.values()) for n, c in sizes.items()}
        print(f"{gname}: solve-kernel calls per order n and walker batch "
              f"{sizes}")
        if sorted(calls) != [20, 40] or calls[20] != calls[40] or \
                launches["gwb"]["mega_solve"] != 2 * calls[20]:
            fail(f"{gname}: not two solve-kernel launches (stages 1 and 3) "
                 "per likelihood call")
        if launches["gwb"]["mega_like"] or launches["gwb"]["chol_precond"]:
            fail(f"{gname}: a kernel other than the solve kernel launched")
        glike = load_likes(gpf, 0, dev)[1][0]
        gparams, goracles = load_likes(gpf, 0, "cpu", gram_mode="f64")
        goracle = goracles[0]
        th = near_typical(glike, walkers, 12)
        lk = glike.loglike_batch(th).cpu().numpy()
        l64 = goracle.loglike_batch(th).numpy()
        print(f"{gname} at {walkers} near-typical points: the card's Schur "
              f"path against the dense float64 oracle on the CPU, max|dlnL| "
              f"{np.abs(lk - l64).max():.4e}")
        if not np.all(np.abs(lk - l64)
                      <= JOINT_ATOL + JOINT_RTOL * np.abs(l64)):
            fail(f"{gname}: lnL on the card disagrees with the float64 dense "
                 "oracle at near-typical points")
        top = int(np.argmax(chain[:, -3]))
        row = chain[top:top + 1, :goracle.ndim]
        ref = float(goracle.loglike_batch(row)[0])
        print(f"{gname}: largest lnL in the chain {chain[top, -3]:.6f} (row "
              f"{top}); float64 dense oracle on the CPU there {ref:.6f}")
        print(f"{gname}: the CLI's warnings {cli_warnings}")
        if not abs(chain[top, -3] - ref) <= JOINT_ATOL + JOINT_RTOL * abs(ref):
            corner_attribution(glike, gparams, row, chain[top, -3] - ref,
                               gname)
            fail(f"{gname}: the chain's largest lnL lies outside the class "
                 "of the float64 oracle (a float32 corner)")
        if any("locked the chain" in m for m in cli_warnings):
            fail(f"{gname}: the CLI's float64 check warned on a chain "
                 "within the class")
        # mask_stats.json: the reference's keys; the cold proposals, all
        # counted; the maskable ones are the cold prior draws and noise
        # slides (each inside one block), and the cg and kde subsets whose
        # dimensions share one block, which must be some of them
        ms = json.load(open(os.path.join(gdir, "mask_stats.json")))
        prop = ms["proposals"]
        gs = gkept.samplers[-1]
        fp = gs.fam_propose
        family_report(gname, gs, ("scam", "am", "de", "pd", "cg", "kde",
                                  "ns"))
        print(f"{gname}: mask_stats.json {ms}; cold proposals {fp[3]:.0f} "
              f"prior draws, {fp[7]:.0f} noise slides, {fp[5]:.0f} cg and "
              f"{fp[6]:.0f} kde subsets of {gs.nchains * SHORT_NSAMP}")
        maskable = prop["site"] + prop["common"]
        if (sorted(ms), sorted(prop)) != MASK_KEYS or \
                prop["site"] + prop["common"] + prop["full"] != ms["total"] \
                or ms["total"] != gs.nchains * SHORT_NSAMP or \
                not fp[3] + fp[7] < maskable <= fp[3] + fp[5] + fp[6] + fp[7]:
            fail(f"{gname}: mask_stats.json is not the reference's record of "
                 "this run's cold proposals")
        # the subset classes on the card against the reference's rule
        # (samplers/ptmcmc.py:_mask_cls_subset) on gwb_array's blocks
        from enterprise_warp_tpu_torch.samplers import ptmcmc as ptm
        pbn = np.asarray(gs.like.param_blocks)
        sub = np.stack([np.random.default_rng(i).permutation(len(pbn))[:3]
                        for i in range(256)] + [
            np.flatnonzero(pbn == b)[:3] for b in np.unique(pbn)
            if (pbn == b).sum() >= 3])
        pbt = torch.as_tensor(pbn, device=dev)
        got = ptm.subset_class(pbt, ptm.block_classes(pbt),
                               torch.as_tensor(sub, device=dev)).cpu()
        want = [2 if len(set(pbn[t])) > 1 else 0 if pbn[t[0]] >= 0 else
                1 if pbn[t[0]] == ptm.BLOCK_COMMON else 2 for t in sub]
        agree = sum(g == w for g, w in zip(got.tolist(), want))
        print(f"{gname}: subset classes on the card for {len(sub)} subsets "
              f"against the reference's rule: {agree} equal; classes "
              f"{dict(collections.Counter(want))}")
        if got.tolist() != want:
            fail(f"{gname}: a subset's update_mask class is not the "
                 "reference's")
        for n, args in sorted(rec.last.items()):
            kern, plain, shape, exact = solve_calls(args)
            hold_last_step(f"mega_solve@gwb n={n}, the run's last step",
                           kern, plain, shape, exact)
            refine_floor(f"mega_solve@gwb n={n}, every call of the run",
                         [c for (m, _), cs in rec.calls.items() if m == n
                          for c in cs])
        del rec
        with Record(mk, "mega_solve_logdet", 0) as cap:
            glike.loglike_batch(th)
        for n, stage in ((20, "stage1"), (40, "stage3")):
            a = cap.last[n]
            kern, plain, shape, _ = solve_calls(a)
            hold_solve(f"mega_solve@gwb_{stage}", "gwb", kern, plain,
                       lambda tiers, a=a: solve_cost(*a[1].shape, a[4],
                                                     tiers), shape)
            results[f"mega_solve@gwb_{stage}"].update(
                launches=calls[n], batch_sizes=sizes[n])
        stage_shares(glike, th, gname, smi)
        # how often the chain's own points take the float64 redo: the
        # flagged pairs over the chain's rows after burn-in
        post = chain[len(chain) // 4:, :glike.ndim]
        st_g = glike._stages
        com = st_g["common"](glike.as_theta(post))
        ratio = st_g["stage12"](com[0], com[1], com[5],
                                corner_c=None)["ev_ratio"]
        from enterprise_warp_tpu_torch.parallel.pta import CORNER_C
        print(f"{gname}: over the chain's {len(post)} rows after burn-in, "
              f"pairs flagged for the float64 redo per pulsar "
              f"{(ratio < CORNER_C).sum(dim=0).tolist()} (min(evA)/max|evA| "
              f"median per pulsar {ratio.median(dim=0).values.tolist()})")
        del com
        redo_share(glike, chain_batches(post, walkers), gname, smi)
        # the float32 corners on the card: prior draws against the dense
        # float64 oracle on the card, and GWB_CORNER repaired
        gdense = load_likes(gpf, 0, dev, gram_mode="f64")[1][0]
        corner_report(glike, gdense, glike.sample_prior(
            np.random.default_rng(0), CORNER_DRAWS["gwb"]),
            f"{gname} on the card", chunk=CORNER_DRAWS["gwb"])
        lc = float(glike.loglike_batch(np.asarray([GWB_CORNER]))[0])
        l64 = float(goracle.loglike_batch(np.asarray([GWB_CORNER]))[0])
        print(f"{gname} at GWB_CORNER: the card {lc:.6f}, float64 {l64:.6f}")
        if not abs(lc - l64) <= JOINT_ATOL + JOINT_RTOL * abs(l64):
            fail(f"{gname}: GWB_CORNER is not repaired on the card")
        # the evaluation cache: seeded updates against full recomputes,
        # and the site updates' one-system stage-1 launches
        with RecordShapes(mk, "mega_solve_logdet", 0) as rec:
            routes.reset_counts()
            gev, _ = cache_sequence(glike, near_typical(glike, 1, 21)[0],
                                    CACHE_UPDATES, 21, f"{gname} cache")
            launches["gwb_site"] = dict(routes.LAUNCHES)
        site_row("mega_solve@gwb_site", "gwb_site", rec, 20, gev)
        cache_times(glike, gev, f"{gname} cache", smi)
        proc = subprocess.run(
            [sys.executable, "-m", f"{PKG}.results", "--result", gpf,
             "--optimal_statistic", "1"], cwd=HERE, capture_output=True,
            text=True, timeout=600)
        pkl = os.path.join(gdir, "optimal_statistic.pkl")
        print(f"results CLI --optimal_statistic 1 on {gname}: rc "
              f"{proc.returncode}")
        if proc.returncode != 0 or not os.path.exists(pkl):
            fail(f"the optimal statistic failed on {gpf}: "
                 + proc.stderr[-2000:])
        import pickle
        payload = pickle.load(open(pkl, "rb"))
        print(f"{gname}: optimal_statistic.pkl ORFs {list(payload)}, hd A^2 "
              f"{payload['hd']['a2']:.4e} +- {payload['hd']['a2_err']:.4e}, "
              f"S/N {payload['hd']['snr']:.4f}")
        if list(payload) != ["hd", "dipole", "monopole"] or any(
                sorted(v) != ["a2", "a2_err", "marginalized", "rho", "sig",
                              "snr", "xi"] for v in payload.values()):
            fail(f"{gname}: optimal_statistic.pkl is not the reference's "
                 "payload")
        proc = subprocess.run(
            [sys.executable, "-m", f"{PKG}.results", "--result", gdir,
             "--info", "1", "--noisefiles", "1", "--credlevels", "1",
             "--covm", "1"], cwd=HERE, capture_output=True, text=True,
            timeout=600)
        print(f"results CLI on {gname}: rc {proc.returncode}")
        if proc.returncode != 0 or not os.path.exists(
                os.path.join(gdir, "noisefiles", "J1234-5678_noise.json")):
            fail(f"the results CLI failed on {gdir}: "
                 + proc.stderr[-2000:])

        # (c) BASELINE config 3: 45 pulsars written to disk by the port,
        # then the paramfile through the CLI, as users run an array
        from enterprise_warp_tpu_torch.models.assemble import \
            build_terms_for_model
        pf45 = config3_on_disk(tmp)
        setups, verdicts = [], []

        class SetupLog(logging.Handler):
            def emit(self, record):
                st = getattr(record, "setup_stats", None)
                if st is not None:
                    setups.append(st)
                if "float64 oracle" in record.getMessage():
                    verdicts.append(record.getMessage())
        clog = logging.getLogger(f"{PKG}.cli")
        clog.setLevel(logging.INFO)
        shandler = SetupLog()
        clog.addHandler(shandler)

        try:
            with Record(mk, "mega_solve_logdet", 0) as rec, \
                    KeepSamplers() as kept45:
                chain, launches["pta45"], out45 = drive(pf45, 0,
                                                        ["mega_solve"])
                paths45 = dict(routes.ROUTES)
        finally:
            clog.removeHandler(shandler)
        for lg in loggers:
            lg.removeHandler(handler)
        like45, params45 = kept45.calls[-1]
        psrs45 = params45.psrs
        tls45 = build_terms_for_model(params45.models[min(params45.models)],
                                      psrs45, params45.noise_model_obj)
        st45 = like45._stages
        setup = setups[-1]
        if setup["tim_engine"] != "native":
            fail("config 3: the CLI parsed the .tim files with the "
                 f"{setup['tim_engine']} engine, not the native core")
        print(f"config 3 set-up through the CLI: {setup['npsr']} pulsars "
              f"parsed in {setup['pulsars_s']:.3f} s by the "
              f"{setup['tim_engine']} TIM engine (PR 12's run, Python "
              "engine: 0.316 s)")
        blocks = [st for st in stats if st["kind"] == "block_stats"]
        step_ms45 = 1e3 * sum(st["block_s"] for st in blocks) \
            / sum(st["steps"] for st in blocks)
        print(f"config 3 from disk through the CLI: {len(psrs45)} pulsars x "
              f"{PTA45['ntoa']} TOAs, {like45.ndim} parameters, NW "
              f"{st45['NW']} MW {st45['MW']} n_g {st45['n_g']} nb_tot "
              f"{st45['nb_tot']}; set-up {sum(setup[k] for k in ('paramfile_s', 'pulsars_s', 'likelihood_s')):.3f} s "
              f"(paramfile {setup['paramfile_s']:.3f} s, {setup['npsr']} "
              f"pulsars parsed {setup['pulsars_s']:.3f} s, likelihood built "
              f"{setup['likelihood_s']:.3f} s), sampling "
              f"{sum(st['block_s'] for st in blocks):.3f} s in blocks; the "
              f"CLI's float64 check of the chain: {verdicts} [{smi}]")
        if (like45.ndim, st45["NW"], st45["MW"], st45["n_g"]) != \
                (272, 100, 3, 40) or len(psrs45) != PTA45["npsr"]:
            fail("config 3 does not have the reference's shapes")
        if len(verdicts) != 1:
            fail("config 3: the CLI's float64 check of the chain gave no "
                 "verdict")
        sizes = {n: dict(c) for n, c in rec.sizes.items()}
        ncall = sum(sizes.get(100, {}).values())
        print(f"config 3 through the CLI: launches "
              f"{launches['pta45']} routes "
              f"{ {f'{k}/{p}': v for (k, p), v in paths45.items()} }; "
              f"solve-kernel calls per order and batch {sizes}")
        pt_report("config 3 (45 pulsars)", chain)
        # every call one stage-1 launch over all (walker, pulsar) pairs
        # (W 8 on the sampler's steps; the initial prior draws may be
        # redrawn at a smaller batch)
        if set(sizes) != {100} or \
                any(b % len(psrs45) for b in sizes[100]) or \
                sizes[100].get(len(psrs45) * walkers, 0) < SHORT_NSAMP or \
                launches["pta45"]["mega_solve"] != ncall or \
                paths45.get(("mega_solve", "over-cap")) != ncall or \
                paths45.get(("chol_precond", "over-cap")) != ncall:
            fail("config 3: not one solve-kernel launch (stage 1) and one "
                 "over-cap stage 3 per likelihood call")
        if launches["pta45"]["mega_like"] or launches["pta45"]["chol_precond"]:
            fail("config 3: the likelihood or preconditioner kernel launched")
        # the row of the kernels line: the run's last-step inputs, held
        # walker by walker under the condition bound. At near-typical
        # points every walker's noise block lies above it (median cond
        # 7.7e4): a fake pulsar at one radio frequency has its DM columns
        # (20 modes) equal to the first 40 of its spin columns (30 modes),
        # and only the priors separate them
        a = rec.last[100]
        kern, plain, shape, exact = solve_calls(a)
        entry = "mega_solve@pta45_stage1"
        hold_solve(entry, "pta45", kern, plain,
                   lambda tiers: solve_cost(*a[1].shape, a[4], tiers), shape,
                   exact=exact, what="the run's last step")
        results[entry].update(launches=ncall, batch_sizes=sizes[100])
        results[entry]["phases_ms"] = solve_pipeline(
            torch, mk, cuda_lib.load_library(), *a, results[entry]["ms"],
            smi, label=entry)
        stage_shares(like45, near_typical(like45, walkers, 13), "config 3",
                     smi)
        redo_share(like45, chain_batches(chain[len(chain) // 4:,
                                               :like45.ndim], walkers),
                   "config 3", smi)
        # two near-typical points against the dense float64 oracle on the
        # card: their lnL difference (tests/test_parallel.py:612)
        th2 = np.stack([config3_theta(like45), config3_theta(like45, 0.3)])
        s12 = like45.loglike_batch(th2).cpu().numpy()
        t0 = time.perf_counter()
        dense45 = build_pta_likelihood(psrs45, tls45, gram_mode="f64",
                                       device=dev)
        d12 = dense45.loglike_batch(th2).cpu().numpy()
        torch.cuda.synchronize()
        print(f"config 3 at two near-typical points: Schur {s12.tolist()}, "
              f"dense float64 on the card (n {len(psrs45) * st45['nb_tot']}) "
              f"{d12.tolist()} in {time.perf_counter() - t0:.1f} s; "
              f"difference {s12[0] - s12[1]:.6f} against "
              f"{d12[0] - d12[1]:.6f}")
        dd = d12[0] - d12[1]
        if not (np.isfinite(s12).all() and np.isfinite(d12).all()
                and abs((s12[0] - s12[1]) - dd)
                <= DIFF45_ATOL + DIFF45_RTOL * abs(dd)):
            fail("config 3: lnL differences disagree with the float64 "
                 "dense oracle")
        corner_report(like45, dense45, like45.sample_prior(
            np.random.default_rng(0), CORNER_DRAWS["pta45"]), "config 3",
            chunk=8)
        del dense45
        # the evaluation cache at config 3, from where the chain's last
        # cold walker stands (at the near-typical points every noise block
        # lies above the condition bound; see the stage-1 row above)
        with RecordShapes(mk, "mega_solve_logdet", 0) as rec:
            routes.reset_counts()
            ev45, _ = cache_sequence(like45, chain[-1, :like45.ndim],
                                     CACHE_UPDATES, 45, "config 3 cache")
            launches["pta45_site"] = dict(routes.LAUNCHES)
        site_row("mega_solve@pta45_site", "pta45_site", rec, 100, ev45)
        ms45 = cache_times(like45, ev45, "config 3 cache", smi)
        print(f"config 3 cache: site + stage 3 {ms45['site']:.3f} ms against a "
              f"full update {ms45['full']:.3f} ms at one theta; ROADMAP's "
              "estimate of the most the cache can save at W 8: the front end "
              "plus stages 1-2, 9.2 of a 35.7 ms call")
        # the optimal statistic at config 3 on the run_ptmcmc chain
        # the results CLI's optimal statistic on the chain, as users run
        # it, then the statistic against the CPU and the witness
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"{PKG}.results", "--result", pf45,
             "--optimal_statistic", "1"], cwd=HERE, capture_output=True,
            text=True, timeout=900)
        pkl = os.path.join(out45, "optimal_statistic.pkl")
        print(f"results CLI --optimal_statistic 1 on config 3: rc "
              f"{proc.returncode} in {time.perf_counter() - t0:.1f} s")
        if proc.returncode != 0 or not os.path.exists(pkl):
            fail(f"the optimal statistic failed on {pf45}: "
                 + proc.stderr[-2000:])
        payload = pickle.load(open(pkl, "rb"))
        print(f"config 3: optimal_statistic.pkl hd A^2 "
              f"{payload['hd']['a2']:.4e} +- {payload['hd']['a2_err']:.4e}, "
              f"S/N {payload['hd']['snr']:.4f} over "
              f"{len(payload['hd']['rho'])} pairs")
        if len(payload["hd"]["rho"]) != len(psrs45) * (len(psrs45) - 1) // 2:
            fail("config 3: optimal_statistic.pkl does not hold every pair")
        os_check(psrs45, tls45, like45, chain, OS_DRAWS, "config 3", smi)
        lo = np.array([p.prior.lo for p in like45.params])
        hi = np.array([p.prior.hi for p in like45.params])
        eps = 1e-3 * (hi - lo)
        lc = like45.loglike_batch(np.stack([lo + eps, hi - eps]))
        print(f"config 3 at the prior corners inset by 1e-3 of the range: "
              f"lnL {lc.tolist()}")
        if torch.isnan(lc).any():
            fail("config 3: NaN at a prior corner")

        # ---- phase 9: the north star's pipeline leg ----------------------
        lap("8")
        free = shutil.disk_usage(tmp).free
        print(f"north star leg: {free / 2**30:.1f} GiB free for its chain "
              "file")
        with RecordBatches(mk, "mega_like", 1) as rec:
            routes.reset_counts()
            rep, nsam, post, parts = run_north_star(
                dev, os.path.join(tmp, "out", "north_star"))
            torch.cuda.synchronize()
            launches["north_star"] = dict(routes.LAUNCHES)
        W = nsam.W
        n_ns = rec.last[W][0].shape[-1]
        # a heartbeat per block and one per convergence check
        ns_dir = os.path.join(tmp, "out", "north_star")
        ns_ck = sum(e["type"] == "checkpoint" for e in last_session(
            os.path.join(ns_dir, "events.jsonl")))
        stream_check(ns_dir, "north star leg", blocks=ns_ck + parts["checks"])
        print(f"north star leg: launches {launches['north_star']}, "
              f"likelihood-kernel calls per order and walker batch "
              f"{ {n: dict(c) for n, c in rec.sizes.items()} }")
        anneal_steps = len(NORTH_STAR_ANNEAL["schedule"]) \
            * NORTH_STAR_ANNEAL["steps_per"]
        if launches["north_star"]["mega_like"] < rep.steps + anneal_steps \
                or rec.sizes[n_ns].get(W, 0) < rep.steps + anneal_steps:
            fail("north star leg: not one likelihood-kernel launch at W "
                 f"{W} per step")
        wall = parts["anneal_s"] + rep.wall_s
        from enterprise_warp_tpu_torch.samplers.ptmcmc import _FAM_NAMES
        fam = {n: (a / p if p else None) for n, a, p, w in zip(
            _FAM_NAMES, nsam.fam_accept, nsam.fam_propose,
            nsam.jump_probs) if w > 0}
        print(f"north star leg: converged {rep.converged} at {rep.steps} "
              f"steps x {W} chains (R-hat {rep.rhat_max:.4f}, ESS "
              f"{rep.ess_min:.1f}); wall {wall:.2f} s (anneal "
              f"{parts['anneal_s']:.2f} s, sampling {rep.wall_s:.2f} s, "
              f"steady {rep.steady_wall_s:.2f} s), "
              f"{1e3 * rep.wall_s / rep.steps:.3f} ms/step, blocks "
              f"{1e3 * parts['blocks_s'] / rep.steps:.3f} ms/step, ESS/s "
              f"{rep.ess_min / wall:.2f}; parts {parts}; cold acceptance "
              f"per family {fam} [{smi}]")
        if not rep.converged:
            fail(f"north star leg: not converged within "
                 f"{NORTH_STAR_MAX_STEPS} steps")
        if not all(a is not None and np.isfinite(a) and a > 0
                   for a in fam.values()):
            fail("north star leg: a family with weight accepted nothing")
        with open(os.path.join(HERE, "NORTH_STAR.json")) as fh:
            ns_ref = json.load(fh)
        leg = {"posterior": post}
        for other in ("cpu", "device"):
            m = posterior_match(leg, ns_ref[other])
            print(f"north star leg against NORTH_STAR.json's {other} leg "
                  f"({ns_ref[other]['platform']}): {m}")
            for k, d in post.items():
                c = ns_ref[other]["posterior"][k]
                sd = max(d["std"], c["std"])
                print(f"  {k}: mean {d['mean']:.6g} ({c['mean']:.6g}), std "
                      f"{d['std']:.6g} ({c['std']:.6g}), shift "
                      f"{abs(d['mean'] - c['mean']) / sd:.3f} sigma, ratio "
                      f"{d['std'] / c['std']:.3f}")
            if other == "cpu" and not m["match"]:
                fail("north star leg: the posterior does not match the "
                     "float64 CPU leg of NORTH_STAR.json")
        # 11.3: the streaming gate at its default (on): the checks it
        # decided from the ledger, and the exact folds it ran
        modes = collections.Counter(
            e.get("diag_mode") for e in last_session(
                os.path.join(ns_dir, "events.jsonl"))
            if e.get("phase") == "convergence_check")
        print(f"11.3 north star leg, the streaming gate at its default: "
              f"{rep.steps} steps, sampling {rep.wall_s:.2f} s, time in "
              f"the exact checks {parts.get('checks_s', 0.0):.2f} s, "
              f"{modes['exact']} exact folds and {modes['stream']} checks "
              f"decided by the streaming ledger (run 14g of PERF.md, every "
              f"check exact: {EXACT_NORTH_STAR['steps']} steps, sampling "
              f"{EXACT_NORTH_STAR['sampling_s']:.2f} s) [{smi}]")
        if not modes["exact"]:
            fail("north star leg: converged with no exact check")
        # the ledger's streaming figures against the exact estimators on
        # the same kept steps (its window within one block of theirs), for
        # the parameters the streaming figures rank worst (the ones that
        # decide the gate), each at the reference's gates
        from enterprise_warp_tpu_torch.utils.diagnostics import \
            summarize_chains
        led = nsam.diag_ledger
        rh_s, es_s = led.split_rhat(0.25), led.moment_ess(0.25)
        names = nsam.like.param_names
        pick = sorted({int(np.argmax(rh_s)), int(np.argmin(es_s))})
        t0 = time.perf_counter()
        ex = summarize_chains(rep.chains[:, :, pick].astype(np.float64),
                              [names[i] for i in pick])
        ex_s = time.perf_counter() - t0
        agree = led.total_steps == rep.steps
        for i in pick:
            e = ex[names[i]]
            ratio = es_s[i] / e["ess"] if e["ess"] else None
            print(f"11.3 north star leg, {names[i]}: streaming R-hat "
                  f"{rh_s[i]:.5f} ESS {es_s[i]:.1f}; exact R-hat "
                  f"{e['rhat']:.5f} ESS {e['ess']:.1f} on the same "
                  f"{rep.chains.shape[1]} kept steps of {rep.chains.shape[0]}"
                  f" chains; ESS ratio {ratio}")
            agree = agree and e["rhat"] is not None and ratio is not None \
                and abs(rh_s[i] - e["rhat"]) < STREAM_RHAT_ATOL \
                and 1.0 / STREAM_ESS_RATIO < ratio < STREAM_ESS_RATIO
        print(f"11.3 north star leg: the exact fold of those parameters "
              f"took {ex_s:.2f} s; the ledger's worst figures "
              f"{led.worst(0.25)}")
        if not agree:
            fail("north star leg: the streaming R-hat/ESS disagree with the "
                 "exact estimators beyond the reference's gates")
        prof = profile_block(nsam, rep.steps, 50)
        per = (f"{1e3 * prof['device_s'] / prof['steps']:.3f} ms/step on "
               f"the device, busy share {prof['busy_share']:.3f}"
               if prof["device_s"] is not None else
               "device time not measured (the profiler recorded none)")
        print(f"north star leg, one more block of {prof['steps']} steps "
              f"under torch.profiler: wall {prof['wall_s']:.3f} s "
              f"({1e3 * prof['wall_s'] / prof['steps']:.3f} ms/step), {per}; "
              f"kernels by device time (name, calls, ms) {prof['top']} "
              f"[{smi}]")
        kern, plain, shape, exact = like_calls(tuple(
            x.detach() if torch.is_tensor(x) else x for x in rec.last[W]))
        hold_solve("mega_like@north_star", "north_star", kern, plain,
                   lambda tiers, a=rec.last[W]: like_cost(a[0], a[4], a[7],
                                                          tiers),
                   shape, exact=exact, what="the leg's last step")
        results["mega_like@north_star"]["batch_sizes"] = \
            dict(rec.sizes[n_ns])
        lap("9")

        # ---- phase 10: the run plane -------------------------------------
        phase_run_plane(tmp, dev, smi, results)
        lap("10")

        # ---- phase 11: the sampled chromatic index and the plane ---------
        for lg in loggers:
            lg.addHandler(handler)
        try:
            phase_chromatic(tmp, dev, smi, results, launches, walkers,
                            types.SimpleNamespace(
                                drive=drive, pt_report=pt_report,
                                hold_solve=hold_solve,
                                hold_last_step=hold_last_step,
                                solve_calls=solve_calls))
        finally:
            for lg in loggers:
                lg.removeHandler(handler)
        phase_plane(tmp, dev, smi)
        lap("11")

        # ---- phase 12: the pulsar axis across processes ------------------
        phase_pulsar_axis(tmp, dev, smi, results, pf45, like45, step_ms45,
                          types.SimpleNamespace(
                              hold_solve=hold_solve, solve_calls=solve_calls))
        lap("12")

    kernels = []
    for entry, r in results.items():
        kname = entry.split("@")[0]
        kernels.append(dict(
            name=entry, route="cuda", source=SOURCE,
            replaces=REPLACES[kname],
            launches=(r["launches"] if "launches" in r
                      else launches[r["run"]][kname]),
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None, kernel=kname,
            path=PATHS[r["run"]], shape=r["shape"]))
        for key in ("phases_ms", "stage_a_ms", "single_block_ms",
                    "bare_call_ms", "serial_ms", "global_design_ms",
                    "batch_sizes", "per_k"):
            if key in r:
                kernels[-1][key] = r[key]
    if gram_ratios:
        top = max(gram_ratios, key=gram_ratios.get)
        print(f"the likelihood kernel's Gram on the held walkers of "
              f"{len(gram_ratios)} sampler calls: at most "
              f"{gram_ratios[top]:.4f} of the float32 rounding bound (at "
              f"{top}; arbitrated walkers are held at {GRAM_BOUND_FRAC:g})")
    print(f"chip_smoke: wall {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
