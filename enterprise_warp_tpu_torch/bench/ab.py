"""Parent-against-change A/B of the port's PT paths on the card.

    python -m enterprise_warp_tpu_torch.bench.ab --parent DIR \\
        [--rounds 10] [--steps 1000] [--ns-steps 1000] [--out FILE]

``DIR`` is a checkout of the parent commit (``git archive`` unpacked in a
directory that ``.gitignore`` lists); the change is the checkout this
module lives in. Three arms: ``parent``, ``change`` and ``change_off``
(the change with ``EWT_TELEMETRY=0``). Each runs in a child interpreter
of its own; a round runs every arm once, the order rotated from round to
round, ``--rounds`` rounds. A child imports the package and
``chip_smoke.py`` of its own tree and runs, on the card:

- ``system_noise.dat --num 0`` and ``--num 1`` through the CLI,
  ``--steps`` steps in one block (the paramfile's ``covUpdate`` of 1000):
  the block's ms/step as the sampler times it;
- the north star's pipeline problem (``chip_smoke.north_star_problem``,
  ``PTSampler`` with ``NORTH_STAR_SAMPLER``, ``anneal_init`` with
  ``NORTH_STAR_ANNEAL``), then ``sample_to_convergence`` for
  ``--ns-steps`` steps with the leg's checks every 100 steps and a gate
  out of reach: ms/step over the wall of that call, and over the time
  of its blocks alone (``PTSampler._run_block``, synchronised, as
  ``chip_smoke.run_north_star`` times them).

Every child prints one JSON line (also appended to ``--out``); the last
line is the summary: per path, each arm's median and, for each arm of
the change, the median of its differences from the parent round by
round and in how many rounds it was the slower. The card's name and
power limit (``nvidia-smi``) head the output.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PATHS = ("pt0", "pt1", "north_star", "north_star_blocks")
ARMS = {"parent": {}, "change": {}, "change_off": {"EWT_TELEMETRY": "0"}}


def _child(tree, steps, ns_steps, dev):
    """One arm's turn (module docstring), in ``tree``'s package, on
    ``dev`` (``cpu`` only to rehearse the script)."""
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    from enterprise_warp_tpu_torch import cli
    from enterprise_warp_tpu_torch.samplers import PTSampler, convergence

    blocks = []

    class Blocks(logging.Handler):
        def emit(self, record):
            st = getattr(record, "block_stats", None)
            if st is not None:
                blocks.append(st)

    log = logging.getLogger("ewt.ptmcmc")
    log.setLevel(logging.INFO)
    log.addHandler(Blocks())
    out = {"tree": tree}
    with tempfile.TemporaryDirectory() as tmp:
        for num in (0, 1):
            pf = cs.write_paramfile(tmp, "system_noise.dat",
                                    dest=f"sn{num}.dat", nsamp=steps)
            del blocks[:]
            if cli.main(["--prfile", pf, "--num", str(num)],
                        device=dev) != 0:
                raise SystemExit(f"{tree}: --num {num} failed")
            out[f"pt{num}"] = blocks[0]["ms_per_step"]
        like = cs.north_star_problem("split", dev)
        sampler = PTSampler(like, os.path.join(tmp, "ns"),
                            **cs.NORTH_STAR_SAMPLER)
        sampler.anneal_init(verbose=False, **cs.NORTH_STAR_ANNEAL)
        gate = dict(cs.NORTH_STAR_GATE, target_ess=1e12)
        sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
        blocks_s = [0.0]
        run_block = sampler._run_block

        def timed_block(*args, **kw):
            t = time.perf_counter()
            res = run_block(*args, **kw)
            sync()
            blocks_s[0] += time.perf_counter() - t
            return res
        sampler._run_block = timed_block
        sync()
        t0 = time.perf_counter()
        convergence.sample_to_convergence(sampler, max_steps=ns_steps,
                                          verbose=False, **gate)
        sync()
        out["north_star"] = 1e3 * (time.perf_counter() - t0) / ns_steps
        out["north_star_blocks"] = 1e3 * blocks_s[0] / ns_steps
    print(json.dumps(out), flush=True)


def _smi():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="a checkout of the parent commit")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--ns-steps", type=int, default=1000)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cpu only to rehearse the script")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.child:
        _child(a.child, a.steps, a.ns_steps, a.device)
        return 0
    if not a.parent:
        ap.error("--parent is required")
    print(_smi(), flush=True)
    trees = {"parent": os.path.abspath(a.parent), "change": HERE,
             "change_off": HERE}
    names = list(ARMS)
    runs = {arm: [] for arm in names}
    for i in range(a.rounds):
        for arm in names[i % 3:] + names[:i % 3]:
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child",
                 trees[arm], "--steps", str(a.steps), "--ns-steps",
                 str(a.ns_steps), "--device", a.device],
                capture_output=True, text=True, cwd=trees[arm],
                env=dict(os.environ, **ARMS[arm]))
            lines = [ln for ln in r.stdout.splitlines()
                     if ln.startswith("{")]
            if r.returncode != 0 or not lines:
                print(r.stdout[-2000:], r.stderr[-4000:], file=sys.stderr)
                raise SystemExit(f"{arm} turn {i}: exit {r.returncode}")
            rec = dict(json.loads(lines[-1]), arm=arm, turn=i)
            runs[arm].append(rec)
            print(json.dumps(rec), flush=True)
            if a.out:
                with open(a.out, "a") as fh:
                    fh.write(json.dumps(rec) + "\n")
    summary = {}
    for p in PATHS:
        per = {arm: [r[p] for r in runs[arm]] for arm in names}
        summary[p] = {f"{arm}_median": statistics.median(v)
                      for arm, v in per.items()}
        for arm in names[1:]:
            diff = [c - q for c, q in zip(per[arm], per["parent"])]
            summary[p][f"{arm}_diff_median"] = statistics.median(diff)
            summary[p][f"{arm}_slower"] = sum(d > 0 for d in diff)
        summary[p].update(rounds=a.rounds, **per)
    print(json.dumps({"ab_summary": summary, "card": _smi()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
