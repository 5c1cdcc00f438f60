"""``ewt-lint`` for the port — the AST rule engine of the reference's
``analysis/`` package, holding this package to its own contracts.

Host-sync discipline on the hot path, purity of CUDA-graph-captured
bodies, graph outputs that the next replay overwrites, explicit random
streams, the float64 islands and the TF32 switch, counted collectives,
and the four textual bans (``print``, raw timing, a raw kernel launch,
a bare graph or compile). Each rule names its counterpart in the
reference.

Standard library only: importing this package imports neither torch
nor jax, so the lint runs without a card and a full-package run takes
seconds.

Entry points:

- :func:`run_lint` — library API (the tier-1 gate and the smoke's lint
  phase call it).
- ``python -m enterprise_warp_tpu_torch.analysis`` — the CLI
  (``--json``, ``--rule``, ``--list-rules``, ``--show-suppressed``;
  non-zero exit on findings).

Suppressions are inline comments — ``# ewt: allow-<rule> — <reason>``
— and the reason is mandatory: a suppression without one is itself a
finding.
"""

from .core import (Finding, LintResult, Rule, all_rules, iter_target_files,
                   run_lint)

# importing the rule modules populates the registry
from . import rules_style as _rules_style          # noqa: F401,E402
from . import rules_tracer as _rules_tracer        # noqa: F401,E402
from . import rules_collective as _rules_collective  # noqa: F401,E402

__all__ = ["Finding", "LintResult", "Rule", "all_rules",
           "iter_target_files", "run_lint"]
