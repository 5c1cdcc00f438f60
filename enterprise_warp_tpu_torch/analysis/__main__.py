# ewt: allow-no-print module — the lint's command line: its report on
# stdout is its output
"""``ewt-lint`` CLI for the port — run the rule engine.

Usage::

    python -m enterprise_warp_tpu_torch.analysis            # the package
    python -m enterprise_warp_tpu_torch.analysis path/to/file.py
    python -m enterprise_warp_tpu_torch.analysis --rule host-sync
    python -m enterprise_warp_tpu_torch.analysis --json     # JSON report
    python -m enterprise_warp_tpu_torch.analysis --list-rules
    python -m enterprise_warp_tpu_torch.analysis --show-suppressed

Exit status: 0 when no unsuppressed finding, 1 otherwise, 2 on usage
errors. The engine is standard library only: this imports neither torch
nor jax.
"""

import argparse
import json
import sys

from . import all_rules, run_lint
from .core import REPO_ROOT


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m enterprise_warp_tpu_torch.analysis",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint (default: the port "
                         "package)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the JSON report on stdout")
    ap.add_argument("--rule", action="append", default=None,
                    help="restrict to this rule (repeatable)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="include suppressed findings in the human "
                         "output (the annotation audit record)")
    args = ap.parse_args(argv)

    if args.list_rules:
        for name, rule in all_rules().items():
            sev = rule.severity + (f"->{rule.escalates_to}"
                                   if rule.escalates_to else "")
            print(f"{name:22s} [{sev}] {rule.summary}")
        return 0

    try:
        res = run_lint(paths=args.paths or None, root=REPO_ROOT,
                       rules=args.rule)
    except ValueError as e:
        print(f"ewt-lint: {e}", file=sys.stderr)
        return 2

    if args.as_json:
        print(json.dumps(res.to_json(), indent=2, sort_keys=True))
    else:
        print(res.format_human(show_suppressed=args.show_suppressed))
    return 1 if res.active else 0


if __name__ == "__main__":
    sys.exit(main())
