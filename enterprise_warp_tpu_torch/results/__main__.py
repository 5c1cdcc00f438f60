"""``python -m enterprise_warp_tpu_torch.results --result <dir> ...`` —
the results CLI.

Counterpart of ``enterprise_warp_tpu/results/__main__.py``: dynamic
import of a user model file, then EnterpriseWarpResult or
BilbyWarpResult by option. ``--optimal_statistic`` is a later slice of
the port (``ROADMAP.md`` Queue 1 item 10) and raises
``NotImplementedError``.
"""

import sys

from .core import EnterpriseWarpResult, parse_commandline


def main(argv=None):
    opts = parse_commandline(argv)
    if opts.optimal_statistic:
        raise NotImplementedError(
            "--optimal_statistic (results/optstat.py) is a later slice of "
            "the port (ROADMAP.md Queue 1 item 10)")

    custom = None
    if opts.custom_models_py and opts.custom_models:
        from ..cli import import_custom_models
        custom = import_custom_models(opts.custom_models_py,
                                      opts.custom_models)

    if opts.bilby:
        from .bilbylike import BilbyWarpResult
        result = BilbyWarpResult(opts, custom_models_obj=custom)
    else:
        result = EnterpriseWarpResult(opts, custom_models_obj=custom)

    result.main_pipeline()
    return 0


if __name__ == "__main__":
    sys.exit(main())
