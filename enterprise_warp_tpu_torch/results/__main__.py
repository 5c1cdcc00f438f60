"""``python -m enterprise_warp_tpu_torch.results --result <dir> ...`` —
the results CLI.

Counterpart of ``enterprise_warp_tpu/results/__main__.py``: dynamic
import of a user model file, then OptimalStatisticWarp,
BilbyWarpResult or EnterpriseWarpResult by option. The optimal
statistic rebuilds the array's likelihood terms and runs on the card
(``main(argv, device="cpu")`` is the library entry for the host); the
rest is numpy.
"""

import sys

from .core import EnterpriseWarpResult, parse_commandline


def main(argv=None, device="cuda"):
    opts = parse_commandline(argv)
    custom = None
    if opts.custom_models_py and opts.custom_models:
        from ..cli import import_custom_models
        custom = import_custom_models(opts.custom_models_py,
                                      opts.custom_models)

    if opts.optimal_statistic:
        from .optstat import OptimalStatisticWarp
        result = OptimalStatisticWarp(opts, custom_models_obj=custom,
                                      device=device)
    elif opts.bilby:
        from .bilbylike import BilbyWarpResult
        result = BilbyWarpResult(opts, custom_models_obj=custom)
    else:
        result = EnterpriseWarpResult(opts, custom_models_obj=custom)

    result.main_pipeline()
    return 0


if __name__ == "__main__":
    sys.exit(main())
