"""Fake-dataset generation and noise injection (counterpart of
``enterprise_warp_tpu/sim``; the subset the joint-likelihood fixtures
need, ``sim/noise.py``)."""

from .noise import (inject_basis_process, inject_white, make_fake_pta,
                    make_fake_pulsar, red_psd)

__all__ = ["make_fake_pulsar", "make_fake_pta", "inject_white",
           "inject_basis_process", "red_psd"]
