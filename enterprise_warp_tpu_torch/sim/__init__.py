"""Fake-dataset generation and noise injection (counterpart of
``enterprise_warp_tpu/sim``, the native replacement of the reference's
libstempo bridge): white noise per backend, red/DM Fourier-series
injection from PSD priors, PAL2-noise-dict injection and whole fake
arrays."""

from .noise import (add_noise, added_noise_psd_to_vector, inject_white,
                    inject_basis_process, lorenzian_red_psd,
                    plot_noise_psd_from_dict, red_psd, red_v1_psd,
                    dm_psd, make_fake_pulsar, make_fake_pta)

__all__ = ["add_noise", "added_noise_psd_to_vector", "inject_white",
           "inject_basis_process", "lorenzian_red_psd",
           "plot_noise_psd_from_dict", "red_psd", "red_v1_psd",
           "dm_psd", "make_fake_pulsar", "make_fake_pta"]
