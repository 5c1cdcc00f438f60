"""Measurement scripts of the port that run on the card beside
``chip_smoke.py``: :mod:`.ab` (a parent-against-change A/B of the PT
paths) and :mod:`.recon_witness` (the noise reconstruction against a
long-double witness). Each is run as ``python -m
enterprise_warp_tpu_torch.bench.<name>``; nothing in the package imports
them."""
