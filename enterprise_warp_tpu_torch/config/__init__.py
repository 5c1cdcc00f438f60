"""Configuration: the paramfile DSL + noise-model JSON dispatch (a copy
of the reference package's numpy-only ``config`` layer)."""

from .paramfile import Params, ModelParams, parse_commandline, \
    IMPLEMENTED_SAMPLERS
from .modeldict import read_json_dict, merge_two_noise_model_dicts, \
    get_noise_dict

__all__ = [
    "Params", "ModelParams", "parse_commandline", "IMPLEMENTED_SAMPLERS",
    "read_json_dict", "merge_two_noise_model_dicts", "get_noise_dict",
]
