"""Data ingestion: tempo2-format .par/.tim parsing and Pulsar containers
(a copy of the reference package's numpy-only ``io`` layer, Python .tim
engine only), the .par/.tim writers and the samplers' checkpoint/JSON
writers."""

from .errors import ParseError
from .par import parse_par, ParFile
from .tim import parse_tim, TimFile
from .pulsar import Pulsar, load_pulsar, load_pulsars_from_dir
from .writers import (pulsar_to_timfile, save_pulsar_pair, write_par,
                      write_tim)

__all__ = [
    "ParseError", "parse_par", "ParFile", "parse_tim", "TimFile",
    "Pulsar", "load_pulsar", "load_pulsars_from_dir",
    "write_par", "write_tim", "pulsar_to_timfile", "save_pulsar_pair",
]
