"""Parity of the torch port's data and config layer with the JAX package.

Both example pulsars are parsed by both packages (the JAX side through its
Python .tim engine, the port's only engine) and every example paramfile
is parsed by both ``Params`` classes; arrays and fields must be equal.
"""

import functools
import glob
import os
import types

import numpy as np
import pytest
import torch

import enterprise_warp_tpu.io.pulsar as j_pulsar
from enterprise_warp_tpu.config import Params as JParams
from enterprise_warp_tpu.io.tim import parse_tim as j_parse_tim
from enterprise_warp_tpu_torch.config import Params as TParams
from enterprise_warp_tpu_torch.io import load_pulsar as t_load
from enterprise_warp_tpu_torch.io import parse_tim as t_parse_tim

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "examples", "data")
STEMS = ("J1234-5678", "fake_psr_0")


@pytest.fixture
def j_python_engine(monkeypatch):
    monkeypatch.setattr(j_pulsar, "parse_tim",
                        functools.partial(j_parse_tim, engine="python"))


@pytest.mark.parametrize("stem", STEMS)
def test_tim_parse_equal(stem):
    path = os.path.join(DATA, stem + ".tim")
    a, b = j_parse_tim(path, engine="python"), t_parse_tim(path)
    for f in ("freqs", "mjd_int", "sec", "errs"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert list(a.names) == list(b.names)
    assert sorted(a.flags) == sorted(b.flags)
    for k in a.flags:
        assert np.array_equal(a.flags[k], b.flags[k]), k


@pytest.mark.parametrize("stem", STEMS)
def test_pulsar_arrays_equal(stem, j_python_engine):
    par, tim = (os.path.join(DATA, stem + ext) for ext in (".par", ".tim"))
    a = j_pulsar.load_pulsar(par, tim)
    b = t_load(par, tim)
    assert a.name == b.name
    for f in ("toas", "toaerrs", "residuals", "Mmat", "freqs", "pos",
              "backend_flags"):
        assert np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f))), f
    assert list(a.Mmat_labels) == list(b.Mmat_labels)
    assert sorted(a.flags) == sorted(b.flags)
    for k in a.flags:
        assert np.array_equal(a.flags[k], b.flags[k]), k
    assert a.dq_report.token() == b.dq_report.token()


def _fields(obj):
    skip = {"noise_model_obj", "custom_models_obj", "models", "opts",
            "label_attr_map", "psrs"}
    return {k: v for k, v in vars(obj).items() if k not in skip}


@pytest.mark.parametrize("prfile", sorted(glob.glob(os.path.join(
    REPO, "examples", "example_params", "*.dat"))),
    ids=os.path.basename)
def test_params_fields_equal(prfile):
    opts = types.SimpleNamespace(num=0, drop=0, mpi_regime=2,
                                 wipe_old_output=0, extra_model_terms=None)
    a = JParams(prfile, opts=opts, init_pulsars=False)
    b = TParams(prfile, opts=opts, init_pulsars=False)
    assert _fields(a) == _fields(b)
    assert sorted(a.label_attr_map) == sorted(b.label_attr_map)
    assert sorted(a.models) == sorted(b.models)
    for m in a.models:
        assert _fields(a.models[m]) == _fields(b.models[m])
