"""The port's native IO core (``enterprise_warp_tpu_torch/native.py``, a
ctypes binding of ``native/fastio.cpp`` built into the port's own
``_build/``): a mirror of ``tests/test_native.py``.

Each native parse is held against the port's Python engine and the JAX
package's Python engine (integer MJDs, names, sites and flags exactly,
seconds within 1e-9 s) on ``examples/data/``, on files the port's
writers produce and on generated fixtures (INCLUDE recursion, valueless
flags, a cyclic INCLUDE, missing and malformed files); the grammar gate
that follows a native parse against the JAX package's; the table reader
and writer against ``np.loadtxt``/``np.savetxt``; and the results layer
and the chain writer through them. The tests skip only where ``g++`` is
absent.
"""

import pathlib
import shutil

import numpy as np
import pytest

from enterprise_warp_tpu.io.tim import parse_tim as j_parse_tim
from enterprise_warp_tpu_torch import native
from enterprise_warp_tpu_torch.io.errors import ParseError
from enterprise_warp_tpu_torch.io.tim import parse_tim

REPO = pathlib.Path(__file__).resolve().parents[1]
DATA = REPO / "examples" / "data"


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native core cannot be built here")
    out = native.load()
    assert out is not None, "g++ is present but the native core did not load"
    return out


def _assert_same(a, b):
    np.testing.assert_array_equal(a.mjd_int, b.mjd_int)
    np.testing.assert_allclose(a.sec, b.sec, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(a.freqs, b.freqs)
    np.testing.assert_array_equal(a.errs, b.errs)
    assert list(a.names) == list(b.names)
    assert list(a.sites) == list(b.sites)
    assert sorted(a.flags) == sorted(b.flags)
    for k in a.flags:
        assert list(a.flags[k]) == list(b.flags[k]), k


def _three_ways(path):
    nat = parse_tim(str(path), engine="auto")
    _assert_same(nat, parse_tim(str(path), engine="python"))
    _assert_same(nat, j_parse_tim(str(path), engine="python"))
    return nat


def test_build_lands_in_the_port(lib):
    """The library is built from the repository's source into the port's
    git-ignored build directory, never into the JAX package."""
    assert native.SO_PATH.parent == REPO / "enterprise_warp_tpu_torch" / \
        "_build"
    assert native.SO_PATH.exists()
    assert native.SO_PATH.stat().st_mtime >= native.SRC.stat().st_mtime
    assert native.load() is lib and native.build() == native.SO_PATH


@pytest.mark.parametrize("stem", ["J1234-5678", "fake_psr_0"])
def test_parity_on_example_data(lib, stem):
    nat = _three_ways(DATA / f"{stem}.tim")
    assert len(nat) > 100


def test_parity_on_written_pulsars(lib, tmp_path):
    """``.tim`` files the port's writers produce (BASELINE config 3's
    kind: several backends, flags on every TOA)."""
    from enterprise_warp_tpu_torch.io.writers import save_pulsar_pair
    from enterprise_warp_tpu_torch.sim import make_fake_pta
    for psr in make_fake_pta(npsr=3, ntoa=200, seed=9):
        par, tim = save_pulsar_pair(psr, str(tmp_path))
        nat = _three_ways(tim)
        assert len(nat) == 200


def test_include_recursion_and_valueless_flags(lib, tmp_path):
    inner = tmp_path / "inner.tim"
    inner.write_text("FORMAT 1\n"
                     "b 700.0 55001.5 2.0 pks -novalue -f X\n")
    outer = tmp_path / "outer.tim"
    outer.write_text("FORMAT 1\n"
                     "# comment\n"
                     "a 1400.0 55000.25 1.0 bat -f A\n"
                     "INCLUDE inner.tim\n")
    nat = _three_ways(outer)
    assert len(nat) == 2
    assert list(nat.flags["novalue"]) == ["", "1"]
    assert list(nat.mjd_int) == [55000, 55001]


def test_cyclic_include_raises(lib, tmp_path):
    cyc = tmp_path / "cyc.tim"
    cyc.write_text("FORMAT 1\nINCLUDE cyc.tim\n")
    with pytest.raises(ValueError, match="nesting"):
        parse_tim(str(cyc), engine="auto")
    with pytest.raises(ValueError, match="nesting"):
        parse_tim(str(cyc), engine="python")


def test_missing_file_contract_matches_python_engine(lib, tmp_path):
    for engine in ("auto", "python"):
        with pytest.raises(FileNotFoundError):
            parse_tim(str(tmp_path / "nope.tim"), engine=engine)


def test_malformed_numeric_raises_in_both_engines(lib, tmp_path):
    """The native core skips a line it cannot read; the grammar gate then
    gives the Python engine's typed error with its provenance."""
    bad = tmp_path / "bad.tim"
    bad.write_text("FORMAT 1\na 14OO.0 55000.25 1.0 bat -f A\n")
    for engine in ("auto", "python"):
        with pytest.raises(ParseError, match="bad.tim:2"):
            parse_tim(str(bad), engine=engine)


# lines of every kind the walk tells apart: plain TOAs, headers in both
# cases, comments, directives of fewer than five tokens, C-heads followed
# by a tab, leading and inner whitespace of other kinds, blank lines
_GATE_LINES = (
    "a 1400.0 55000.25 1.0 bat -f A", "b 700.0 55001.5 2.0 pks",
    "  c\t1400 55002.0 1.5 bat -x -y 3", "\u00a0d 1400 55003 1 bat",
    "e 1400.0 55004.0 1.0\x0cbat -f A", "FORMAT 1", "format 1 a b c d",
    "MODE 1", "Mode 1 x y z w", "# comment", "#x 1 2 3 4 5",
    "C a comment of many tokens here", "CN another comment x y z",
    "C\tfour toks 1 2", "c 1400.0 55005.0 1.0 bat", "cn 1 2 3 4",
    "EFAC 1.1", "JUMP -f A 0.1", "TIME 0.5", "one two three four",
    "", "   ", "\t", "f 1400.0 55006.0 1.0 bat -novalue", "C  \t",
    "formats 1400.0 55008.0 1.0 bat", "MODEL 1")


@pytest.mark.parametrize("seed", range(6))
def test_grammar_gate_matches_the_walk(lib, tmp_path, seed):
    """The counting grammar gate answers as the JAX package's line walk
    does (``enterprise_warp_tpu.io.tim._grammar_matches_native``) at the
    native core's row count, on files drawn from every kind of line, CRLF
    and missing final newlines included; and a file with an INCLUDE takes
    the walk."""
    from enterprise_warp_tpu.io.tim import _grammar_matches_native as j_gate
    from enterprise_warp_tpu_torch.io.tim import _grammar_matches_native
    rng = np.random.default_rng(seed)
    (tmp_path / "inner.tim").write_text("g 1400.0 55007.0 1.0 bat\n")
    verdicts = set()
    for trial in range(40):
        plain = trial % 2 == 0
        pool = _GATE_LINES[:5] + _GATE_LINES[5:8] if plain else _GATE_LINES
        lines = [pool[i] for i in rng.integers(0, len(pool), 12)]
        if trial % 5 == 4:
            lines.insert(int(rng.integers(0, 12)), "INCLUDE inner.tim")
        end = ("\r\n", "\n")[trial % 3 != 1]
        text = end.join(lines) + ("" if trial % 4 == 3 else end)
        path = tmp_path / f"t{trial}.tim"
        path.write_bytes(text.encode())
        n = len(native.parse_tim_native(str(path))[0])
        want = j_gate(str(path), n)
        assert _grammar_matches_native(str(path), n) == want, (text, n)
        verdicts.add(want)
    assert verdicts == {True, False}


def test_unknown_engine_rejected(tmp_path):
    with pytest.raises(ValueError, match="unknown engine"):
        parse_tim(str(tmp_path / "x.tim"), engine="native")


def test_fallback_without_the_core(tmp_path, monkeypatch):
    """Where the core is unavailable every caller takes the Python path."""
    monkeypatch.setattr(native, "load", lambda: None)
    _assert_same(parse_tim(str(DATA / "fake_psr_0.tim")),
                 parse_tim(str(DATA / "fake_psr_0.tim"), engine="python"))
    arr = np.arange(12.0).reshape(3, 4)
    path = tmp_path / "t.txt"
    native.write_table(str(path), arr, append=False)
    assert path.read_text() == _savetxt_text(tmp_path, arr)
    assert native.read_table_native(str(path)) is None
    from enterprise_warp_tpu_torch.results.core import _read_table
    np.testing.assert_array_equal(_read_table(path), arr)


def _savetxt_text(tmp_path, arr):
    p = tmp_path / "savetxt.txt"
    np.savetxt(p, arr)
    return p.read_text()


def test_read_table_matches_loadtxt(lib, tmp_path):
    rng = np.random.default_rng(3)
    arr = rng.standard_normal((257, 7)) * 10.0 ** rng.integers(
        -12, 12, (257, 7))
    path = tmp_path / "chain_1.txt"
    np.savetxt(path, arr)
    with open(path, "a") as fh:
        fh.write("# trailing comment\n\n")
    got = native.read_table_native(str(path))
    np.testing.assert_array_equal(got, np.loadtxt(path))


def test_write_table_matches_savetxt(lib, tmp_path):
    """The native writer: the same '%.18e' rows as np.savetxt (float64
    round trip exact), with append semantics."""
    rng = np.random.default_rng(5)
    arr = rng.standard_normal((123, 6)) * 10.0 ** rng.integers(
        -12, 12, (123, 6))
    arr[0, 0] = 0.0
    arr[1, 1] = -1.5e-300
    p_native = tmp_path / "native.txt"
    native.write_table(str(p_native), arr[:60], append=False)
    native.write_table(str(p_native), arr[60:], append=True)
    np.testing.assert_array_equal(np.loadtxt(p_native), arr)
    assert p_native.read_text() == _savetxt_text(tmp_path, arr)
    # append=False replaces the file
    native.write_table(str(p_native), arr[:2], append=False)
    assert p_native.read_text() == _savetxt_text(tmp_path, arr[:2])


@pytest.mark.parametrize("text", [
    "1.0 2.0 3.0\n4.0 5.0\n",
    "1 2 3 4\n5 6 7 8\n9 10 11 12\n13 14\n15 16\n",
    "1.0 2.0\n3.0 garbage\n5.0 6.0\n",
], ids=["ragged", "ragged_divisible", "non_numeric"])
def test_read_table_rejects(lib, tmp_path, text):
    """A ragged row (even with a total that reshapes) or a non-numeric
    token must not be read: the caller's np.loadtxt then raises."""
    path = tmp_path / "bad.txt"
    path.write_text(text)
    assert native.read_table_native(str(path)) is None
    from enterprise_warp_tpu_torch.results.core import _read_table
    with pytest.raises(ValueError):
        _read_table(path)


def test_results_layer_and_chain_writer_use_the_core(lib, tmp_path,
                                                     monkeypatch):
    """``results.core._read_table`` reads through the native reader and
    ``io.writers.write_table`` writes through the native writer."""
    from enterprise_warp_tpu_torch.io import writers
    from enterprise_warp_tpu_torch.results.core import _read_table
    calls = []
    read = native.read_table_native
    monkeypatch.setattr(native, "read_table_native",
                        lambda p: calls.append(p) or read(p))
    arr = np.arange(12.0).reshape(3, 4)
    path = tmp_path / "t.txt"
    assert writers.write_table is native.write_table
    writers.write_table(str(path), arr, append=False)
    np.testing.assert_array_equal(_read_table(path), arr)
    assert calls == [str(path)]
