"""The port's lint (``enterprise_warp_tpu_torch/analysis/``) against the
reference's engine (``enterprise_warp_tpu/analysis/``) and on its own
fixtures.

- parity: the same sources, planted under each package's path, give
  the same findings from both engines for the four framework-neutral
  rules (``parse-error``, ``bad-suppression``, ``no-print``,
  ``no-raw-timing``) over every suppression scope of the reference's
  tests (``tests/test_lint.py``);
- the JSON report has the reference's keys;
- each port rule catches a seeded fixture and is quiet on its
  disciplined twin; the hot-path predicate is positional;
- the command line (``python -m enterprise_warp_tpu_torch.analysis``)
  as the reference's ``tools/lint.py``;
- pinned sites of the package: ``_safe_eigh``'s ``eigh`` is a
  ``host-sync`` finding, every ``cuda_graphed`` target is in the capture
  index, the joint likelihood's unsharded note is not printed;
- the engine imports the standard library only, and the tier-1 gate:
  the port has zero unsuppressed findings.
"""

import ast
import json
import logging
import pathlib
import subprocess
import sys
import textwrap

import pytest

from enterprise_warp_tpu.analysis import run_lint as ref_run_lint
from enterprise_warp_tpu_torch.analysis import all_rules, run_lint
from enterprise_warp_tpu_torch.analysis.core import (HOT_PREFIXES,
                                                     SCHEMA_VERSION, Module)

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = "enterprise_warp_tpu_torch"
ANALYSIS = REPO / PKG / "analysis"

#: port rule -> the reference rule it stands for
COUNTERPARTS = {
    "parse-error": "parse-error", "bad-suppression": "bad-suppression",
    "no-print": "no-print", "no-raw-timing": "no-raw-timing",
    "no-raw-kernel-launch": "no-raw-pallas-call",
    "no-bare-graph": "no-bare-jit",
    "graph-output-alias": "donation-safety",
    "rng-explicit-generator": "rng-key-reuse", "host-sync": "host-sync",
    "graph-purity": "jit-purity", "precision": "precision",
    "collective-safety": "collective-safety",
}


def _plant(root, rel, body):
    target = root / rel
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_text(textwrap.dedent(body))
    return target


def _lint(tmp_path, rel, body, rules=None):
    target = _plant(tmp_path, rel, body)
    return run_lint(paths=[target], root=tmp_path, rules=rules)


# ------------------------------------------------------------------ #
#  parity with the reference's engine                                 #
# ------------------------------------------------------------------ #

_PARITY = {
    "line-scope": """\
        import time

        def pull(dev):
            # ewt: allow-no-print — fixture: intentional output
            print(dev)
            print(dev)     # NOT covered by the line above
            return time.perf_counter()
        """,
    "trailing-own-line": """\
        def pull(dev):
            print(dev)  # ewt: allow-no-print — fixture: ok
            print(dev)
        """,
    "trailing-no-leak-into-next-function": """\
        def a(dev):
            return print(dev)  # ewt: allow-no-print — boundary

        def b(dev):
            return print(dev)
        """,
    "multiline-statement": """\
        import time

        def run(dev):
            # ewt: allow-no-print — fixture: continuation cover
            out = max(1,
                      print(dev))
            return out

        def branch(flag, dev):
            # ewt: allow-no-raw-timing — fixture: must not cover the body
            if flag > time.perf_counter():
                a = time.perf_counter()
            return a
        """,
    "wrapped-comment-block": """\
        def pull(dev):
            # ewt: allow-no-print — a justification long enough to
            # wrap onto a second comment line, as real ones do
            return print(dev)
        """,
    "function-scope": """\
        import time

        # ewt: allow-no-raw-timing — fixture: whole function is timing
        def commit(dev):
            a = time.perf_counter()
            b = time.time()
            return a, b

        def other(dev):
            return time.perf_counter()
        """,
    "function-scope-over-decorators": """\
        import functools

        # ewt: allow-no-print -- fixture: a decorated function
        @functools.lru_cache()
        def f(x):
            print(x)
            return x

        def g(x):
            print(x)
        """,
    "module-scope": """\
        import time
        # ewt: allow-no-print,no-raw-timing module : fixture: file-wide

        def f():
            print(time.time())

        def g():
            print(time.monotonic())
        """,
    "suppression-without-reason": """\
        def pull(dev):
            # ewt: allow-no-print
            return print(dev)
        """,
    "unknown-rule": """\
        x = 1   # ewt: allow-no-such-rule — why not
        print(x)
        """,
    "malformed-annotation": """\
        x = 1   # ewt: allow- — nothing named
        print(x)
        """,
    "parse-error": "def broken(:\n",
}


def _key(res):
    return sorted((f.rule, f.line, f.col, f.severity, f.suppressed,
                   f.suppress_reason) for f in res.findings)


@pytest.mark.parametrize("case", sorted(_PARITY))
def test_parity_with_the_reference_engine(tmp_path, case):
    body = _PARITY[case]
    rules = ["no-print", "no-raw-timing"]
    ref = ref_run_lint(paths=[_plant(tmp_path, "enterprise_warp_tpu/"
                                     "samplers/s.py", body)],
                       root=tmp_path, rules=rules)
    port = run_lint(paths=[_plant(tmp_path, f"{PKG}/samplers/s.py", body)],
                    root=tmp_path, rules=rules)
    assert port.findings, "a parity case must produce findings"
    assert _key(port) == _key(ref), (
        "\n".join(f.format() for f in port.findings) + "\n---\n"
        + "\n".join(f.format() for f in ref.findings))


def test_parity_cases_cover_every_scope(tmp_path):
    """The scopes behave as the reference's tests pin them."""
    res = _lint(tmp_path, f"{PKG}/samplers/s.py", _PARITY["line-scope"],
                rules=["no-print"])
    assert [(f.line, f.suppressed) for f in res.findings] == [
        (5, True), (6, False)]
    assert res.suppressed[0].suppress_reason == \
        "fixture: intentional output"
    res = _lint(tmp_path, f"{PKG}/samplers/s.py",
                _PARITY["multiline-statement"], rules=["no-print",
                                                       "no-raw-timing"])
    assert [f.line for f in res.active] == [12]
    res = _lint(tmp_path, f"{PKG}/samplers/s.py",
                _PARITY["suppression-without-reason"])
    bad = [f for f in res.active if f.rule == "bad-suppression"]
    assert bad and "without a justification" in bad[0].message
    assert not [f for f in res.active if f.rule == "no-print"]


# ------------------------------------------------------------------ #
#  JSON schema                                                        #
# ------------------------------------------------------------------ #

def test_json_schema_matches_the_reference(tmp_path):
    body = _PARITY["line-scope"]
    ref = ref_run_lint(paths=[_plant(tmp_path, "enterprise_warp_tpu/"
                                     "samplers/s.py", body)],
                       root=tmp_path).to_json()
    res = run_lint(paths=[_plant(tmp_path, f"{PKG}/samplers/s.py", body)],
                   root=tmp_path)
    doc = json.loads(json.dumps(res.to_json(), allow_nan=False))
    assert set(doc) == set(ref)
    assert doc["version"] == SCHEMA_VERSION == ref["version"]
    assert doc["tool"] == ref["tool"] == "ewt-lint"
    assert set(doc["counts"]) == set(ref["counts"])
    assert doc["counts"]["active"] == len(res.active) > 0
    assert doc["counts"]["suppressed"] == len(res.suppressed) == 1
    assert doc["counts"]["active"] == \
        doc["counts"]["error"] + doc["counts"]["warning"]
    for f in doc["findings"]:
        twin = next(r for r in ref["findings"]
                    if r["suppressed"] == f["suppressed"])
        assert set(f) == set(twin)
        assert f["rule"] in doc["rules"]
        assert not f["path"].startswith("/")
    for meta in doc["rules"].values():
        assert {"severity", "summary"} <= set(meta) \
            <= {"severity", "summary", "escalates_to"}
    assert doc["rules"]["host-sync"] == {
        "severity": "warning", "escalates_to": "error",
        "summary": all_rules()["host-sync"].summary}


def test_rule_catalog_is_the_reference_catalog_in_port_terms():
    from enterprise_warp_tpu.analysis import all_rules as ref_rules
    rules = all_rules()
    assert set(rules) == set(COUNTERPARTS)
    assert set(COUNTERPARTS.values()) == set(ref_rules())
    for name, ref in COUNTERPARTS.items():
        if name not in ("parse-error", "bad-suppression"):
            assert f"reference rule: {ref})" in rules[name].contract, name


# ------------------------------------------------------------------ #
#  rule fixtures: each port rule on a seeded positive and its quiet   #
#  twin                                                               #
# ------------------------------------------------------------------ #

_FIXTURES = {
    "no-print": ("samplers/p.py", 2, """\
        def f(x):
            print(x)
            print("y")
        """, """\
        from ..utils.logging import get_logger

        def f(x):
            get_logger("ewt.fixture").info("x %s", x)
        """),
    "no-raw-timing": ("samplers/t.py", 3, """\
        import time
        from time import perf_counter

        def f():
            return time.perf_counter(), perf_counter(), time.time()
        """, """\
        from ..utils.profiling import monotonic

        def f():
            return monotonic()
        """),
    "no-raw-kernel-launch": ("samplers/k.py", 5, """\
        import ctypes
        import triton
        from torch.utils.cpp_extension import load
        from ..ops import cuda_lib

        @triton.jit
        def kern(x):
            pass

        def f():
            lib = ctypes.CDLL("x.so")
            ext = load(name="e", sources=["e.cu"])
            cuda_lib.load_library().mega_solve_factor_launch(1, 2)
            return lib, ext
        """, """\
        from ..ops.megakernel import mega_solve

        def f(S, B):
            return mega_solve(S, B)
        """),
    "no-bare-graph": ("flows/g.py", 5, """\
        from functools import partial

        import torch

        def f(fn, x):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                fn(x)
            return torch.compile(fn)

        @torch.jit.script
        def h(x):
            return x

        @partial(torch.compile, mode="max-autotune")
        def k(x):
            return x
        """, """\
        from .coupling import cuda_graphed

        def f(fn, x):
            return cuda_graphed(fn, x)
        """),
    "graph-output-alias": ("flows/a.py", 3, """\
        import torch
        from .coupling import cuda_graphed

        def run(f, xs, x0):
            g = cuda_graphed(f, x0)
            a = g(xs[0])
            b = g(xs[1])
            keep = []
            for x in xs:
                keep.append(g(x))
            return a + b, keep

        def stage(arr, dev):
            buf = torch.empty(arr.shape, device=dev)
            h = torch.from_numpy(arr)
            buf.copy_(h, non_blocking=True)
            arr[0] = 1.0
            return buf
        """, """\
        import torch
        from .coupling import cuda_graphed

        def run(f, xs, x0):
            g = cuda_graphed(f, x0)
            a = g(xs[0]).clone()
            b = g(xs[1])
            s = a + b
            keep = []
            for x in xs:
                keep.append(g(x).clone())
            return s, keep

        def stage(arr, dev):
            buf = torch.empty(arr.shape, device=dev)
            h = torch.from_numpy(arr)
            buf.copy_(h, non_blocking=True)
            torch.cuda.current_stream(dev).synchronize()
            arr[0] = 1.0
            return buf
        """),
    "rng-explicit-generator": ("utils/r.py", 7, """\
        import random

        import numpy as np
        import torch

        def draws(x, gen):
            a = torch.randn(3)
            b = torch.rand_like(x)
            c = torch.randint(0, 5, (3,), generator=gen)
            x.uniform_()
            np.random.seed(0)
            d = np.random.normal(size=3)
            e = random.random()
            torch.manual_seed(1)
            return a, b, c, d, e
        """, """\
        import random

        import numpy as np
        import torch

        def draws(x, gen, seed):
            rng = np.random.default_rng(seed)
            a = torch.randn(3, generator=gen)
            x.uniform_(generator=gen)
            r = random.Random(seed)
            return a, rng.normal(size=3), r.random()
        """),
    "host-sync": ("samplers/h.py", 11, """\
        import numpy as np
        import torch

        def step(x, dev):
            t = torch.zeros(4, device=dev)
            a = t.sum().item()
            b = t.cpu()
            torch.cuda.synchronize()
            idx = torch.nonzero(t)
            w = torch.where(t > 0)
            m = t[t > 0]
            if t.any():
                a = 0.0
            f = float(t.max())
            n = np.asarray(t)
            u = torch.as_tensor(np.ones(3), device=dev)
            e = torch.linalg.eigh(x)
            return a, b, idx, w, m, f, n, u, e
        """, """\
        import numpy as np
        import torch

        def step(x, dev):
            t = torch.zeros(4, device=dev)
            s = t.sum()
            w = torch.where(t > 0, t, -t)
            n = int(t.shape[0])
            if t is None:
                n = 0
            m = t.masked_fill(t > 0, 0.0)
            L, info = torch.linalg.cholesky_ex(x)
            host = np.asarray([1.0, 2.0]).tolist()
            return s, w, n, m, L, info, host
        """),
    "graph-purity": ("flows/p.py", 5, """\
        import logging

        import torch
        from .coupling import cuda_graphed

        LOG = []
        _log = logging.getLogger("ewt.fixture")

        class Model:
            def __init__(self, x):
                self.calls = 0
                self.g = cuda_graphed(self._body, x)

            def _body(self, x):
                self.calls += 1
                LOG.append(1)
                _log.info("captured")
                noise = torch.randn(x.shape)
                open("trace.txt", "w").close()
                return x * 2 + noise
        """, """\
        import torch
        from .coupling import cuda_graphed

        def fit(x):
            def body(y):
                z = y * 2
                out = torch.zeros_like(z)
                out[0] = z[0]
                return out
            return cuda_graphed(body, x)
        """),
    "precision": ("ops/pr.py", 7, """\
        import numpy as np
        import torch
        from .. import F64

        def f(x):
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.set_float32_matmul_precision("high")
            a = x.to(torch.float64)
            b = x.double()
            c = torch.zeros(3, dtype=F64)
            d = np.zeros(3, dtype="float64")
            e = np.float64(1.0)
            return a, b, c, d, e
        """, """\
        import torch

        def f(x):
            return x.to(torch.float32)

        # ewt: allow-precision — fixture: an annotated float64 island
        def island(x):
            return x.double()
        """),
    "collective-safety": ("samplers/c.py", 4, """\
        import torch.distributed as dist
        from ..parallel.distributed import all_gather_rows

        def raw(t):
            dist.all_reduce(t)
            dist.barrier()
            return t

        def gathered(like, x, group):
            lnl = like.loglike_batch(x)
            host = lnl.cpu()
            return all_gather_rows(lnl, group), host

        def outer(like, x, group):
            y = gathered(like, x, group)
            return y[0].tolist()
        """, """\
        from ..parallel.distributed import all_gather_rows

        def gathered(like, x, group):
            return all_gather_rows(like.loglike_batch(x), group)

        def outer(like, x, group):
            return gathered(like, x, group) * 2
        """),
}


@pytest.mark.parametrize("twin", ["seeded", "quiet"])
@pytest.mark.parametrize("rule", sorted(_FIXTURES))
def test_rule_fixtures(tmp_path, rule, twin):
    rel, n_min, pos, neg = _FIXTURES[rule]
    res = _lint(tmp_path, f"{PKG}/{rel}", pos if twin == "seeded" else neg)
    hits = [f for f in res.active if f.rule == rule]
    if twin == "seeded":
        assert len(hits) >= n_min, (
            f"{rule}: {len(hits)} < {n_min}\n"
            + "\n".join(f.format() for f in res.findings))
    else:
        # the disciplined twin is quiet under every rule, not only its own
        assert not res.active, "\n".join(f.format() for f in res.active)


def test_kernel_launches_are_allowed_in_ops(tmp_path):
    rel, _, pos, _ = _FIXTURES["no-raw-kernel-launch"]
    res = _lint(tmp_path, f"{PKG}/ops/k.py", pos)
    assert not [f for f in res.active if f.rule == "no-raw-kernel-launch"]


def test_graph_output_alias_names_the_overwrite(tmp_path):
    rel, _, pos, _ = _FIXTURES["graph-output-alias"]
    res = _lint(tmp_path, f"{PKG}/{rel}", pos, rules=["graph-output-alias"])
    msgs = sorted((f.line, f.message) for f in res.active)
    assert [m[0] for m in msgs] == [10, 11, 11, 17]
    assert "kept in a container" in msgs[0][1]
    assert {m[1].split(" (")[0] for m in msgs[1:3]} == {"'a'", "'b'"}
    assert any("read after the next call at line 7" in m[1]
               for m in msgs[1:3])
    assert any("read after the next call at line 10" in m[1]
               for m in msgs[1:3])
    assert "non_blocking copy (line 16)" in msgs[3][1]


# ------------------------------------------------------------------ #
#  the hot-path predicate is positional                               #
# ------------------------------------------------------------------ #

_CAPTURED_SYNC = """\
    from ..flows.coupling import cuda_graphed

    def f(x):
        def body(y):
            return y.sum().item()
        return x.cpu(), cuda_graphed(body, x)
    """


@pytest.mark.parametrize("where, warnings", [("samplers", 1), ("ops", 1),
                                             ("parallel", 1),
                                             ("results", 0), ("flows", 0)])
def test_hot_path_predicate_is_positional(tmp_path, where, warnings):
    res = _lint(tmp_path, f"{PKG}/{where}/s.py", _CAPTURED_SYNC,
                rules=["host-sync"])
    warn = [f for f in res.active if f.severity == "warning"]
    errs = [f for f in res.active if f.severity == "error"]
    assert len(warn) == warnings, "\n".join(f.format() for f in warn)
    # the captured body's sync is an error anywhere in the package
    assert [f.line for f in errs] == [5]
    assert Module(tmp_path / PKG / where / "s.py",
                  f"{PKG}/{where}/s.py").hot == (warnings == 1)
    assert HOT_PREFIXES == tuple(f"{PKG}/{d}/" for d in ("ops", "samplers",
                                                         "parallel"))


# ------------------------------------------------------------------ #
#  CLI                                                                #
# ------------------------------------------------------------------ #

def _cli(*args, cwd=REPO):
    return subprocess.run([sys.executable, "-m", f"{PKG}.analysis", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_cli_findings_exit_nonzero_and_json(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("print('hello')\n")
    p = _cli(str(bad), "--json")
    assert p.returncode == 1
    doc = json.loads(p.stdout)
    assert doc["counts"]["active"] == 1
    assert doc["findings"][0]["rule"] == "no-print"


def test_cli_clean_exit_zero(tmp_path):
    ok = tmp_path / "ok.py"
    ok.write_text("x = 1\n")
    p = _cli(str(ok))
    assert p.returncode == 0, p.stdout + p.stderr
    assert "0 finding(s)" in p.stdout


def test_cli_rule_filter(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import time\nprint(time.time())\n")
    p = _cli(str(bad), "--rule", "no-raw-timing", "--json")
    doc = json.loads(p.stdout)
    assert {f["rule"] for f in doc["findings"]} == {"no-raw-timing"}
    p = _cli(str(bad), "--rule", "bogus-rule")
    assert p.returncode == 2
    assert "unknown rule" in p.stderr


def test_explicit_target_in_skip_dir_is_linted(tmp_path):
    target = _plant(tmp_path, "fixtures/bad.py", "print('x')\n")
    res = run_lint(paths=[target], root=tmp_path, rules=["no-print"])
    assert [f.rule for f in res.active] == ["no-print"]
    res = run_lint(paths=[tmp_path], root=tmp_path, rules=["no-print"])
    assert res.files_scanned == 0


def test_missing_explicit_target_is_an_error(tmp_path):
    with pytest.raises(ValueError, match="not a .py file"):
        run_lint(paths=[tmp_path / "nope.py"], root=tmp_path)
    p = _cli(str(tmp_path / "nope.py"))
    assert p.returncode == 2
    assert "not a .py file" in p.stderr


def test_cli_list_rules_and_show_suppressed(tmp_path):
    p = _cli("--list-rules")
    assert p.returncode == 0
    for rule in COUNTERPARTS:
        assert rule in p.stdout
    target = _plant(tmp_path, "s.py", _PARITY["line-scope"])
    p = _cli(str(target), "--rule", "no-print", "--show-suppressed")
    assert p.returncode == 1 and "(suppressed)" in p.stdout


def test_cli_package_is_clean_and_a_violation_fails(tmp_path):
    p = _cli("--json")
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr
    doc = json.loads(p.stdout)
    assert doc["counts"]["active"] == 0 and doc["files_scanned"] > 80
    # a copy of the package (its lint with it) with one added violation
    # exits 1
    copy = tmp_path / PKG
    for src in (REPO / PKG).rglob("*.py"):
        if "_build" in src.parts:
            continue
        dst = copy / src.relative_to(REPO / PKG)
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(src.read_text())
    mk = copy / "ops" / "megakernel.py"
    mk.write_text(mk.read_text() + "\n\ndef _added(t):\n"
                  "    return t.item()\n")
    p = _cli("--json", cwd=tmp_path)
    doc = json.loads(p.stdout)
    assert p.returncode == 1
    assert [f["rule"] for f in doc["findings"] if not f["suppressed"]] \
        == ["host-sync"]


# ------------------------------------------------------------------ #
#  pinned sites of the package                                        #
# ------------------------------------------------------------------ #

def _package_modules():
    for path in sorted((REPO / PKG).rglob("*.py")):
        rel = path.relative_to(REPO).as_posix()
        yield Module(path, rel)


def test_safe_eigh_is_a_host_sync_finding():
    path = REPO / PKG / "ops" / "megakernel.py"
    fn = next(n for n in ast.walk(ast.parse(path.read_text()))
              if isinstance(n, ast.FunctionDef) and n.name == "_safe_eigh")
    res = run_lint(paths=[path], root=REPO, rules=["host-sync"])
    hits = [f for f in res.findings
            if fn.lineno <= f.line <= fn.end_lineno
            and "torch.linalg.eigh" in f.message]
    assert len(hits) == 1 and hits[0].suppressed and \
        hits[0].suppress_reason


def test_every_cuda_graphed_target_is_in_the_capture_index():
    seen = []
    for mod in _package_modules():
        cap = mod.captured
        for call in mod.calls:
            f = call.func
            if not (isinstance(f, ast.Name) and f.id == "cuda_graphed"):
                continue
            target = call.args[0]
            name = target.id if isinstance(target, ast.Name) else \
                target.attr
            fns = [n for n in cap.captured_funcs()
                   if getattr(n, "name", None) == name
                   and cap.is_direct(n)]
            assert fns, f"{mod.rel}:{call.lineno}: {name} not captured"
            seen.append((mod.rel, name))
    assert sorted(seen) == [(f"{PKG}/flows/model.py", "_evaluate"),
                            (f"{PKG}/flows/train.py", "loss_grad"),
                            (f"{PKG}/samplers/ptmcmc.py", "prop")]


def test_unsharded_note_is_logged_not_printed(capsys, caplog):
    import numpy as np
    from enterprise_warp_tpu_torch.models import StandardModels, TermList
    from enterprise_warp_tpu_torch.parallel import build_pta_likelihood
    from enterprise_warp_tpu_torch.parallel.distributed import ShardLayout
    from enterprise_warp_tpu_torch.sim import make_fake_pta
    psrs = make_fake_pta(npsr=2, ntoa=20, seed=3)
    rng = np.random.default_rng(3)
    for p in psrs:
        p.residuals = p.toaerrs * rng.standard_normal(len(p))
    tls = []
    for p in psrs:
        m = StandardModels(psr=p)
        tls.append(TermList(p, [m.efac("by_backend"),
                                m.gwb("hd_vary_gamma_4_nfreqs")]))
    with caplog.at_level(logging.INFO, logger="ewt.pta"):
        like = build_pta_likelihood(psrs, tls, gram_mode="f64",
                                    joint_mode="dense", device="cpu",
                                    mesh=ShardLayout(2))
    assert like.mesh is None
    assert "keeps the unsharded joint likelihood" in caplog.text
    assert capsys.readouterr().out == ""


# ------------------------------------------------------------------ #
#  standard library only, and the tier-1 gate                         #
# ------------------------------------------------------------------ #

def test_analysis_imports_only_the_standard_library():
    files = sorted(ANALYSIS.glob("*.py"))
    assert {f.stem for f in files} == {
        "__init__", "__main__", "core", "dataflow", "rules_style",
        "rules_tracer", "rules_collective"}
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    continue        # the analysis package's own modules
                names = [node.module]
            else:
                continue
            bad += [f"{path.name}:{node.lineno}: {n}" for n in names
                    if n.split(".")[0] not in sys.stdlib_module_names]
    assert not bad, bad
    # loaded on its own (not through the package __init__, which imports
    # torch), the engine runs over the package without torch or numpy
    code = textwrap.dedent(f"""\
        import importlib.util, sys
        spec = importlib.util.spec_from_file_location(
            "ewt_analysis", {str(ANALYSIS / "__init__.py")!r},
            submodule_search_locations=[{str(ANALYSIS)!r}])
        mod = importlib.util.module_from_spec(spec)
        sys.modules["ewt_analysis"] = mod
        spec.loader.exec_module(mod)
        res = mod.run_lint()
        bad = [m for m in ("torch", "jax", "numpy") if m in sys.modules]
        print(res.files_scanned, len(res.active), bad)
        sys.exit(1 if bad or res.active else 0)
        """)
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr


def test_port_has_zero_unsuppressed_findings():
    """The port's tier-1 gate: the whole engine over the package reports
    zero unsuppressed findings — every intentional host sync, float64
    island, raw clock and stdout line carries an
    ``# ewt: allow-<rule> — <reason>`` annotation instead."""
    res = run_lint()
    assert res.files_scanned > 80
    assert len(res.rule_names) == 12
    assert not res.active, "\n".join(f.format() for f in res.active)
    assert res.suppressed
    assert all(f.suppress_reason for f in res.suppressed)
