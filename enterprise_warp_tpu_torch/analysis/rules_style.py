"""The four textual bans of the reference's lint, in the port's terms:
``print``, raw timing, a raw kernel launch, a bare graph or compile.

As AST rules they do not fire on comments or docstrings, they see
through import aliases (``from torch.utils.cpp_extension import
load``), and they share the engine's suppression/audit machinery with
the capture rules.
"""

from __future__ import annotations

import ast
import re

from .core import PKG_NAME, Rule, register
from .dataflow import enclosing


def _decorators(mod):
    """``(decorator_node, target_expr)`` for every decorator:
    ``target_expr`` is the callable being applied — the decorator
    itself for ``@triton.jit``, the first ``partial`` argument for
    ``@partial(torch.compile, ...)``. Call-form decorators
    (``@torch.compile(mode=...)``) are omitted: they already surface
    through ``mod.calls``."""
    for node in mod.nodes:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for dec in node.decorator_list:
            if isinstance(dec, (ast.Name, ast.Attribute)):
                yield dec, dec
            elif isinstance(dec, ast.Call) and mod.aliases.resolves(
                    dec.func, "functools.partial",
                    suffixes=("partial",)) and dec.args:
                yield dec, dec.args[0]


@register
class NoPrintRule(Rule):
    name = "no-print"
    severity = "error"
    summary = "print() in library code — log or emit telemetry"
    contract = (
        "Library output goes through utils.logging.get_logger or the "
        "telemetry event stream. The user-facing CLI layers (cli.py, "
        "serve/cli.py) and the bench/ scripts own stdout through a "
        "reasoned module-scope suppression each, as the reference's "
        "CLI layers and tools own it (reference rule: no-print).")

    def check(self, mod):
        for call in mod.calls:
            if isinstance(call.func, ast.Name) and \
                    call.func.id == "print":
                yield self.finding(
                    mod, call,
                    "print() in library code — use "
                    "utils.logging.get_logger or a telemetry event")


@register
class NoBareGraphRule(Rule):
    name = "no-bare-graph"
    severity = "error"
    summary = "CUDA graph capture outside coupling.cuda_graphed, or " \
              "torch.compile / torch.jit"
    contract = (
        "Every CUDA graph of the port is made by flows/coupling.py:"
        "cuda_graphed — static input buffers, a side-stream warm-up, "
        "the capture-index the graph rules check — so a raw "
        "torch.cuda.graph/CUDAGraph/make_graphed_callables elsewhere "
        "is a capture no rule sees. torch.compile and torch.jit are "
        "banned outright: every kernel of the port is written by hand "
        "(reference rule: no-bare-jit).")

    ALLOWED_AT = (f"{PKG_NAME}/flows/coupling.py", "cuda_graphed")
    _GRAPH = ("torch.cuda.graph", "torch.cuda.CUDAGraph",
              "torch.cuda.make_graphed_callables")
    _COMPILE = ("torch.compile", "torch.jit.script", "torch.jit.trace")

    def _graph_allowed(self, mod, node):
        path, fn = self.ALLOWED_AT
        enc = enclosing(mod.parents, node,
                        (ast.FunctionDef, ast.AsyncFunctionDef))
        return mod.rel == path and enc is not None and enc.name == fn

    def check(self, mod):
        al = mod.aliases
        for call in mod.calls:
            if al.resolves(call.func, *self._COMPILE):
                yield self.finding(
                    mod, call,
                    f"{al.dotted(call.func)}() — the port's kernels are "
                    "hand-written; no compiled or scripted graphs")
            elif al.resolves(call.func, *self._GRAPH) and \
                    not self._graph_allowed(mod, call):
                yield self.finding(
                    mod, call,
                    f"{al.dotted(call.func)}() outside "
                    "flows/coupling.py:cuda_graphed — capture through "
                    "cuda_graphed so the graph rules see the body")
        for dec, target in _decorators(mod):
            if al.resolves(target, *self._COMPILE):
                yield self.finding(
                    mod, dec,
                    f"@{al.dotted(target)} decorator — the port's "
                    "kernels are hand-written; no compiled or scripted "
                    "graphs")


@register
class NoRawKernelLaunchRule(Rule):
    name = "no-raw-kernel-launch"
    severity = "error"
    summary = "kernel library loaded or launched outside ops/"
    contract = (
        "Every hand-written kernel lives behind the ops/ wrappers "
        "(cuda_lib's build and typed binding, the route decision, the "
        "launch counters the smoke reads, the plain version on CPU "
        "tensors). A ctypes load, a cpp_extension build, a triton.jit "
        "kernel or a call of a launch symbol elsewhere is a launch the "
        "counters miss and the route cannot demote (reference rule: "
        "no-raw-pallas-call).")

    ALLOWED = (f"{PKG_NAME}/ops/",)
    _LOADERS = ("ctypes.CDLL", "ctypes.PyDLL", "ctypes.cdll.LoadLibrary",
                "triton.jit", "triton.autotune")
    _LOADER_SUFFIXES = ("cuda_lib.load_library",)
    _LAUNCH = re.compile(r"^(mega|chol)_\w*launch$")

    def _raw(self, al, func):
        if al.resolves(func, *self._LOADERS,
                       suffixes=self._LOADER_SUFFIXES):
            return True
        d = al.dotted(func) or ""
        if d.startswith("torch.utils.cpp_extension.") and \
                "load" in d.rsplit(".", 1)[-1]:
            return True
        return isinstance(func, ast.Attribute) and \
            bool(self._LAUNCH.match(func.attr))

    def check(self, mod):
        if mod.rel.startswith(self.ALLOWED):
            return
        al = mod.aliases
        for call in mod.calls:
            if self._raw(al, call.func):
                name = al.dotted(call.func) or call.func.attr
                yield self.finding(
                    mod, call,
                    f"raw {name}() outside ops/ — route kernels through "
                    "the ops/ wrappers (build, route, launch counts)")
        for dec, target in _decorators(mod):
            if al.resolves(target, "triton.jit", "triton.autotune"):
                yield self.finding(
                    mod, dec,
                    f"@{al.dotted(target)} kernel outside ops/ — kernels "
                    "live behind the ops/ wrappers")


@register
class NoRawTimingRule(Rule):
    name = "no-raw-timing"
    severity = "error"
    summary = "raw time.perf_counter()/time.time() — use the " \
              "profiling clocks"
    contract = (
        "Ad-hoc timing is invisible to the span histograms and the "
        "Chrome-trace export; everything outside utils/telemetry.py "
        "and utils/profiling.py routes through profiling.monotonic/"
        "walltime/span/timeit. The bench/ harnesses carry a reasoned "
        "module suppression: their timing IS their output (reference "
        "rule: no-raw-timing).")

    ALLOWED = (f"{PKG_NAME}/utils/telemetry.py",
               f"{PKG_NAME}/utils/profiling.py")
    _BANNED = ("time.perf_counter", "time.time", "time.perf_counter_ns",
               "time.monotonic", "time.monotonic_ns")

    def check(self, mod):
        if mod.rel.startswith(self.ALLOWED):
            return
        for call in mod.calls:
            if mod.aliases.resolves(call.func, *self._BANNED):
                yield self.finding(
                    mod, call,
                    f"raw {mod.aliases.dotted(call.func)}() — use "
                    "utils.profiling.monotonic/walltime/span/timeit so "
                    "timing feeds the span histograms and trace export")
