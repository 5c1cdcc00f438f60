"""Shared semantic indexes the port's rules build on: import-alias
resolution, capture-region detection, and a deliberately simple
per-function dataflow (parameter taint and tensor taint).

Everything here is best-effort intra-module analysis: the rules are
written so that *unresolvable* constructs stay silent (no finding)
while the idioms this package actually uses — ``coupling.cuda_graphed``
on a local closure, a method or a module function, ``x = torch.where(
...)`` chains, ``self.state = torch.zeros(...)`` — resolve exactly.
"""

from __future__ import annotations

import ast
import itertools

from .core import PKG_NAME

#: the package's dtype aliases (``enterprise_warp_tpu_torch.F64``)
_PKG_DTYPES = {"F64": "torch.float64", "F32": "torch.float32"}


# ------------------------------------------------------------------ #
#  import aliases                                                    #
# ------------------------------------------------------------------ #


class Aliases:
    """Maps local names to dotted module/function paths.

    ``import torch.distributed as dist`` -> ``dist: torch.distributed``;
    ``import numpy as np`` -> ``np: numpy``;
    ``from ..utils import telemetry`` -> ``telemetry: utils.telemetry``
    (relative imports keep only the suffix — callers match with
    :meth:`resolves`, which is suffix-aware); the package's ``F64`` /
    ``F32`` (``from .. import F64``) -> ``torch.float64`` /
    ``torch.float32``, as is a module-level ``F64 = torch.float64``.
    """

    def __init__(self, tree):
        self.map = {}
        if tree is None:
            return
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.map[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                for a in node.names:
                    if a.name == "*":
                        continue
                    pkg_root = base in ("", PKG_NAME) and (
                        node.level > 0 or base == PKG_NAME)
                    if pkg_root and a.name in _PKG_DTYPES:
                        self.map[a.asname or a.name] = _PKG_DTYPES[a.name]
                        continue
                    self.map[a.asname or a.name] = \
                        f"{base}.{a.name}" if base else a.name
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Attribute):
                d = self.dotted(node.value)
                if d is not None and d.startswith("torch."):
                    self.map[node.targets[0].id] = d

    def dotted(self, node):
        """The dotted path of a Name/Attribute chain with the root
        alias substituted, e.g. ``dist.all_reduce`` ->
        ``torch.distributed.all_reduce``, ``self._block`` ->
        ``self._block``. None when the chain roots in a call/subscript."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(self.map.get(node.id, node.id))
        return ".".join(reversed(parts))

    def resolves(self, node, *paths, suffixes=()):
        """True when ``node``'s dotted path equals one of ``paths`` or
        ends with one of ``suffixes`` (suffix matching handles
        relative imports: ``flows.coupling.cuda_graphed`` matches
        suffix ``coupling.cuda_graphed``)."""
        d = self.dotted(node)
        if d is None:
            return False
        if d in paths:
            return True
        return any(d == s or d.endswith("." + s) for s in suffixes)


# ------------------------------------------------------------------ #
#  capture-region detection                                          #
# ------------------------------------------------------------------ #

#: callables whose first argument is captured as a CUDA graph
_CAPTURE_ENTRY_SUFFIXES = ("coupling.cuda_graphed",
                           "torch.cuda.make_graphed_callables")
_CAPTURE_ENTRY_BARE = ("cuda_graphed",)
#: context managers whose body runs under stream capture
_CAPTURE_CONTEXTS = ("torch.cuda.graph",)


def is_capture_entry(aliases, func):
    d = aliases.dotted(func)
    if d is None:
        return False
    if d in _CAPTURE_ENTRY_BARE:
        return True
    return any(d == s or d.endswith("." + s)
               for s in _CAPTURE_ENTRY_SUFFIXES)


def _is_capture_context(aliases, item):
    e = item.context_expr
    return isinstance(e, ast.Call) and aliases.resolves(
        e.func, *_CAPTURE_CONTEXTS)


_FUNC_KINDS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def enclosing(parents, node, kinds):
    """The nearest ancestor of ``node`` of one of ``kinds``, or None."""
    p = parents.get(id(node))
    while p is not None and not isinstance(p, kinds):
        p = parents.get(id(p))
    return p


class CaptureIndex:
    """Which code runs under CUDA graph capture.

    Captured are (a) a function handed to ``cuda_graphed`` (or
    ``torch.cuda.make_graphed_callables``) by name — a module function
    or a local closure — as ``self.<method>`` (a method of the class
    that makes the call), or as a lambda; (b) the statements inside a
    ``with torch.cuda.graph(...)`` block; (c) functions lexically nested
    in captured ones; (d) functions called from captured code, by name
    or as ``self.<method>`` — iterated to a fixpoint. The functions of
    (a) are *direct*: their parameters are the graph's static input
    tensors.
    """

    def __init__(self, tree, aliases, parents=None, nodes=None):
        self.aliases = aliases
        self.funcs = []           # all FunctionDef/Lambda nodes
        self.captured = set()     # id(node) of captured functions
        self.direct = set()       # handed to a capture entry directly
        self.regions = []         # (lo, hi, [stmt]) of graph-with bodies
        self.ranges = []
        self._nodes_by_id = {}
        if tree is None:
            return
        nodes = list(ast.walk(tree)) if nodes is None else nodes
        if parents is None:
            parents = {}
            for parent in nodes:
                for child in ast.iter_child_nodes(parent):
                    parents[id(child)] = parent
        entries = [n for n in nodes if isinstance(n, ast.Call) and n.args
                   and is_capture_entry(aliases, n.func)]
        withs = [n for n in nodes if isinstance(n, (ast.With, ast.AsyncWith))
                 and any(_is_capture_context(aliases, i) for i in n.items)]
        if not entries and not withs:
            return
        by_name = {}
        methods = {}              # id(class) -> {name: [FunctionDef]}
        for node in nodes:
            if isinstance(node, _FUNC_KINDS):
                self.funcs.append(node)
                self._nodes_by_id[id(node)] = node
                if isinstance(node, ast.Lambda):
                    continue
                cls = parents.get(id(node))
                if isinstance(cls, ast.ClassDef):
                    methods.setdefault(id(cls), {}).setdefault(
                        node.name, []).append(node)
                else:
                    by_name.setdefault(node.name, []).append(node)

        def targets(expr, site):
            """Functions an expression passed to / called at ``site``
            names: a local/module function, ``self.<method>`` of the
            enclosing class, or a lambda."""
            if isinstance(expr, ast.Lambda):
                return [expr]
            if isinstance(expr, ast.Name):
                return list(by_name.get(expr.id, []))
            if isinstance(expr, ast.Attribute) and \
                    isinstance(expr.value, ast.Name) and \
                    expr.value.id in ("self", "cls"):
                cls = enclosing(parents, site, ast.ClassDef)
                if cls is not None:
                    return list(methods.get(id(cls), {}).get(
                        expr.attr, []))
            return []

        def callees(roots):
            out = []
            for root in roots:
                for call in ast.walk(root):
                    if isinstance(call, ast.Call):
                        out.extend(targets(call.func, call))
            return out

        # (a) handed to a capture entry
        todo = []
        for call in entries:
            for fn in targets(call.args[0], call):
                self.direct.add(id(fn))
                todo.append(fn)
        # (b) graph-capture with blocks, and what their bodies call
        for node in withs:
            lo = node.body[0].lineno
            hi = max(s.end_lineno or s.lineno for s in node.body)
            self.regions.append((lo, hi, list(node.body)))
            todo.extend(callees(node.body))
        # (c) lexical nesting + (d) called from captured code, to fixpoint
        children = {}
        for fn in self.funcs:
            enc = enclosing(parents, fn, _FUNC_KINDS)
            if enc is not None:
                children.setdefault(id(enc), []).append(fn)
        while todo:
            fn = todo.pop()
            if id(fn) in self.captured:
                continue
            self.captured.add(id(fn))
            todo.extend(children.get(id(fn), []))
            todo.extend(callees([fn]))

        self.ranges = sorted(
            [(n.lineno, n.end_lineno or n.lineno)
             for n in self.funcs if id(n) in self.captured]
            + [(lo, hi) for lo, hi, _b in self.regions])

    def is_captured(self, node):
        return id(node) in self.captured

    def is_direct(self, node):
        return id(node) in self.direct

    def captured_funcs(self):
        return [self._nodes_by_id[i] for i in self.captured]

    def line_in_captured(self, line):
        return any(lo <= line <= hi for lo, hi in self.ranges)


# ------------------------------------------------------------------ #
#  per-function helpers                                              #
# ------------------------------------------------------------------ #


def param_names(fn):
    a = fn.args
    names = [p.arg for p in itertools.chain(
        a.posonlyargs, a.args, a.kwonlyargs)]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return set(names)


def local_names(fn):
    """Every name the function binds: params plus any Store target
    (needed to tell closure mutation from local mutation)."""
    names = set(param_names(fn))
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx,
                                                     ast.Store):
            names.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node is not fn:
            names.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        elif isinstance(node, (ast.Global, ast.Nonlocal)):
            names -= set(node.names)
    return names


#: attributes and calls whose value is host metadata of a tensor, never
#: a device value: reading them does not synchronise
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda",
                 "requires_grad", "layout", "names", "grad_fn",
                 "is_leaf", "T", "mT"}
_STATIC_CALLS = {"len", "isinstance", "hasattr", "getattr", "type",
                 "id", "callable"}
_STATIC_METHODS = {"size", "dim", "numel", "nelement", "element_size",
                   "stride", "data_ptr", "is_contiguous", "get_device",
                   "is_floating_point", "storage_offset"}


def _static_ids(expr):
    """ids() of Name nodes inside ``expr`` whose use reads no device
    value — under ``x.shape``/``x.ndim``/``x.dtype``/``x.size()``,
    inside ``len(x)``/``isinstance(x, ...)``, or compared against a
    string constant or by identity (a mode selector, ``x is None``)."""
    static = set()
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and \
                node.attr in _STATIC_ATTRS:
            for n in ast.walk(node.value):
                static.add(id(n))
        elif isinstance(node, ast.Call):
            f = node.func
            fname = f.id if isinstance(f, ast.Name) else None
            if fname in _STATIC_CALLS:
                for a in node.args:
                    for n in ast.walk(a):
                        static.add(id(n))
            elif isinstance(f, ast.Attribute) and \
                    f.attr in _STATIC_METHODS:
                for n in ast.walk(f.value):
                    static.add(id(n))
        elif isinstance(node, ast.Compare):
            comparators = [node.left] + list(node.comparators)
            if any(isinstance(c, ast.Constant)
                   and isinstance(c.value, str)
                   for c in comparators) or all(
                    isinstance(op, (ast.Is, ast.IsNot))
                    for op in node.ops):
                for c in comparators:
                    for n in ast.walk(c):
                        static.add(id(n))
    return static


def tainted_uses(expr, taint):
    """Tainted Name nodes inside ``expr``, excluding uses that read
    only host metadata (see :func:`_static_ids`)."""
    static = _static_ids(expr)
    return [n for n in ast.walk(expr)
            if isinstance(n, ast.Name) and n.id in taint
            and id(n) not in static]


def tainted_names(fn, seed=None, include_params=True):
    """Names (transitively) derived from the function's parameters —
    in a captured body these hold the graph's tensors. A linear walk
    with the loop bodies visited twice (cheap cross-iteration
    propagation). ``include_params=False`` seeds only from ``seed``
    (for call-propagated functions whose params may be host config).
    Values reached only through ``.shape``/``len()`` do not taint."""
    taint = set(seed or ())
    if include_params:
        taint |= param_names(fn)
    _propagate(fn, taint, lambda e: bool(tainted_uses(e, taint)))
    return taint


def _propagate(fn, taint, expr_tainted):
    """Add to ``taint`` every Name an assignment in ``fn`` binds from
    an expression ``expr_tainted`` accepts (loops visited twice)."""

    def bind(target):
        # the names a target binds: not those read inside a subscript
        # or attribute target (``hist[i % n] = x`` binds nothing)
        if isinstance(target, ast.Name):
            taint.add(target.id)
        elif isinstance(target, ast.Starred):
            bind(target.value)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                bind(el)

    def visit(stmts):
        for st in stmts:
            if isinstance(st, (ast.Assign, ast.AugAssign,
                               ast.AnnAssign)):
                value = st.value
                if value is not None and expr_tainted(value):
                    targets = st.targets if isinstance(st, ast.Assign) \
                        else [st.target]
                    for t in targets:
                        bind(t)
            elif isinstance(st, (ast.For, ast.While)):
                if isinstance(st, ast.For) and expr_tainted(st.iter):
                    bind(st.target)
                visit(st.body)
                visit(st.body)      # second pass: loop-carried taint
                visit(st.orelse)
            elif isinstance(st, ast.If):
                visit(st.body)
                visit(st.orelse)
            elif isinstance(st, (ast.With, ast.AsyncWith)):
                visit(st.body)
            elif isinstance(st, ast.Try):
                visit(st.body)
                for h in st.handlers:
                    visit(h.body)
                visit(st.orelse)
                visit(st.finalbody)
    if isinstance(fn.body, list):       # Lambda bodies are a bare expr
        visit(fn.body)


# ------------------------------------------------------------------ #
#  tensor taint                                                      #
# ------------------------------------------------------------------ #

#: ``torch.<name>`` calls that return no tensor
_TORCH_NON_TENSOR = {
    "device", "Generator", "Size", "finfo", "iinfo", "is_tensor",
    "is_floating_point", "is_complex", "get_default_dtype", "no_grad",
    "enable_grad", "inference_mode", "set_grad_enabled", "numel",
    "manual_seed", "seed", "initial_seed", "get_rng_state", "dtype",
    "is_grad_enabled", "broadcast_shapes", "promote_types",
    "result_type", "can_cast", "equal", "allclose", "is_nonzero",
    "set_float32_matmul_precision", "get_float32_matmul_precision",
    "use_deterministic_algorithms", "set_num_threads", "get_num_threads",
}
#: ``torch.<sub>.`` namespaces whose calls return no tensor
_TORCH_NON_TENSOR_NS = ("torch.cuda.", "torch.backends.",
                        "torch.distributed.", "torch.utils.",
                        "torch.profiler.", "torch.autograd.profiler.",
                        "torch.jit.", "torch.testing.")
#: tensor methods whose result lives on the host (or is no tensor)
_HOST_METHODS = {"item", "tolist", "numpy", "cpu", "size", "dim",
                 "numel", "nelement", "element_size", "stride",
                 "data_ptr", "is_contiguous", "get_device",
                 "is_floating_point", "storage_offset", "__len__",
                 "synchronize", "record", "query", "elapsed_time"}


class TensorTaint:
    """Which expressions of a module hold device tensors, best effort:
    the results of ``torch.*`` calls, the names and ``self.<attr>``
    bindings assigned from them, and what arithmetic, indexing and
    tensor methods derive from those. ``.item()``/``.tolist()``/
    ``.cpu()``/``.numpy()``/``float()`` and the metadata reads
    (``.shape``, ``.dtype``, ``.size()``) end the taint."""

    def __init__(self, tree, aliases, nodes=None):
        self.aliases = aliases
        self.attrs = set()        # "self.x" dotted bindings
        self._fn_taint = {}
        if tree is None:
            return
        assigns = [n for n in (ast.walk(tree) if nodes is None else nodes)
                   if isinstance(n, (ast.Assign, ast.AnnAssign))
                   and n.value is not None and any(
                       _attr_dotted(el) is not None
                       for t in (n.targets if isinstance(n, ast.Assign)
                                 else [n.target])
                       for el in (t.elts if isinstance(
                           t, (ast.Tuple, ast.List)) else [t]))]
        # module-wide attribute taint, to a fixpoint over the module
        for _ in range(3):
            n0 = len(self.attrs)
            for node in assigns:
                if not self.is_tensor(node.value, set()):
                    continue
                for t in (node.targets if isinstance(node, ast.Assign)
                          else [node.target]):
                    for el in (t.elts if isinstance(
                            t, (ast.Tuple, ast.List)) else [t]):
                        d = _attr_dotted(el)
                        if d is not None:
                            self.attrs.add(d)
            if len(self.attrs) == n0:
                break

    def names_in(self, fn):
        """Local names of ``fn`` bound to tensors."""
        key = id(fn)
        if key not in self._fn_taint:
            taint = set()
            _propagate(fn, taint, lambda e: self.is_tensor(e, taint))
            self._fn_taint[key] = taint
        return self._fn_taint[key]

    def is_tensor(self, expr, names):
        """True when ``expr`` provably evaluates to a tensor."""
        al = self.aliases
        if isinstance(expr, ast.Name):
            return expr.id in names
        if isinstance(expr, ast.Attribute):
            if expr.attr in _STATIC_ATTRS:
                return False
            d = _attr_dotted(expr)
            if d is not None and d in self.attrs:
                return True
            return False
        if isinstance(expr, ast.Subscript):
            return self.is_tensor(expr.value, names)
        if isinstance(expr, ast.BinOp):
            return self.is_tensor(expr.left, names) or \
                self.is_tensor(expr.right, names)
        if isinstance(expr, ast.UnaryOp):
            return self.is_tensor(expr.operand, names)
        if isinstance(expr, ast.Compare):
            return not all(isinstance(op, (ast.Is, ast.IsNot, ast.In,
                                           ast.NotIn))
                           for op in expr.ops) and any(
                self.is_tensor(c, names)
                for c in [expr.left] + list(expr.comparators))
        if isinstance(expr, ast.IfExp):
            return self.is_tensor(expr.body, names) and \
                self.is_tensor(expr.orelse, names)
        if isinstance(expr, ast.Call):
            f = expr.func
            d = al.dotted(f)
            if d is not None and d.startswith("torch."):
                tail = d.rsplit(".", 1)[-1]
                return tail not in _TORCH_NON_TENSOR and not any(
                    d.startswith(ns) for ns in _TORCH_NON_TENSOR_NS)
            if isinstance(f, ast.Attribute):
                if f.attr in _HOST_METHODS:
                    return False
                if f.attr == "to" and to_cpu(expr):
                    return False
                return self.is_tensor(f.value, names)
        return False


def to_cpu(call):
    """``x.to("cpu")`` / ``x.to(device="cpu")`` /
    ``x.to(torch.device("cpu"))``."""
    cands = list(call.args) + [k.value for k in call.keywords
                               if k.arg == "device"]
    for c in cands:
        if isinstance(c, ast.Constant) and c.value == "cpu":
            return True
        if isinstance(c, ast.Call) and c.args and \
                isinstance(c.args[0], ast.Constant) and \
                c.args[0].value == "cpu" and \
                getattr(c.func, "attr", getattr(c.func, "id", None)) \
                == "device":
            return True
    return False


def _attr_dotted(t):
    """``self.x`` (an attribute of a Name, one level) or None."""
    if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
            and t.value.id in ("self", "cls"):
        return f"{t.value.id}.{t.attr}"
    return None


def target_dotted(t):
    parts = []
    while isinstance(t, ast.Attribute):
        parts.append(t.attr)
        t = t.value
    if isinstance(t, ast.Name):
        parts.append(t.id)
        return ".".join(reversed(parts))
    return None


def assignments_in(fn_or_body):
    """Linear (lineno-ordered) list of ``(target_dotted, value_node,
    lineno)`` for simple assignments — the reaching-definition table
    the alias rule uses. Attribute targets keep their dotted path
    (``st.x``)."""
    body = fn_or_body.body if hasattr(fn_or_body, "body") \
        else fn_or_body
    if isinstance(body, ast.expr):
        return []    # lambda body: an expression holds no assignments
    out = []
    for node in ast.walk(ast.Module(body=list(body),
                                    type_ignores=[])):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                d = target_dotted(t)
                if d is not None:
                    out.append((d, node.value, node.lineno))
                elif isinstance(t, (ast.Tuple, ast.List)):
                    for el in t.elts:
                        el = el.value if isinstance(el, ast.Starred) \
                            else el
                        dd = target_dotted(el)
                        if dd is not None:
                            out.append((dd, node.value, node.lineno))
    out.sort(key=lambda x: x[2])
    return out
