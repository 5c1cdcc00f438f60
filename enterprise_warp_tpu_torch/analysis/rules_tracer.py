"""The port's contract rules, counterparts of the reference's tracer
rules: graph-output aliasing, explicit RNG streams, host-sync
discipline, purity of captured bodies, and the precision contract.

A CUDA graph plays the part of a jit trace here: a captured body runs
once at capture and its kernels replay, so a host read there fails the
capture or freezes a value, a side effect happens once, and the
graph's outputs are static buffers the next replay overwrites — the
port's form of a donated buffer. The file keeps the reference's name
(``rules_tracer.py``) so each rule's counterpart is easy to find.
"""

from __future__ import annotations

import ast

from .core import PKG_NAME, Rule, register
from . import dataflow

_FUNC_KINDS = dataflow._FUNC_KINDS


def _enclosing_func(parents, node):
    return dataflow.enclosing(parents, node, _FUNC_KINDS)


def _enclosing_stmt(parents, node):
    """The statement that contains ``node``."""
    prev = node
    p = parents.get(id(node))
    while p is not None and not isinstance(p, ast.stmt):
        prev, p = p, parents.get(id(p))
    return p if isinstance(p, ast.stmt) else prev


def _scope_nodes(scope):
    """Every node of ``scope`` (a module or a function) outside its
    nested function bodies (those are scopes of their own)."""
    stack = list(ast.iter_child_nodes(scope)) if not isinstance(
        scope, ast.Lambda) else [scope.body]
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, _FUNC_KINDS):
            # the defaults and decorators run in this scope; the body
            # does not
            stack.extend(node.args.defaults)
            stack.extend(d for d in node.args.kw_defaults if d is not None)
            stack.extend(getattr(node, "decorator_list", []))
            continue
        stack.extend(ast.iter_child_nodes(node))


def _scopes(mod):
    yield mod.tree
    for node in mod.nodes:
        if isinstance(node, _FUNC_KINDS):
            yield node


class _Scopes:
    """Per-scope tensor names: what the module's tensor taint binds in
    the scope, what its enclosing scopes bind (closures), and — for a
    function handed to a capture entry — its parameters (the graph's
    static input tensors) and what derives from them."""

    def __init__(self, mod):
        self.mod = mod
        self.taint = dataflow.TensorTaint(mod.tree, mod.aliases,
                                          nodes=mod.nodes)
        self._names = {}

    def names(self, scope):
        key = id(scope)
        if key in self._names:
            return self._names[key]
        cap = self.mod.captured
        names = set(self.taint.names_in(scope))
        if isinstance(scope, _FUNC_KINDS):
            enc = _enclosing_func(self.mod.parents, scope)
            outer = self.names(enc) if enc is not None else \
                self.names(self.mod.tree)
            own = dataflow.local_names(scope) if not isinstance(
                scope, ast.Lambda) else dataflow.param_names(scope)
            names |= {n for n in outer if n not in own}
            if cap.is_direct(scope):
                names |= dataflow.tainted_names(scope)
                if not isinstance(scope, ast.Lambda):
                    _grow(scope, names, self.taint)
        self._names[key] = names
        return names

    def is_tensor(self, expr, scope):
        return self.taint.is_tensor(expr, self.names(scope))


def _grow(fn, names, taint):
    """Extend ``names`` by what tensor expressions over them bind."""
    dataflow._propagate(fn, names, lambda e: taint.is_tensor(e, names))


# ------------------------------------------------------------------ #
#  the host-sync constructs (shared by host-sync, collective-safety)  #
# ------------------------------------------------------------------ #

#: tensor methods that read device memory back to the host, or wait
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
#: tensor methods whose output size depends on the data
_DATA_SHAPE_METHODS = {"nonzero", "argwhere", "unique",
                       "unique_consecutive", "masked_select"}
#: torch functions that synchronise: data-dependent output shapes,
#: and the factorizations that check their info codes on the host
_SYNC_CALLS = ("torch.cuda.synchronize", "torch.nonzero",
               "torch.argwhere", "torch.unique",
               "torch.unique_consecutive", "torch.masked_select",
               "torch.linalg.cholesky", "torch.linalg.inv",
               "torch.linalg.solve", "torch.linalg.eigh",
               "torch.linalg.eigvalsh", "torch.cholesky",
               "torch.inverse", "torch.equal", "torch.allclose",
               "torch.is_nonzero")
#: torch constructors that make a host tensor unless given a device
_HOST_FACTORIES = {"empty", "zeros", "ones", "full", "arange", "tensor",
                   "as_tensor", "from_numpy"}
#: constructors that copy host data onto their ``device=``
_UPLOADS = ("torch.as_tensor", "torch.tensor", "torch.asarray")
_CAST_BUILTINS = {"float", "int", "bool", "complex"}
_CONVERTERS = ("numpy.asarray", "numpy.array", "numpy.ascontiguousarray")
#: calls and methods whose result is a boolean tensor
_BOOL_FUNCS = {"isfinite", "isnan", "isinf", "isneginf", "isposinf",
               "logical_and", "logical_or", "logical_not", "logical_xor",
               "signbit", "eq", "ne", "lt", "le", "gt", "ge", "bool",
               "isclose"}


def _non_blocking(call):
    return any(k.arg == "non_blocking" and isinstance(k.value, ast.Constant)
               and k.value.value is True for k in call.keywords)


class SyncScanner:
    """Finds the host-sync constructs of one module, scope by scope."""

    def __init__(self, mod):
        self.mod = mod
        self.scopes = _Scopes(mod)

    def _bool_tensor(self, expr, scope, masks):
        if isinstance(expr, ast.Name):
            return expr.id in masks
        if isinstance(expr, ast.Compare):
            return self.scopes.is_tensor(expr, scope)
        if isinstance(expr, ast.UnaryOp) and \
                isinstance(expr.op, ast.Invert):
            return self._bool_tensor(expr.operand, scope, masks)
        if isinstance(expr, ast.BinOp) and isinstance(
                expr.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self._bool_tensor(expr.left, scope, masks) or \
                self._bool_tensor(expr.right, scope, masks)
        if isinstance(expr, ast.Call):
            f = expr.func
            tail = f.attr if isinstance(f, ast.Attribute) else None
            if tail in _BOOL_FUNCS:
                return self.scopes.is_tensor(expr, scope)
        return False

    def _masks(self, scope):
        masks = set()
        if isinstance(scope.body, list):
            dataflow._propagate(
                scope, masks,
                lambda e: self._bool_tensor(e, scope, masks))
        return masks

    def _on_host(self, expr, host):
        """``expr`` provably lives on the host: a numpy value (a
        ``numpy.*`` call, an ``.astype()``, a name bound from one), a
        generator's ``get_state()``, or a torch constructor given no
        ``device=``."""
        al = self.mod.aliases
        while isinstance(expr, ast.Subscript):
            expr = expr.value
        if isinstance(expr, ast.Name):
            return expr.id in host
        if not isinstance(expr, ast.Call):
            return False
        f = expr.func
        d = al.dotted(f) or ""
        if d.startswith("numpy."):
            return True
        if isinstance(f, ast.Attribute) and f.attr in ("astype",
                                                       "get_state"):
            return True
        return d.startswith("torch.") and not any(
            k.arg == "device" for k in expr.keywords) and \
            d.rsplit(".", 1)[-1] in _HOST_FACTORIES

    def _host_names(self, scope):
        host = set()
        if isinstance(getattr(scope, "body", None), list):
            dataflow._propagate(scope, host,
                                lambda e: self._on_host(e, host))
        return host

    def _uploads(self, call, scope):
        """``torch.as_tensor(host_data, device=d)`` with ``d`` not the
        CPU: the data is no tensor, so it is copied from the host."""
        dev = [k.value for k in call.keywords if k.arg == "device"]
        if not dev or not call.args:
            return False
        if isinstance(dev[0], ast.Constant) and dev[0].value in (None,
                                                                 "cpu"):
            return False
        return not self.scopes.is_tensor(call.args[0], scope)

    def _truthy(self, test, scope):
        """``test`` asks a tensor for its truth value."""
        if isinstance(test, ast.BoolOp):
            return any(self._truthy(v, scope) for v in test.values)
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return self._truthy(test.operand, scope)
        return self.scopes.is_tensor(test, scope)

    def hits(self, scope):
        """``(node, message)`` for each sync construct in ``scope``
        (outside its nested functions)."""
        al = self.mod.aliases
        masks = host = None
        for node in _scope_nodes(scope):
            if isinstance(node, ast.Call):
                f = node.func
                d = al.dotted(f)
                if isinstance(f, ast.Attribute) and \
                        f.attr in _SYNC_METHODS and \
                        not al.resolves(f, *_SYNC_CALLS):
                    if host is None:
                        host = self._host_names(scope)
                    if not self._on_host(f.value, host):
                        yield node, (f".{f.attr}() waits for the device "
                                     "(a device->host read or a sync)")
                elif isinstance(f, ast.Attribute) and \
                        f.attr in _DATA_SHAPE_METHODS and \
                        d not in ("numpy." + f.attr,) and \
                        self.scopes.is_tensor(f.value, scope):
                    yield node, (f".{f.attr}() has a data-dependent "
                                 "output size: the host reads it")
                elif d is not None and d in _SYNC_CALLS:
                    yield node, f"{d}() synchronises with the host"
                elif d == "torch.where" and len(node.args) == 1 and \
                        not node.keywords:
                    yield node, ("one-argument torch.where() is "
                                 "nonzero(): a data-dependent size")
                elif (d == "torch.repeat_interleave" or (
                        isinstance(f, ast.Attribute)
                        and f.attr == "repeat_interleave"
                        and self.scopes.is_tensor(f.value, scope))) \
                        and not any(k.arg == "output_size"
                                    for k in node.keywords):
                    reps = node.args[1] if d == "torch.repeat_interleave" \
                        and len(node.args) > 1 else (
                            node.args[0] if d != "torch.repeat_interleave"
                            and node.args else None)
                    if reps is None or not (
                            isinstance(reps, ast.Constant)
                            and isinstance(reps.value, int)):
                        yield node, ("repeat_interleave() without "
                                     "output_size reads the repeats' "
                                     "sum on the host")
                elif isinstance(f, ast.Attribute) and f.attr == "to" \
                        and dataflow.to_cpu(node):
                    yield node, ".to('cpu') is a device->host copy"
                elif d in _UPLOADS and self._uploads(node, scope):
                    yield node, (f"{d}() of host data onto a device is a "
                                 "synchronous upload from pageable memory")
                elif isinstance(f, ast.Attribute) and \
                        f.attr in ("to", "cuda") and \
                        isinstance(f.value, ast.Call) and \
                        al.resolves(f.value.func, "torch.from_numpy") and \
                        not _non_blocking(node):
                    yield node, (f".{f.attr}() of a host tensor is a "
                                 "synchronous upload from pageable memory")
                elif isinstance(f, ast.Name) and \
                        f.id in _CAST_BUILTINS and node.args and \
                        self.scopes.is_tensor(node.args[0], scope):
                    yield node, (f"{f.id}() of a tensor reads it back "
                                 "to the host")
                elif al.resolves(f, *_CONVERTERS) and node.args and \
                        self.scopes.is_tensor(node.args[0], scope):
                    yield node, (f"{d}() of a tensor is a device->host "
                                 "copy")
            elif isinstance(node, (ast.If, ast.While, ast.IfExp,
                                   ast.Assert)):
                if self._truthy(node.test, scope):
                    yield node.test, ("branch on a tensor's truth value: "
                                      "a device->host read")
            elif isinstance(node, ast.Subscript):
                if masks is None:
                    masks = self._masks(scope)
                sl = node.slice
                if self.scopes.is_tensor(node.value, scope) and \
                        self._bool_tensor(sl, scope, masks):
                    yield node, ("boolean-mask indexing: the result's "
                                 "size is read on the host")
            elif isinstance(node, ast.FormattedValue):
                if self.scopes.is_tensor(node.value, scope):
                    yield node, ("a tensor formatted into a string is "
                                 "read back to the host")


# ------------------------------------------------------------------ #
#  host-sync                                                         #
# ------------------------------------------------------------------ #


@register
class HostSyncRule(Rule):
    name = "host-sync"
    severity = "warning"
    escalates_to = "error"      # inside a captured body
    summary = "host sync on the hot path, or inside a captured body"
    contract = (
        "In the hot modules (ops/, samplers/, parallel/) every "
        "device->host read and every wait — .item()/.tolist()/.cpu()/"
        ".numpy()/.to('cpu'), synchronize(), data-dependent sizes "
        "(nonzero, one-argument where, unique, masked_select, boolean "
        "masks, repeat_interleave without output_size), the info-"
        "checking factorizations and eigh, a tensor's truth value or "
        "float()/int()/np.asarray() of it — must be an annotated design "
        "point (the block-boundary commit, the sanctioned host "
        "snapshot), because each one drains the launch queue. Inside "
        "a captured body the same constructs are errors: the capture "
        "fails, or it freezes the value it read (reference rule: "
        "host-sync).")

    def check(self, mod):
        cap = mod.captured
        if not mod.hot and not cap.captured and not cap.regions:
            return
        scan = SyncScanner(mod)
        seen = set()
        for scope in _scopes(mod):
            in_cap = isinstance(scope, _FUNC_KINDS) and \
                cap.is_captured(scope)
            if not mod.hot and not in_cap and not cap.regions:
                continue
            for node, msg in scan.hits(scope):
                key = (node.lineno, node.col_offset)
                if key in seen:
                    continue
                captured = in_cap or cap.line_in_captured(node.lineno)
                if not captured and not mod.hot:
                    continue
                seen.add(key)
                f = self.finding(mod, node, msg + (
                    " — inside a captured body" if captured else
                    " — annotate if this boundary is intentional"))
                if captured:
                    f.severity = "error"
                yield f


# ------------------------------------------------------------------ #
#  graph-output-alias                                                #
# ------------------------------------------------------------------ #

#: calls that copy a graph output out of its static buffer
_COPIES = {"clone", "cpu", "item", "tolist", "numpy", "copy"}
#: zero-copy host views of numpy memory
_VIEWS = ("torch.from_numpy",)
_MAYBE_VIEWS = ("torch.as_tensor", "torch.asarray")


def _callee_key(expr):
    """``g`` / ``self.g`` / ``self._graphs[]`` — how a graphed
    callable is named at its binding and at its call sites."""
    if isinstance(expr, ast.Subscript):
        inner = _callee_key(expr.value)
        return None if inner is None else inner + "[]"
    return dataflow.target_dotted(expr)


@register
class GraphOutputAliasRule(Rule):
    name = "graph-output-alias"
    severity = "error"
    summary = "graph output read after the next replay, or a zero-copy " \
              "view written under a non-blocking copy"
    contract = (
        "A cuda_graphed callable returns the graph's static output "
        "buffers: the next call's replay overwrites them, as a donated "
        "buffer aliases its output. An output read after the next "
        "call of the same callable (or kept in a container across "
        "calls) without .clone() reads the later call's values. A "
        "zero-copy host view (torch.from_numpy, torch.as_tensor of a "
        "numpy array) that feeds a non_blocking=True copy is read by "
        "the device later; writing its memory before a sync races the "
        "copy — serve/aot.py's double-buffered staging is the "
        "disciplined form (reference rule: donation-safety).")

    def check(self, mod):
        al, parents = mod.aliases, mod.parents
        graphed = set()
        for call in mod.calls:
            if not dataflow.is_capture_entry(al, call.func):
                continue
            stmt = _enclosing_stmt(parents, call)
            if isinstance(stmt, ast.Assign) and stmt.value is call:
                for t in stmt.targets:
                    k = _callee_key(t)
                    if k is not None:
                        graphed.add(k)
        staging = any(_non_blocking(c) for c in mod.calls)
        if not graphed and not staging:
            return
        for scope in _scopes(mod):
            if isinstance(scope, ast.Lambda) or \
                    not isinstance(getattr(scope, "body", None), list):
                continue
            if graphed:
                yield from self._outputs(mod, scope, graphed)
            if staging:
                yield from self._staging(mod, scope)

    # ---- (1) outputs read after the next replay ---------------------- #
    def _graphed_call(self, node, graphed):
        return isinstance(node, ast.Call) and \
            _callee_key(node.func) in graphed

    def _copied(self, mod, call, stmt):
        """The graphed call's value leaves its buffer before it is
        bound (``g(x).clone()``, ``float(g(x))``)."""
        p = mod.parents.get(id(call))
        while p is not None and p is not stmt:
            if isinstance(p, ast.Call):
                f = p.func
                if isinstance(f, ast.Attribute) and f.attr in _COPIES:
                    return True
                if isinstance(f, ast.Name) and f.id in _CAST_BUILTINS:
                    return True
                if mod.aliases.resolves(f, "torch.clone"):
                    return True
            p = mod.parents.get(id(p))
        return False

    def _outputs(self, mod, scope, graphed):
        nodes = list(_scope_nodes(scope))
        calls = sorted((n for n in nodes if self._graphed_call(n, graphed)),
                       key=lambda n: (n.lineno, n.col_offset))
        if not calls:
            return
        loads = {}
        for n in nodes:
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
                loads.setdefault(n.id, []).append(n)
        defs = dataflow.assignments_in(scope)
        for call in calls:
            stmt = _enclosing_stmt(mod.parents, call)
            key = _callee_key(call.func)
            if self._copied(mod, call, stmt):
                continue
            # kept in a container inside a loop: the next iteration's
            # call overwrites what the container holds
            p = mod.parents.get(id(call))
            if isinstance(p, ast.Call) and isinstance(
                    p.func, ast.Attribute) and p.func.attr in (
                    "append", "extend", "insert") and \
                    self._in_loop(mod, call, scope):
                yield self.finding(
                    mod, call,
                    f"output of graphed {key}() kept in a container in "
                    "a loop without .clone() — the next replay "
                    "overwrites it")
                continue
            if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                continue
            bound = {n.id for t in (stmt.targets if isinstance(
                stmt, ast.Assign) else [stmt.target])
                for n in ast.walk(t) if isinstance(n, ast.Name)}
            after = stmt.end_lineno or stmt.lineno
            nxt = next((c for c in calls if c is not call
                        and _callee_key(c.func) == key
                        and c.lineno > after), None)
            for name in sorted(bound):
                for use in loads.get(name, []):
                    if use.lineno <= after:
                        continue
                    if self._in_loop(mod, call, scope) and \
                            self._appended(mod, use):
                        yield self.finding(
                            mod, use,
                            f"{name!r} (an output of graphed {key}()) "
                            "kept in a container in a loop without "
                            ".clone() — the next replay overwrites it")
                        break
                    if nxt is None or use.lineno <= (
                            nxt.end_lineno or nxt.lineno):
                        continue
                    if any(tgt == name and after < line <= use.lineno
                           for tgt, _v, line in defs):
                        continue        # rebound before this read
                    yield self.finding(
                        mod, use,
                        f"{name!r} (an output of graphed {key}() at line "
                        f"{call.lineno}) read after the next call at "
                        f"line {nxt.lineno} — the replay overwrote it; "
                        ".clone() it first")
                    break

    def _in_loop(self, mod, node, scope):
        p = mod.parents.get(id(node))
        while p is not None and p is not scope:
            if isinstance(p, (ast.For, ast.While, ast.AsyncFor,
                              ast.comprehension)):
                return True
            p = mod.parents.get(id(p))
        return False

    def _appended(self, mod, use):
        p = mod.parents.get(id(use))
        return isinstance(p, ast.Call) and isinstance(
            p.func, ast.Attribute) and p.func.attr in (
            "append", "extend", "insert") and use in p.args

    # ---- (2) zero-copy views under a non-blocking copy ---------------- #
    def _view_source(self, al, expr, numpy_names):
        """The numpy name a zero-copy view reads (or "" when the view
        is provable but its source is not a name); None if ``expr`` is
        no zero-copy view."""
        if not isinstance(expr, ast.Call) or not expr.args:
            return None
        src = expr.args[0]
        if al.resolves(expr.func, *_VIEWS):
            pass
        elif al.resolves(expr.func, *_MAYBE_VIEWS):
            dev = [k for k in expr.keywords if k.arg == "device"]
            numpy_src = (isinstance(src, ast.Name)
                         and src.id in numpy_names) or (
                isinstance(src, ast.Call)
                and (al.dotted(src.func) or "").startswith("numpy."))
            if dev or not numpy_src:
                return None
        else:
            return None
        return src.id if isinstance(src, ast.Name) else ""

    def _staging(self, mod, scope):
        al = mod.aliases
        stmts = sorted((n for n in _scope_nodes(scope)
                        if isinstance(n, ast.stmt)),
                       key=lambda n: n.lineno)
        numpy_names, views = set(), {}    # view name -> source name
        pending = []                      # (view, source, copy line)
        for st in stmts:
            if isinstance(st, ast.Assign) and isinstance(st.value,
                                                         ast.Call):
                d = al.dotted(st.value.func) or ""
                src = self._view_source(al, st.value, numpy_names)
                for t in st.targets:
                    if isinstance(t, ast.Name):
                        if d.startswith("numpy."):
                            numpy_names.add(t.id)
                        if src is not None:
                            views[t.id] = src
            for node in ast.walk(st):
                if not isinstance(node, ast.Call) or \
                        _enclosing_stmt(mod.parents, node) is not st:
                    continue
                nb = _non_blocking(node)
                f = node.func
                if nb and isinstance(f, ast.Attribute):
                    cands = list(node.args[:1]) if f.attr == "copy_" \
                        else [f.value] if f.attr in ("to", "cuda") \
                        else []
                    for c in cands:
                        if isinstance(c, ast.Name) and c.id in views:
                            pending.append((c.id, views[c.id],
                                            node.lineno))
                        elif self._view_source(al, c, numpy_names) \
                                is not None:
                            pending.append(
                                (None, self._view_source(
                                    al, c, numpy_names), node.lineno))
            if not pending:
                continue
            if self._syncs(al, st):
                pending = []
                continue
            for view, src, line in list(pending):
                if st.lineno <= line:
                    continue
                hit = self._writes(st, {view, src} - {None, ""})
                if hit is not None:
                    yield self.finding(
                        mod, hit,
                        f"host memory of a zero-copy view written while "
                        f"its non_blocking copy (line {line}) may still "
                        "read it — synchronise (an event, the stream) "
                        "first, or stage through a pinned buffer")
                    pending.remove((view, src, line))

    def _syncs(self, al, st):
        for node in ast.walk(st):
            if isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) and \
                        f.attr in _SYNC_METHODS:
                    return True
                if al.resolves(f, "torch.cuda.synchronize"):
                    return True
        return False

    def _writes(self, st, names):
        if not names:
            return None
        for node in ast.walk(st):
            tgt = None
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                for t in (node.targets if isinstance(node, ast.Assign)
                          else [node.target]):
                    if isinstance(t, ast.Subscript) or isinstance(
                            node, ast.AugAssign):
                        tgt = t
            elif isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) and (
                    node.func.attr.endswith("_")
                    and not node.func.attr.startswith("_")
                    or node.func.attr == "fill"):
                tgt = node.func.value
            elif isinstance(node, ast.Call) and any(
                    k.arg == "out" for k in node.keywords):
                tgt = next(k.value for k in node.keywords
                           if k.arg == "out")
            if tgt is None:
                continue
            root = tgt
            while isinstance(root, (ast.Subscript, ast.Attribute)):
                root = root.value
            if isinstance(root, ast.Name) and root.id in names:
                return node
        return None


# ------------------------------------------------------------------ #
#  rng-explicit-generator                                            #
# ------------------------------------------------------------------ #

#: torch draws that take ``generator=``
_TORCH_DRAWS = ("torch.rand", "torch.randn", "torch.randint",
                "torch.randperm", "torch.normal", "torch.multinomial",
                "torch.bernoulli", "torch.poisson")
#: torch draws with no ``generator=`` at all: always the global stream
_TORCH_GLOBAL_DRAWS = ("torch.rand_like", "torch.randn_like",
                       "torch.randint_like")
_INPLACE_DRAWS = {"uniform_", "normal_", "exponential_", "random_",
                  "bernoulli_", "geometric_", "log_normal_", "cauchy_"}
_METHOD_DRAWS = {"multinomial", "bernoulli"}
_GLOBAL_SEEDS = ("torch.manual_seed", "torch.seed",
                 "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                 "torch.random.manual_seed", "torch.random.seed",
                 "numpy.random.seed", "random.seed")
#: numpy.random / random names that make an explicit stream
_STREAM_CTORS = {"default_rng", "Generator", "SeedSequence", "PCG64",
                 "PCG64DXSM", "MT19937", "Philox", "SFC64",
                 "RandomState", "BitGenerator", "Random", "SystemRandom"}


@register
class RngExplicitGeneratorRule(Rule):
    name = "rng-explicit-generator"
    severity = "error"
    summary = "draw from a global random stream"
    contract = (
        "Every draw names its stream: torch draws take generator=, "
        "numpy draws go through a seeded np.random.Generator. A draw "
        "from torch's, numpy's or random's global stream — or a "
        "global re-seed — makes the chain depend on whatever else drew "
        "before it in the process, and breaks the port's rule that a "
        "chain is reproduced bit for bit under a retry or a resume "
        "(reference rule: rng-key-reuse).")

    def check(self, mod):
        al = mod.aliases
        scopes = None
        for call in mod.calls:
            f = call.func
            d = al.dotted(f) or ""
            has_gen = any(k.arg == "generator" for k in call.keywords)
            msg = None
            if d in _TORCH_GLOBAL_DRAWS:
                msg = (f"{d}() takes no generator: it draws from the "
                       "global stream — draw with torch.rand/randn(..., "
                       "generator=g) of the shape instead")
            elif d in _TORCH_DRAWS and not has_gen:
                msg = f"{d}() without generator= draws from the global " \
                      "stream"
            elif d in _GLOBAL_SEEDS:
                msg = f"{d}() re-seeds the global stream"
            elif isinstance(f, ast.Attribute) and \
                    f.attr in _INPLACE_DRAWS and not has_gen:
                msg = f".{f.attr}() without generator= draws from the " \
                      "global stream"
            elif isinstance(f, ast.Attribute) and \
                    f.attr in _METHOD_DRAWS and not has_gen:
                if scopes is None:
                    scopes = _Scopes(mod)
                scope = _enclosing_func(mod.parents, call) or mod.tree
                if scopes.is_tensor(f.value, scope):
                    msg = f".{f.attr}() without generator= draws from " \
                          "the global stream"
            elif self._global_module_draw(al, f):
                msg = f"{d}() draws from the global stream — use a " \
                      "seeded np.random.default_rng / random.Random"
            if msg is not None:
                yield self.finding(mod, call, msg)

    def _global_module_draw(self, al, f):
        d = al.dotted(f)
        if d is None:
            return False
        for mod_name in ("numpy.random.", "random."):
            if d.startswith(mod_name) and d.count(".") == \
                    mod_name.count("."):
                root = f
                while isinstance(root, ast.Attribute):
                    root = root.value
                # the name must be the imported module, not a local
                if al.map.get(root.id, "").split(".")[0] not in (
                        "numpy", "random"):
                    return False
                return d.rsplit(".", 1)[-1] not in _STREAM_CTORS
        return False


# ------------------------------------------------------------------ #
#  graph-purity                                                      #
# ------------------------------------------------------------------ #

_MUTATORS = {"append", "extend", "insert", "add", "pop",
             "popitem", "clear", "remove", "discard", "setdefault",
             "write", "writelines", "writerow", "update"}
_EFFECT_METHODS = {"inc", "observe", "event", "heartbeat", "record",
                   "anomaly", "info", "debug", "warning", "error",
                   "exception", "log"}
_EFFECT_CALLS = ("builtins.open", "open", "print", "numpy.save",
                 "numpy.savez", "numpy.savez_compressed", "numpy.savetxt",
                 "torch.save", "torch.load")


@register
class GraphPurityRule(Rule):
    name = "graph-purity"
    severity = "error"
    summary = "side effect inside a captured body"
    contract = (
        "A captured body runs ONCE, at capture; each later call "
        "replays its kernels and nothing else. Mutating closed-over or "
        "global state, appending to captured containers, file I/O, "
        "telemetry and logging calls, and random draws (the graph "
        "would replay the capture's draw: coupling.cuda_graphed's "
        "contract) happen once and never again. In-place tensor "
        "writes are device work and replay; subscript stores into a "
        "parameter of an enclosing function are such writes "
        "(reference rule: jit-purity).")

    def check(self, mod):
        cap = mod.captured
        parents = mod.parents
        seen = set()

        def emit(node, msg):
            key = (node.lineno, node.col_offset)
            if key in seen:
                return None
            seen.add(key)
            return self.finding(mod, node, msg)

        bodies = []
        for fn in cap.captured_funcs():
            locs = set(dataflow.local_names(fn)) if not isinstance(
                fn, ast.Lambda) else set(dataflow.param_names(fn))
            enc = _enclosing_func(parents, fn)
            while enc is not None:
                locs |= dataflow.param_names(enc)
                enc = _enclosing_func(parents, enc)
            bodies.append((list(_scope_nodes(fn)), locs))
        for _lo, _hi, body in cap.regions:
            fn = _enclosing_func(parents, body[0])
            locs = set()
            while fn is not None:
                locs |= dataflow.local_names(fn) if not isinstance(
                    fn, ast.Lambda) else dataflow.param_names(fn)
                fn = _enclosing_func(parents, fn)
            nodes = [n for s in body for n in ast.walk(s)]
            bodies.append((nodes, locs))
        for nodes, locs in bodies:
            for node in nodes:
                f = self._check_node(mod, node, locs, emit)
                if f is not None:
                    yield f

    def _root_name(self, node):
        while isinstance(node, (ast.Attribute, ast.Subscript)):
            node = node.value
        return node.id if isinstance(node, ast.Name) else None

    def _check_node(self, mod, node, locs, emit):
        al = mod.aliases
        if isinstance(node, (ast.Global, ast.Nonlocal)):
            kind = "global" if isinstance(node, ast.Global) else "nonlocal"
            return emit(node, f"{kind} write inside a captured body — "
                              "it happens once, at capture")
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Attribute):
                    return emit(t, "attribute mutation "
                                   f"('{ast.unparse(t)} = ...') inside a "
                                   "captured body — it happens once, at "
                                   "capture")
                if isinstance(t, ast.Subscript):
                    root = self._root_name(t)
                    if root is not None and root not in locs:
                        return emit(
                            t, f"subscript store into closed-over "
                               f"{root!r} inside a captured body — host "
                               "state written once, at capture")
            return None
        if not isinstance(node, ast.Call):
            return None
        f = node.func
        d = al.dotted(f) or ""
        if al.resolves(f, *_EFFECT_CALLS,
                       suffixes=("telemetry.registry",
                                 "telemetry.active_recorder",
                                 "flightrec.flight_recorder",
                                 "logging.get_logger")):
            return emit(node, f"{d}() inside a captured body — host I/O "
                              "or telemetry runs once, at capture")
        if d in _TORCH_DRAWS or d in _TORCH_GLOBAL_DRAWS or (
                isinstance(f, ast.Attribute)
                and f.attr in _INPLACE_DRAWS) or \
                d.startswith("numpy.random."):
            return emit(node, f"random draw {d or f.attr}() inside a "
                              "captured body — every replay repeats the "
                              "capture's draw; draw outside the graph")
        if isinstance(f, ast.Attribute):
            root = self._root_name(f)
            if root is not None and root in al.map:
                return None     # module attribute (torch.log, ...)
            if f.attr in _MUTATORS and root is not None \
                    and root not in locs:
                return emit(node, f".{f.attr}() on closed-over {root!r} "
                                  "inside a captured body — it happens "
                                  "once, at capture")
            if f.attr in _EFFECT_METHODS and root is not None and \
                    root not in locs:
                return emit(node, f"telemetry/logging call {root}."
                                  f"{f.attr}() inside a captured body — "
                                  "it runs once, at capture")
        return None


# ------------------------------------------------------------------ #
#  precision                                                         #
# ------------------------------------------------------------------ #

_F64_PATHS = ("torch.float64", "torch.double", "numpy.float64",
              "numpy.double")
_F64_LITERALS = ("float64", "f8", "d", ">f8", "<f8", "double")


@register
class PrecisionContractRule(Rule):
    name = "precision"
    severity = "warning"
    summary = "float64 outside the documented islands, or a TF32 switch"
    contract = (
        "The kernel class is float32: float64 survives only at the "
        "islands the package docstring names — whitening, skinny "
        "Grams, equilibration, the timing-model Schur stage, sampler "
        "state — each annotated with WHY it needs the mantissa "
        "(function or module scope for code that is float64 by "
        "design). An unannotated float64 in hot code doubles memory "
        "traffic and runs the card's float64 units at a 30th of "
        "their float32 rate. TF32 is switched off exactly once, in "
        "the package __init__ (reference rule: precision).")

    TF32_ALLOWED = (f"{PKG_NAME}/__init__.py",)

    def check(self, mod):
        al = mod.aliases
        if mod.rel not in self.TF32_ALLOWED:
            for node in mod.nodes:
                if isinstance(node, ast.Attribute) and \
                        node.attr == "allow_tf32":
                    yield self.finding(
                        mod, node,
                        "TF32 switch outside the package __init__ — it "
                        "is process-global and set exactly once")
            for call in mod.calls:
                if al.resolves(call.func,
                               "torch.set_float32_matmul_precision"):
                    yield self.finding(
                        mod, call,
                        "torch.set_float32_matmul_precision() outside "
                        "the package __init__ — the matmul precision is "
                        "process-global and set exactly once")
        if not mod.hot:
            return
        for node in mod.nodes:
            if isinstance(node, (ast.Attribute, ast.Name)) and \
                    isinstance(node.ctx, ast.Load) and \
                    al.dotted(node) in _F64_PATHS and not (
                        isinstance(mod.parents.get(id(node)),
                                   ast.Attribute)):
                yield self.finding(
                    mod, node,
                    f"{ast.unparse(node)} ({al.dotted(node)}) in hot code "
                    "— the kernel class is float32; annotate a float64 "
                    "island with why it needs the mantissa")
        for call in mod.calls:
            f = call.func
            if isinstance(f, ast.Attribute) and f.attr == "double" and \
                    not call.args:
                yield self.finding(
                    mod, call,
                    ".double() in hot code — the kernel class is "
                    "float32; annotate a float64 island")
                continue
            cands = [k.value for k in call.keywords if k.arg == "dtype"]
            if isinstance(f, ast.Attribute) and f.attr in ("astype",
                                                           "view", "to"):
                cands.extend(call.args)
            for c in cands:
                if isinstance(c, ast.Constant) and \
                        c.value in _F64_LITERALS:
                    yield self.finding(
                        mod, c,
                        f"dtype literal {c.value!r} in hot code — the "
                        "kernel class is float32; annotate a float64 "
                        "island with why it needs the mantissa")
