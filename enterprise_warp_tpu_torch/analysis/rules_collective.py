"""Collective-safety rule: every ``torch.distributed`` collective goes
through ``parallel/distributed.py``'s counted wrappers, and no host
sync sits in a function of the joint likelihood, the single-pulsar
build (its TOA axis) or the samplers that reaches one.

The sharded joint likelihood (``parallel/pta.py``) and the TOA-sharded
single-pulsar likelihood (``models/build.py``) hold a one-
collective-per-evaluation contract, and the chain axis (``samplers/
ptmcmc.py:_ChainSplit``) one ``all_gather`` a step: both are counted
(``distributed.COLLECTIVES``) and staged through the host on a gloo
group by the wrappers alone. A raw ``dist.all_reduce`` elsewhere is a
collective the counts miss and the staging skips; a host sync in a
function that reaches a collective turns one rank's stall into every
rank's — the torch form of the reference's "no host sync inside the
``shard_map`` body".
"""

from __future__ import annotations

import ast

from .core import PKG_NAME, Rule, register
from .rules_tracer import SyncScanner, _enclosing_func, _scope_nodes

_COLLECTIVES = {
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "broadcast", "broadcast_object_list",
    "reduce_scatter", "reduce_scatter_tensor", "barrier", "reduce",
    "gather", "gather_object", "scatter", "scatter_object_list",
    "all_to_all", "all_to_all_single", "send", "recv", "isend", "irecv",
}
#: the counted wrappers (``parallel/distributed.py``)
WRAPPERS = ("_raw_all_reduce", "all_reduce_sum", "grad_all_reduce",
            "all_gather_rows", "from_primary")
_WRAPPER_HOME = f"{PKG_NAME}/parallel/distributed.py"
_SYNC_SCOPE = (f"{PKG_NAME}/parallel/pta.py", f"{PKG_NAME}/models/build.py",
               f"{PKG_NAME}/samplers/")


@register
class CollectiveSafetyRule(Rule):
    name = "collective-safety"
    severity = "error"
    summary = "raw torch.distributed collective; host sync in a " \
              "function that reaches a collective"
    contract = (
        "torch.distributed collectives run only inside parallel/"
        "distributed.py's counted wrappers (_raw_all_reduce, "
        "all_reduce_sum, grad_all_reduce, all_gather_rows, "
        "from_primary): they count each collective and stage CUDA "
        "tensors through the host on a gloo group. In parallel/pta.py, "
        "models/build.py and samplers/, a function that calls a "
        "wrapper (directly or through functions of its module) holds "
        "no host sync: every "
        "rank would wait at it before the collective (reference rule: "
        "collective-safety).")

    def check(self, mod):
        al, parents = mod.aliases, mod.parents
        for call in mod.calls:
            d = al.dotted(call.func) or ""
            if not d.startswith("torch.distributed.") or \
                    d.rsplit(".", 1)[-1] not in _COLLECTIVES:
                continue
            fn = _enclosing_func(parents, call)
            while fn is not None and isinstance(fn, ast.Lambda):
                fn = _enclosing_func(parents, fn)
            if mod.rel == _WRAPPER_HOME and fn is not None and \
                    fn.name in WRAPPERS:
                continue
            yield self.finding(
                mod, call,
                f"raw {d}() — collectives go through parallel/"
                "distributed.py's counted wrappers")
        if not mod.rel.startswith(_SYNC_SCOPE):
            return
        yield from self._syncs_near_collectives(mod)

    def _syncs_near_collectives(self, mod):
        al, parents = mod.aliases, mod.parents
        funcs = [n for n in mod.nodes
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        by_name, methods = {}, {}
        for fn in funcs:
            cls = parents.get(id(fn))
            if isinstance(cls, ast.ClassDef):
                methods.setdefault((id(cls), fn.name), []).append(fn)
            else:
                by_name.setdefault(fn.name, []).append(fn)

        def callees(fn):
            out, direct = [], False
            for call in _scope_nodes(fn):
                if not isinstance(call, ast.Call):
                    continue
                f = call.func
                d = al.dotted(f) or ""
                if d.rsplit(".", 1)[-1] in WRAPPERS:
                    direct = True
                if isinstance(f, ast.Name):
                    out.extend(by_name.get(f.id, []))
                elif isinstance(f, ast.Attribute) and \
                        isinstance(f.value, ast.Name) and \
                        f.value.id == "self":
                    cls = parents.get(id(fn))
                    while cls is not None and \
                            not isinstance(cls, ast.ClassDef):
                        cls = parents.get(id(cls))
                    if cls is not None:
                        out.extend(methods.get((id(cls), f.attr), []))
            return out, direct

        graph = {id(fn): callees(fn) for fn in funcs}
        reach = {i for i, (_c, direct) in graph.items() if direct}
        changed = True
        while changed:
            changed = False
            for fn in funcs:
                if id(fn) in reach:
                    continue
                if any(id(c) in reach for c in graph[id(fn)][0]):
                    reach.add(id(fn))
                    changed = True
        if not reach:
            return
        scan = SyncScanner(mod)
        seen = set()
        for fn in funcs:
            if id(fn) not in reach:
                continue
            for node, msg in scan.hits(fn):
                if (node.lineno, node.col_offset) in seen:
                    continue
                seen.add((node.lineno, node.col_offset))
                yield self.finding(
                    mod, node,
                    f"{msg} in {fn.name}(), which reaches a collective — "
                    "a host sync there makes every rank wait")
