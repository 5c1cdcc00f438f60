"""Engine core: findings, the rule registry, suppression comments,
file discovery, and the runner.

Design constraints:

- **Standard library only.** The linter imports neither torch nor
  jax, so it runs without a card, inside CI and inside the tier-1
  suite in well under a second per module.
- **One parse per file.** Every rule receives the same
  :class:`Module` (source, AST, comment/suppression tables, alias and
  capture-region indexes built lazily on first use).
- **Suppressions carry their justification.** The inline syntax is

      # ewt: allow-<rule>[,<rule2>...] [module] — <reason>

  (``—``, ``--`` or ``:`` separate the reason). Placement decides
  scope: on the flagged line or the line directly above it (line
  scope), on/above a ``def``/decorator header (whole function), or
  with the ``module`` token (whole file). A suppression without a
  reason, or naming an unknown rule, is itself a finding
  (``bad-suppression``) — the annotation sweep is the audit record of
  every intentional host sync / f64 island / global draw, so an empty
  annotation is worthless.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass
from pathlib import Path

SCHEMA_VERSION = 1
PKG_NAME = "enterprise_warp_tpu_torch"
REPO_ROOT = Path(__file__).resolve().parents[2]

#: module path prefixes (repo-relative, posix) whose code is "hot":
#: the step loops of the samplers, the kernel wrappers, and the
#: (sharded) joint likelihood — where an unannotated host sync stalls
#: the launch queue.
HOT_PREFIXES = (f"{PKG_NAME}/ops/", f"{PKG_NAME}/samplers/",
                f"{PKG_NAME}/parallel/")

# ------------------------------------------------------------------ #
#  findings                                                          #
# ------------------------------------------------------------------ #


@dataclass
class Finding:
    """One diagnostic: a rule, a location, and a message. When an
    inline suppression covers the location, ``suppressed`` is True and
    ``suppress_reason`` carries the annotation's justification."""

    rule: str
    severity: str           # "error" | "warning"
    path: str               # repo-relative posix path
    line: int
    col: int
    message: str
    suppressed: bool = False
    suppress_reason: str | None = None

    def to_dict(self):
        d = {"rule": self.rule, "severity": self.severity,
             "path": self.path, "line": self.line, "col": self.col,
             "message": self.message, "suppressed": self.suppressed}
        if self.suppressed:
            d["suppress_reason"] = self.suppress_reason
        return d

    def format(self):
        tag = " (suppressed)" if self.suppressed else ""
        return (f"{self.path}:{self.line}:{self.col} "
                f"[{self.severity}] {self.rule}: {self.message}{tag}")


# ------------------------------------------------------------------ #
#  suppression comments                                              #
# ------------------------------------------------------------------ #

_SUPPRESS_RE = re.compile(
    r"#\s*ewt:\s*allow-([A-Za-z0-9_,-]+)"     # rule list
    r"(\s+module\b)?"                          # optional module scope
    r"\s*(?:(?:—|--|:)\s*(.*))?$")             # optional reason


@dataclass
class _Suppression:
    rules: tuple
    reason: str
    line: int           # first line of the annotation's comment block
    module_scope: bool
    end: int = 0        # last line of the contiguous comment block
    standalone: bool = True   # comment-only line (vs trailing a stmt)


def _parse_suppressions(source):
    """Tokenize ``source`` and extract every ``ewt: allow-`` comment.
    Returns ``(suppressions, issues)`` where issues are
    ``(line, message)`` pairs for malformed annotations (no reason).
    Falls back to a line-regex scan if tokenization fails (the parse
    error is reported separately)."""
    src_lines = source.splitlines()

    def _standalone(line, col):
        text = src_lines[line - 1] if line - 1 < len(src_lines) else ""
        return not text[:col].strip()

    comments = []
    try:
        toks = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in toks:
            if tok.type == tokenize.COMMENT:
                comments.append((tok.start[0], tok.start[1],
                                 tok.string))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        for i, text in enumerate(src_lines, start=1):
            if "#" in text and "ewt:" in text:
                comments.append((i, text.index("#"),
                                 text[text.index("#"):]))
    comment_lines = {line for line, _c, _t in comments}
    sups, issues = [], []
    for line, col, text in comments:
        if "ewt:" not in text:
            continue
        m = _SUPPRESS_RE.search(text)
        if m is None:
            if "allow-" in text:
                issues.append((line, "malformed ewt suppression "
                                     f"comment: {text.strip()!r}"))
            continue
        rules = tuple(r for r in m.group(1).split(",") if r)
        reason = (m.group(3) or "").strip()
        if not reason:
            issues.append(
                (line, "suppression without a justification — write "
                       "'# ewt: allow-<rule> — <why this is "
                       "intentional>'"))
        # a wrapped annotation covers through the end of its comment
        # block: the reason may continue on following comment lines
        end = line
        while end + 1 in comment_lines:
            end += 1
        sups.append(_Suppression(rules, reason, line,
                                 bool(m.group(2)), end,
                                 _standalone(line, col)))
    return sups, issues


# ------------------------------------------------------------------ #
#  parsed module                                                     #
# ------------------------------------------------------------------ #


class Module:
    """One parsed target file, shared by every rule."""

    def __init__(self, path, rel, source=None):
        self.path = Path(path)
        self.rel = str(rel).replace("\\", "/")
        self.source = (self.path.read_text(encoding="utf-8",
                                           errors="replace")
                       if source is None else source)
        self.lines = self.source.splitlines()
        self.parse_error = None
        try:
            self.tree = ast.parse(self.source)
        except SyntaxError as e:
            self.tree = None
            self.parse_error = (e.lineno or 1, e.msg or "syntax error")
        self.suppressions, self.suppress_issues = \
            _parse_suppressions(self.source)
        self._func_ranges = None
        self._aliases = None
        self._captured = None
        self._nodes = None
        self._parents = None
        self._calls = None
        self._stmt_head_end = None

    # -------- path predicates -------------------------------------- #
    @property
    def hot(self):
        return self.rel.startswith(HOT_PREFIXES)

    # -------- lazy indexes (built on first rule that needs them) --- #
    @property
    def aliases(self):
        if self._aliases is None:
            from . import dataflow
            self._aliases = dataflow.Aliases(self.tree)
        return self._aliases

    @property
    def captured(self):
        if self._captured is None:
            from . import dataflow
            self._captured = dataflow.CaptureIndex(
                self.tree, self.aliases, parents=self.parents,
                nodes=self.nodes)
        return self._captured

    @property
    def nodes(self):
        """Every AST node of the file, in walk order, listed once."""
        if self._nodes is None:
            self._nodes = (list(ast.walk(self.tree))
                           if self.tree is not None else [])
        return self._nodes

    @property
    def parents(self):
        """id(node) -> parent AST node, built once per file — the
        ancestry index every tracer rule needs; rebuilding it per
        rule dominated engine wall time."""
        if self._parents is None:
            par = {}
            for parent in self.nodes:
                for child in ast.iter_child_nodes(parent):
                    par[id(child)] = parent
            self._parents = par
        return self._parents

    @property
    def calls(self):
        """Every ast.Call in the file, in walk order (shared by the
        style rules and the alias/precision passes)."""
        if self._calls is None:
            self._calls = [n for n in self.nodes
                           if isinstance(n, ast.Call)]
        return self._calls

    @property
    def func_ranges(self):
        """``(header_lo, def_line, end_line)`` for every function —
        the header span (first decorator .. ``def`` line) is where a
        function-scoped suppression may sit."""
        if self._func_ranges is None:
            ranges = []
            for node in self.nodes:
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    lo = min([d.lineno for d in node.decorator_list]
                             + [node.lineno])
                    ranges.append((lo, node.lineno,
                                   node.end_lineno or node.lineno))
            self._func_ranges = ranges
        return self._func_ranges

    @property
    def stmt_head_end(self):
        """start line -> last line of the statement HEAD beginning
        there: a simple statement's own end_lineno, a compound
        statement's header expression (``if``/``while`` test, ``for``
        iter, ``with`` items) — never the body, so a line-scoped
        suppression can cover a wrapped call/condition without
        silently covering a whole block."""
        if self._stmt_head_end is None:
            ends = {}
            for node in self.nodes:
                if not isinstance(node, ast.stmt):
                    continue
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef,
                                     ast.ClassDef, ast.Try)):
                    continue    # defs: function scope; try: no head
                if isinstance(node, (ast.If, ast.While)):
                    head = node.test.end_lineno
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    head = node.iter.end_lineno
                elif isinstance(node, (ast.With, ast.AsyncWith)):
                    head = max((i.context_expr.end_lineno
                                or node.lineno)
                               for i in node.items)
                else:
                    head = node.end_lineno
                head = head or node.lineno
                ends[node.lineno] = max(ends.get(node.lineno, 0),
                                        head)
            self._stmt_head_end = ends
        return self._stmt_head_end

    # -------- suppression lookup ----------------------------------- #
    def suppression_for(self, rule, line):
        """The justification covering ``rule`` at ``line``, or None.
        Checks line scope (annotation block touching the line or the
        line above it), function scope (annotation block on or
        directly above the ``def`` header of any enclosing function),
        then module scope."""
        for sup in self.suppressions:
            if rule not in sup.rules:
                continue
            if sup.module_scope:
                return sup.reason or "(no reason)"
            # a standalone comment block covers itself plus the
            # statement directly below — THROUGH its head's last line,
            # so findings anchored on a continuation line (an argument
            # inside a wrapped call) are still covered; a
            # trailing annotation covers its own statement's head
            reach = sup.end + 1 if sup.standalone else sup.end
            anchor = sup.end + 1 if sup.standalone else sup.line
            reach = max(reach, self.stmt_head_end.get(anchor, 0))
            if sup.line <= line <= reach:
                return sup.reason or "(no reason)"
            # function scope requires a STANDALONE annotation on or
            # above the def header — a comment trailing the last
            # statement of the PREVIOUS function sits on the same
            # lines and must not leak over the whole next function
            if not sup.standalone:
                continue
            for (hdr_lo, def_line, end) in self.func_ranges:
                if (hdr_lo - 1 <= sup.end <= def_line
                        and def_line <= line <= end):
                    return sup.reason or "(no reason)"
        return None


# ------------------------------------------------------------------ #
#  rule registry                                                     #
# ------------------------------------------------------------------ #


class Rule:
    """Base class. Subclasses set ``name``/``severity``/``summary``/
    ``contract`` and implement :meth:`check` yielding Findings (the
    engine fills in suppression state afterwards)."""

    name = ""
    severity = "error"
    #: severity of this rule's ESCALATED findings, when it emits a
    #: stricter class than its base severity (host-sync: warning in a
    #: hot module, error inside a captured body) — surfaced in the JSON
    #: rules table so severity-gating consumers see both classes
    escalates_to = None
    summary = ""
    contract = ""

    def check(self, mod):   # pragma: no cover - abstract
        yield from ()

    def finding(self, mod, node_or_line, message, col=None):
        if isinstance(node_or_line, int):
            line, c = node_or_line, col or 0
        else:
            line = getattr(node_or_line, "lineno", 1)
            c = getattr(node_or_line, "col_offset", 0) \
                if col is None else col
        return Finding(self.name, self.severity, mod.rel, line, c,
                       message)


_REGISTRY = {}


def register(cls):
    inst = cls()
    if not inst.name:
        raise ValueError(f"rule {cls.__name__} has no name")
    _REGISTRY[inst.name] = inst
    return cls


def all_rules():
    """name -> rule instance, in registration order."""
    return dict(_REGISTRY)


@register
class ParseErrorRule(Rule):
    name = "parse-error"
    severity = "error"
    summary = "target file does not parse"
    contract = ("Every linted file must be valid Python — a file the "
                "engine cannot parse is a file no rule can vouch for.")

    def check(self, mod):
        if mod.parse_error is not None:
            line, msg = mod.parse_error
            yield self.finding(mod, line, f"syntax error: {msg}")


@register
class SuppressionHygieneRule(Rule):
    name = "bad-suppression"
    severity = "error"
    summary = "suppression comment missing a reason or naming an " \
              "unknown rule"
    contract = ("Suppressions are the audit record of every "
                "intentional contract exception; each must name a "
                "real rule and say WHY the exception is safe.")

    def check(self, mod):
        for line, msg in mod.suppress_issues:
            yield self.finding(mod, line, msg)
        for sup in mod.suppressions:
            for r in sup.rules:
                if r not in _REGISTRY:
                    yield self.finding(
                        mod, sup.line,
                        f"suppression names unknown rule {r!r} "
                        f"(known: {', '.join(sorted(_REGISTRY))})")


# ------------------------------------------------------------------ #
#  file discovery + runner                                           #
# ------------------------------------------------------------------ #

_DEFAULT_TARGETS = (PKG_NAME,)
_SKIP_PARTS = {"__pycache__", ".git", "fixtures"}


def iter_target_files(root=None, paths=None):
    """Yield ``(abs_path, rel)`` for every lint target. ``paths``
    overrides the default target (the port package); a directory is
    walked recursively, a file is taken as-is."""
    root = Path(root or REPO_ROOT)
    raw = []
    if paths:
        raw = [Path(p) for p in paths]
    else:
        raw = [root / t for t in _DEFAULT_TARGETS]
    out = []
    for p in raw:
        if not p.is_absolute():
            p = root / p
        if p.is_dir():
            # the skip set applies only below a walked directory —
            # a file the caller NAMES is always linted (silently
            # dropping an explicit target would report clean on a
            # file full of violations)
            out.extend(f for f in sorted(p.rglob("*.py"))
                       if not set(f.relative_to(p).parts[:-1])
                       & _SKIP_PARTS)
        elif p.suffix == ".py" and p.exists():
            out.append(p)
        elif paths:
            # same contract as the skip set: a target the caller NAMES
            # must never vanish silently — a typo'd path would report
            # clean with exit 0
            raise ValueError(
                f"lint target {p} is not a .py file or a directory")
    seen = set()
    for p in out:
        p = p.resolve()
        if p in seen:
            continue
        seen.add(p)
        try:
            rel = p.relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = p.as_posix()
        yield p, rel


class LintResult:
    """Everything one engine run produced."""

    def __init__(self, findings, files_scanned, rule_names, root):
        self.findings = findings            # every finding, suppressed too
        self.files_scanned = files_scanned
        self.rule_names = list(rule_names)
        self.root = str(root)

    @property
    def active(self):
        return [f for f in self.findings if not f.suppressed]

    @property
    def suppressed(self):
        return [f for f in self.findings if f.suppressed]

    def to_json(self):
        rules = {}
        for n in self.rule_names:
            if n not in _REGISTRY:
                continue
            r = _REGISTRY[n]
            rules[n] = {"severity": r.severity, "summary": r.summary}
            if r.escalates_to:
                rules[n]["escalates_to"] = r.escalates_to
        sev = {"error": 0, "warning": 0}
        for f in self.active:
            sev[f.severity] = sev.get(f.severity, 0) + 1
        return {
            "version": SCHEMA_VERSION,
            "tool": "ewt-lint",
            "root": self.root,
            "files_scanned": self.files_scanned,
            "rules": rules,
            "findings": [f.to_dict() for f in self.findings],
            "counts": {"active": len(self.active),
                       "suppressed": len(self.suppressed), **sev},
        }

    def format_human(self, show_suppressed=False):
        out = []
        shown = self.findings if show_suppressed else self.active
        for f in sorted(shown, key=lambda f: (f.path, f.line, f.col,
                                              f.rule)):
            out.append(f.format())
        out.append(f"{len(self.active)} finding(s) "
                   f"({len(self.suppressed)} suppressed) across "
                   f"{self.files_scanned} file(s), "
                   f"{len(self.rule_names)} rule(s) active")
        return "\n".join(out)


def run_lint(paths=None, root=None, rules=None):
    """Run the engine. ``rules`` restricts to the named subset (the
    engine-hygiene rules ``parse-error``/``bad-suppression`` always
    run). Returns a :class:`LintResult`; suppressed findings are kept
    (marked) so callers can audit the annotation record."""
    root = Path(root or REPO_ROOT)
    if rules:
        unknown = [r for r in rules if r not in _REGISTRY]
        if unknown:
            raise ValueError(
                f"unknown rule(s) {unknown}; known: "
                f"{', '.join(sorted(_REGISTRY))}")
        selected = {n: r for n, r in _REGISTRY.items()
                    if n in set(rules) | {"parse-error",
                                          "bad-suppression"}}
    else:
        selected = dict(_REGISTRY)
    findings = []
    nfiles = 0
    for path, rel in iter_target_files(root=root, paths=paths):
        nfiles += 1
        mod = Module(path, rel)
        for rule in selected.values():
            if mod.tree is None and rule.name not in (
                    "parse-error", "bad-suppression"):
                continue
            for f in rule.check(mod):
                reason = mod.suppression_for(f.rule, f.line)
                if reason is not None:
                    f.suppressed = True
                    f.suppress_reason = reason
                findings.append(f)
    return LintResult(findings, nfiles, selected.keys(), root)
