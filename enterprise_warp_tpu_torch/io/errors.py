"""Typed ingestion errors shared by the .par/.tim parsers.

Part of the numerical-integrity plane (docs/resilience.md): a corrupt
input file must fail at the door with file:line provenance, as a typed
exception the ingestion gate (``resilience/integrity.py``) can fold
into a :class:`~..resilience.integrity.DataQuarantine` — never as a
bare ``ValueError``/``IndexError`` surfacing from arbitrary depth in
the parser.
"""

from __future__ import annotations

__all__ = ["ParseError"]


class ParseError(ValueError):
    """A malformed or truncated line in a .par/.tim file.

    Carries ``path``, ``lineno`` (1-based), the offending ``line``
    text and a human ``reason`` — enough provenance to fix the file or
    to quarantine the pulsar with an honest record.
    """

    def __init__(self, path: str, lineno: int, line: str, reason: str):
        self.path = path
        self.lineno = int(lineno)
        self.line = line.rstrip("\n")
        self.reason = reason
        super().__init__(
            f"{path}:{lineno}: {reason} (line: {self.line[:120]!r})")
