"""Source-span error objects for the MathMap language pipeline.

The reference reports parse/type errors with line/column in the GIMP GUI
(mathmap.c error path [unverified — reference mount empty, see SURVEY.md §0]).
We mirror that with structured exceptions carrying a source span, usable by
both the CLI and the Python API.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Span:
    """Half-open source region [start, end) with 1-based line/col of start."""

    line: int = 0
    col: int = 0
    start: int = 0
    end: int = 0

    def __str__(self) -> str:
        return f"{self.line}:{self.col}"


class MMError(Exception):
    """Base class for all MathMap language errors."""

    def __init__(self, message: str, span: Span | None = None, source: str | None = None):
        self.message = message
        self.span = span or Span()
        self.source = source
        super().__init__(self.format())

    def format(self) -> str:
        loc = f" at {self.span}" if self.span and self.span.line else ""
        out = f"{type(self).__name__}{loc}: {self.message}"
        if self.source and self.span and self.span.line:
            lines = self.source.splitlines()
            if 0 < self.span.line <= len(lines):
                src_line = lines[self.span.line - 1]
                out += f"\n  {src_line}\n  {' ' * max(0, self.span.col - 1)}^"
        return out


class MMSyntaxError(MMError):
    """Tokenizer / parser error."""


class MMTypeError(MMError):
    """Tuple tag/length mismatch or overload-resolution failure."""


class MMNameError(MMError):
    """Unknown variable, filter, or builtin."""


class MMRuntimeError(MMError):
    """Errors raised during tracing/evaluation (e.g. bad userval)."""
