"""Tokenizer for the MathMap expression language.

Replaces the reference's flex scanner (`scanner.fl` [unverified — mount empty,
SURVEY.md §0]). Token set per SURVEY.md §2.1: numbers, identifiers, operators,
keywords (`filter`, `if/then/else/end`, `while/do/end`), tag syntax `tag:expr`,
tuple literals `[...]`, subscripts. Comments start with `#` and run to end of
line (C-style `/* */` block comments are accepted as well for convenience).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.errors import MMSyntaxError, Span

KEYWORDS = {
    "filter",
    "if",
    "then",
    "else",
    "end",
    "while",
    "do",
    # NOTE: no `for` — the language has only while/do loops (if the
    # reference grammar reserves it, revisit per SURVEY §8)
    "xor",
}

# Multi-char operators first (longest match wins).
OPERATORS = [
    "==", "!=", "<=", ">=", "&&", "||",
    "+", "-", "*", "/", "%", "^",
    "=", "<", ">", "!",
    "(", ")", "[", "]", ",", ";", ":",
]


@dataclass(frozen=True)
class Token:
    kind: str  # 'num' | 'ident' | 'kw' | 'op' | 'string' | 'eof'
    text: str
    value: float | str | None
    span: Span

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Token({self.kind},{self.text!r}@{self.span})"


def _isdigit(ch: str) -> bool:
    """ASCII decimal digit — str.isdigit admits Unicode digits ('²') that
    float() rejects, turning a lex into a raw ValueError (review r3)."""
    return "0" <= ch <= "9"


def tokenize(source: str) -> list[Token]:
    toks: list[Token] = []
    i, n = 0, len(source)
    line, col = 1, 1

    def bump(k: int) -> None:
        nonlocal i, line, col
        for _ in range(k):
            if i < n and source[i] == "\n":
                line += 1
                col = 1
            else:
                col += 1
            i += 1

    while i < n:
        c = source[i]
        if c in " \t\r\n":
            bump(1)
            continue
        if c == "#":
            while i < n and source[i] != "\n":
                bump(1)
            continue
        if source.startswith("/*", i):
            start_line, start_col = line, col
            bump(2)
            while i < n and not source.startswith("*/", i):
                bump(1)
            if i >= n:
                raise MMSyntaxError(
                    "unterminated block comment", Span(start_line, start_col, i, n), source
                )
            bump(2)
            continue
        start, start_line, start_col = i, line, col
        if _isdigit(c) or (c == "." and i + 1 < n and _isdigit(source[i + 1])):
            j = i
            seen_dot = False
            seen_exp = False
            while j < n:
                ch = source[j]
                if _isdigit(ch):
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    # Not a float dot if part of a `..` (not in grammar, but be safe).
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j + 1 < n and (
                    _isdigit(source[j + 1])
                    or (source[j + 1] in "+-" and j + 2 < n
                        and _isdigit(source[j + 2]))
                ):
                    seen_exp = True
                    j += 2 if source[j + 1] in "+-" else 1
                else:
                    break
            text = source[i:j]
            bump(j - i)
            toks.append(Token("num", text, float(text), Span(start_line, start_col, start, j)))
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (source[j].isalnum() or source[j] == "_"):
                j += 1
            text = source[i:j]
            bump(j - i)
            kind = "kw" if text in KEYWORDS else "ident"
            toks.append(Token(kind, text, text, Span(start_line, start_col, start, j)))
            continue
        if c == '"':
            j = i + 1
            while j < n and source[j] != '"':
                j += 2 if source[j] == "\\" and j + 1 < n else 1
            if j >= n:
                raise MMSyntaxError(
                    "unterminated string", Span(start_line, start_col, start, n), source
                )
            raise MMSyntaxError(
                "string literals are not supported by the MathMap "
                "expression language",
                Span(start_line, start_col, start, j + 1), source)
        for op in OPERATORS:
            if source.startswith(op, i):
                bump(len(op))
                toks.append(Token("op", op, op, Span(start_line, start_col, start, start + len(op))))
                break
        else:
            raise MMSyntaxError(
                f"unexpected character {c!r}", Span(start_line, start_col, start, start + 1), source
            )
    toks.append(Token("eof", "", None, Span(line, col, n, n)))
    return toks
