"""Minimal s-expression reader/writer (a copy of
`mathmap_tpu/designer/sexpr.py`).

Reference: `lispreader/` — the s-expression reader used for `.mmc` composer
files (SURVEY.md §1 layer 1 [unverified — mount empty, SURVEY.md §0]).
Values: symbols (str), numbers (float), strings (str tagged by quoting),
nested lists.
"""

from __future__ import annotations

from ..utils.errors import MMSyntaxError


class Symbol(str):
    """A bare symbol (distinct from a quoted string)."""

    __slots__ = ()


def loads(text: str):
    """Parse one or more s-expressions; returns a list of top-level forms."""
    pos = 0
    n = len(text)

    def skip_ws():
        nonlocal pos
        while pos < n:
            if text[pos] in " \t\r\n":
                pos += 1
            elif text[pos] == ";":
                while pos < n and text[pos] != "\n":
                    pos += 1
            else:
                break

    def parse_form():
        nonlocal pos
        skip_ws()
        if pos >= n:
            raise MMSyntaxError("unexpected end of s-expression")
        c = text[pos]
        if c == "(":
            pos += 1
            items = []
            while True:
                skip_ws()
                if pos >= n:
                    raise MMSyntaxError("unclosed '(' in s-expression")
                if text[pos] == ")":
                    pos += 1
                    return items
                items.append(parse_form())
        if c == ")":
            raise MMSyntaxError("unexpected ')' in s-expression")
        if c == '"':
            pos += 1
            out = []
            while pos < n and text[pos] != '"':
                if text[pos] == "\\" and pos + 1 < n:
                    pos += 1
                out.append(text[pos])
                pos += 1
            if pos >= n:
                raise MMSyntaxError("unclosed string in s-expression")
            pos += 1
            return "".join(out)
        # atom
        start = pos
        while pos < n and text[pos] not in " \t\r\n()\";":
            pos += 1
        atom = text[start:pos]
        try:
            return float(atom)
        except ValueError:
            return Symbol(atom)

    forms = []
    while True:
        skip_ws()
        if pos >= n:
            return forms
        forms.append(parse_form())


def dumps(form, indent: int = 0) -> str:
    if isinstance(form, list):
        inner = " ".join(dumps(x) for x in form)
        return f"({inner})"
    if isinstance(form, Symbol):
        return str(form)
    if isinstance(form, str):
        escaped = form.replace("\\", "\\\\").replace('"', '\\"')
        return f'"{escaped}"'
    if isinstance(form, float) and form.is_integer():
        return str(int(form))
    return repr(form)
