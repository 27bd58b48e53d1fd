"""Recursive-descent parser for the MathMap language.

Replaces the reference's bison grammar (`parser.y` [unverified — mount empty,
SURVEY.md §0]). Grammar (C-like precedence, per SURVEY.md §2.1):

    program   := filterdef+ | seq            (bare seq wrapped in a filter)
    filterdef := 'filter' IDENT ['(' params ')'] seq 'end'
    params    := param (',' param)*
    param     := KIND IDENT [':' num '-' num] ['(' default ')']
    seq       := stmt (';' stmt)* [';']
    stmt      := IDENT '=' expr
               | IDENT '[' expr ']' '=' expr
               | expr
    expr      := or_expr
    or_expr   := and_expr (('||'|'xor') and_expr)*
    and_expr  := eq_expr ('&&' eq_expr)*
    eq_expr   := rel_expr (('=='|'!=') rel_expr)*
    rel_expr  := add_expr (('<'|'>'|'<='|'>=') add_expr)*
    add_expr  := mul_expr (('+'|'-') mul_expr)*
    mul_expr  := unary (('*'|'/'|'%') unary)*
    unary     := ('-'|'!') unary | pow_expr
    pow_expr  := postfix ['^' unary]          (right-assoc)
    postfix   := primary ('(' args ')' | '[' expr ']')*
    primary   := NUM | tuple | '(' expr ')' | if | while | do-while
               | TAG ':' unary               (retag cast)
               | IDENT
    tuple     := '[' expr (',' expr)* ']'
    if        := 'if' seq 'then' seq ['else' seq] 'end'
    while     := 'while' seq 'do' seq 'end'
    do-while  := 'do' seq 'while' seq 'end'
"""

from __future__ import annotations

from ..typesys import tags as tagmod
from ..utils.errors import MMSyntaxError, Span
from . import astnodes as A
from .tokens import Token, tokenize

_MAIN_WRAPPER_NAME = "main_expression"


class Parser:
    def __init__(self, source: str):
        self.source = source
        self.toks: list[Token] = tokenize(source)
        self.pos = 0

    # -- token plumbing ----------------------------------------------------
    def peek(self, offset: int = 0) -> Token:
        return self.toks[min(self.pos + offset, len(self.toks) - 1)]

    def next(self) -> Token:
        tok = self.toks[self.pos]
        if tok.kind != "eof":
            self.pos += 1
        return tok

    def at(self, kind: str, text: str | None = None) -> bool:
        tok = self.peek()
        return tok.kind == kind and (text is None or tok.text == text)

    def accept(self, kind: str, text: str | None = None) -> Token | None:
        if self.at(kind, text):
            return self.next()
        return None

    def expect(self, kind: str, text: str | None = None) -> Token:
        tok = self.peek()
        if not self.at(kind, text):
            want = text or kind
            raise MMSyntaxError(f"expected {want!r}, got {tok.text!r}", tok.span, self.source)
        return self.next()

    def err(self, msg: str, span: Span | None = None) -> MMSyntaxError:
        return MMSyntaxError(msg, span or self.peek().span, self.source)

    # -- entry points ------------------------------------------------------
    def parse_program(self) -> A.Program:
        filters = []
        if self.at("kw", "filter"):
            while self.at("kw", "filter"):
                filters.append(self.parse_filterdef())
            self.expect("eof")
        else:
            # Bare expression: wrap in an implicit single-image filter, the
            # GIMP-plugin convention (SURVEY §2.1 front end; `in` bound to the
            # drawable, origVal sampling available).
            body = self.parse_seq()
            self.expect("eof")
            filters.append(
                A.FilterDef(
                    span=body.span,
                    name=_MAIN_WRAPPER_NAME,
                    params=(A.Param(kind="image", name="in"),),
                    body=body,
                )
            )
        return A.Program(span=Span(1, 1, 0, len(self.source)), filters=tuple(filters))

    def parse_filterdef(self) -> A.FilterDef:
        start = self.expect("kw", "filter").span
        name = self.expect("ident").text
        params: tuple = ()
        if self.accept("op", "("):
            plist = []
            if not self.at("op", ")"):
                plist.append(self.parse_param())
                while self.accept("op", ","):
                    plist.append(self.parse_param())
            self.expect("op", ")")
            params = tuple(plist)
        body = self.parse_seq(frozenset({"end"}))
        self.expect("kw", "end")
        # FilterDef.options stays empty: upstream filter option
        # annotations (coordinate-system prefixes [unverified — mount
        # empty]) are not parsed yet; verify the exact grammar per
        # SURVEY §8 when the reference appears.
        return A.FilterDef(span=start, name=name, params=params, body=body,
                           options=())

    def parse_param(self) -> A.Param:
        kind_tok = self.peek()
        if kind_tok.text not in A.USERVAL_KINDS:
            raise self.err(
                f"expected parameter kind {A.USERVAL_KINDS}, got {kind_tok.text!r}", kind_tok.span
            )
        self.next()
        name = self.expect("ident").text
        lo = hi = default = None
        if self.accept("op", ":"):
            lo = self._parse_signed_num()
            self.expect("op", "-")
            hi = self._parse_signed_num()
        if self.accept("op", "("):
            default = self._parse_signed_num()
            self.expect("op", ")")
        return A.Param(span=kind_tok.span, kind=kind_tok.text, name=name, lo=lo, hi=hi, default=default)

    def _parse_signed_num(self) -> float:
        sign = -1.0 if self.accept("op", "-") else 1.0
        tok = self.expect("num")
        return sign * float(tok.value)

    # -- statements ---------------------------------------------------------
    def parse_seq(self, stops: frozenset = frozenset()) -> A.Seq:
        """Parse a `;`-separated statement sequence. `stops` is the set of
        keywords that terminate THIS sequence (its enclosing construct's
        closers, e.g. {'else','end'} for a then-branch)."""
        items = [self.parse_stmt()]
        while self.accept("op", ";"):
            if self._seq_terminator(stops):
                break
            items.append(self.parse_stmt())
        return A.Seq(span=items[0].span, items=tuple(items))

    def _seq_terminator(self, stops: frozenset) -> bool:
        tok = self.peek()
        return tok.kind == "eof" or (tok.kind == "kw" and tok.text in stops)

    def _at_do_while_terminator(self) -> bool:
        """Inside a do-while body, at a statement boundary: does a
        terminating `while <cond> end` start here? A nested while
        STATEMENT parses as `while <cond> do`, so tentatively parse the
        cond (state restored) and look at the keyword after it."""
        tok = self.peek()
        if tok.kind == "eof":
            return True
        if not (tok.kind == "kw" and tok.text == "while"):
            return False
        save = self.pos
        try:
            self.next()
            self.parse_seq(frozenset({"do", "end"}))
            nxt = self.peek()
            return nxt.kind == "kw" and nxt.text == "end"
        except MMSyntaxError:
            return True  # let the terminator path surface the error
        finally:
            self.pos = save

    def parse_stmt(self) -> A.Node:
        return self.parse_expr()

    # -- expressions ---------------------------------------------------------
    def parse_expr(self) -> A.Node:
        # Assignment and sub-assignment are EXPRESSIONS in the reference's
        # bison grammar (exprtree assign/sub-assign NODE kinds, SURVEY
        # §2.1 — the language is expression-oriented): `x = y = 1` nests
        # right-associatively and yields the assigned value, and
        # `q = (p = 2) * 3` is valid. Previously recognized only at
        # statement level (review r5). _eval_Assign/_eval_SubAssign
        # already return the assigned value.
        if self.at("ident"):
            nxt = self.peek(1)
            if nxt.kind == "op" and nxt.text == "=":
                name_tok = self.next()
                self.next()  # '='
                expr = self.parse_expr()
                return A.Assign(span=name_tok.span, name=name_tok.text, expr=expr)
            if nxt.kind == "op" and nxt.text == "[":
                # Could be `v[i] = e` (sub-assignment) or just an index expr.
                save = self.pos
                name_tok = self.next()
                self.next()  # '['
                index = self.parse_expr()
                if self.accept("op", "]") and self.accept("op", "="):
                    expr = self.parse_expr()
                    return A.SubAssign(span=name_tok.span, name=name_tok.text, index=index, expr=expr)
                self.pos = save
        return self.parse_or()

    def _binop_chain(self, sub, ops):
        left = sub()
        while self.peek().kind in ("op", "kw") and self.peek().text in ops:
            op = self.next()
            right = sub()
            left = A.BinOp(span=op.span, op=op.text, left=left, right=right)
        return left

    def parse_or(self) -> A.Node:
        return self._binop_chain(self.parse_and, ("||", "xor"))

    def parse_and(self) -> A.Node:
        return self._binop_chain(self.parse_eq, ("&&",))

    def parse_eq(self) -> A.Node:
        return self._binop_chain(self.parse_rel, ("==", "!="))

    def parse_rel(self) -> A.Node:
        return self._binop_chain(self.parse_add, ("<", ">", "<=", ">="))

    def parse_add(self) -> A.Node:
        return self._binop_chain(self.parse_mul, ("+", "-"))

    def parse_mul(self) -> A.Node:
        return self._binop_chain(self.parse_unary, ("*", "/", "%"))

    def parse_unary(self) -> A.Node:
        tok = self.peek()
        if tok.kind == "op" and tok.text in ("-", "!"):
            self.next()
            operand = self.parse_unary()
            return A.UnOp(span=tok.span, op=tok.text, operand=operand)
        return self.parse_pow()

    def parse_pow(self) -> A.Node:
        base = self.parse_postfix()
        if self.at("op", "^"):
            op = self.next()
            # right-assoc; exponent may itself be unary (e.g. x^-2)
            exp = self.parse_unary()
            return A.BinOp(span=op.span, op="^", left=base, right=exp)
        return base

    def parse_postfix(self) -> A.Node:
        node = self.parse_primary()
        while True:
            if self.at("op", "("):
                self.next()
                args = []
                if not self.at("op", ")"):
                    args.append(self.parse_expr())
                    while self.accept("op", ","):
                        args.append(self.parse_expr())
                self.expect("op", ")")
                node = A.Call(span=node.span, func=node, args=tuple(args))
            elif self.at("op", "["):
                self.next()
                index = self.parse_expr()
                self.expect("op", "]")
                node = A.Subscript(span=node.span, base=node, index=index)
            else:
                return node

    def parse_primary(self) -> A.Node:
        tok = self.peek()
        if tok.kind == "num":
            self.next()
            return A.Num(span=tok.span, value=float(tok.value))
        if tok.kind == "op" and tok.text == "(":
            self.next()
            inner = self.parse_expr()
            self.expect("op", ")")
            return inner
        if tok.kind == "op" and tok.text == "[":
            self.next()
            items = [self.parse_expr()]
            while self.accept("op", ","):
                items.append(self.parse_expr())
            self.expect("op", "]")
            return A.TupleLit(span=tok.span, items=tuple(items))
        if tok.kind == "kw" and tok.text == "if":
            return self.parse_if()
        if tok.kind == "kw" and tok.text == "while":
            self.next()
            cond = self.parse_seq(frozenset({"do"}))
            self.expect("kw", "do")
            body = self.parse_seq(frozenset({"end"}))
            self.expect("kw", "end")
            return A.While(span=tok.span, cond=cond, body=body, post=False)
        if tok.kind == "kw" and tok.text == "do":
            # do <body> while <cond> end — a `while` inside the body is
            # ambiguous: nested while STATEMENT (`while c do ... end`) vs
            # the do-while terminator (`while c end`). Disambiguate by
            # tentatively parsing the cond and checking the keyword after
            # it (review r3: plain stops={'while'} made nested loops
            # unparseable inside do-while bodies).
            self.next()
            items = [self.parse_stmt()]
            while self.accept("op", ";"):
                if self._at_do_while_terminator():
                    break
                items.append(self.parse_stmt())
            body = A.Seq(span=items[0].span, items=tuple(items))
            self.expect("kw", "while")
            cond = self.parse_seq(frozenset({"end"}))
            self.expect("kw", "end")
            return A.While(span=tok.span, cond=cond, body=body, post=True)
        if tok.kind == "ident":
            # `tag:expr` retag cast (tags.c `:` operator). ANY identifier
            # followed by ':' is a tag — the reference's registry INTERNS
            # tag names, so user tags like `foo:[1, 2]` are valid source
            # (review r5: gating on KNOWN_TAGS made register_tag
            # unreachable from the language and rejected user tags with a
            # misleading "expected eof, got ':'"). Unknown tags carry no
            # arity constraint (tag_length None); ops dispatch on the tag
            # name either way.
            if self.peek(1).kind == "op" and self.peek(1).text == ":":
                self.next()
                self.next()  # ':'
                operand = self.parse_unary()
                return A.Cast(span=tok.span, tag=tok.text, expr=operand)
            self.next()
            return A.Var(span=tok.span, name=tok.text)
        raise self.err(f"unexpected token {tok.text!r}")

    def parse_if(self) -> A.If:
        tok = self.expect("kw", "if")
        cond = self.parse_seq(frozenset({"then"}))
        self.expect("kw", "then")
        then = self.parse_seq(frozenset({"else", "end"}))
        orelse = None
        if self.accept("kw", "else"):
            orelse = self.parse_seq(frozenset({"end"}))
        self.expect("kw", "end")
        return A.If(span=tok.span, cond=cond, then=then, orelse=orelse)


def parse(source: str) -> A.Program:
    return Parser(source).parse_program()
