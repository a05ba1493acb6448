"""XQuery-subset lexer + recursive-descent parser -> source AST.

Covers the paper's query surface (§5.2): FLWOR (for/let/where/return,
multiple for clauses), child-axis path expressions, value comparisons
(eq ne lt le gt ge), and/or, arithmetic (+ - * div), quantified ``some
.. satisfies``, string/numeric literals, sequence construction in
return position, and the builtin functions used by Q1-Q8 (doc,
collection, data, dateTime, decimal, upper-case, year/month/day
extractors, count/sum/min/max/avg).

Every token carries its character offset and every AST node records
the offset it started at (``pos``, equality/hash-exempt), so parse and
translate errors render as caret diagnostics (core.errors.ParseError /
TranslateError) instead of bare exceptions.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional

from repro_torch.core.errors import ParseError

# --- AST -------------------------------------------------------------------

# Source offset of the node, excluded from equality/hash/repr so that
# structurally identical expressions written at different offsets still
# compare equal (the translator dedupes aggregate slots by AST equality).
_POS = dict(default=-1, compare=False, repr=False)


@dataclasses.dataclass(frozen=True)
class Ast:
    pass


@dataclasses.dataclass(frozen=True)
class Lit(Ast):
    value: Any
    typ: str            # "string" | "double" | "integer"
    pos: int = dataclasses.field(**_POS)


@dataclasses.dataclass(frozen=True)
class Ref(Ast):
    name: str
    pos: int = dataclasses.field(**_POS)


@dataclasses.dataclass(frozen=True)
class Path(Ast):
    base: Ast
    steps: tuple[str, ...]
    pos: int = dataclasses.field(**_POS)


@dataclasses.dataclass(frozen=True)
class Fn(Ast):
    name: str
    args: tuple[Ast, ...]
    pos: int = dataclasses.field(**_POS)


@dataclasses.dataclass(frozen=True)
class Bin(Ast):
    op: str             # eq ne lt le gt ge and or add sub mul div
    left: Ast
    right: Ast
    pos: int = dataclasses.field(**_POS)


@dataclasses.dataclass(frozen=True)
class SomeQ(Ast):
    var: str
    source: Ast
    cond: Ast
    pos: int = dataclasses.field(**_POS)


@dataclasses.dataclass(frozen=True)
class Seq(Ast):
    items: tuple[Ast, ...]
    pos: int = dataclasses.field(**_POS)


@dataclasses.dataclass(frozen=True)
class Flwor(Ast):
    clauses: tuple[tuple, ...]   # ("for", name, Ast) | ("let", name, Ast)
    #                            | ("where", Ast)
    #                            | ("groupby", name, Ast)
    #                            | ("orderby", Ast, descending: bool)
    #                            | ("limit", int)
    ret: Ast
    pos: int = dataclasses.field(**_POS)


# --- Lexer -----------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<string>"[^"]*"|'[^']*')
  | (?P<number>\d+\.\d+|\d+)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*(?:-[A-Za-z][A-Za-z0-9_]*)*)
  | (?P<assign>:=)
  | (?P<sym>[()$,/*+-])
""", re.VERBOSE)

KEYWORDS = {"for", "let", "where", "return", "in", "satisfies", "some",
            "group", "by", "order", "ascending", "descending", "limit",
            "eq", "ne", "lt", "le", "gt", "ge", "and", "or", "div"}


def tokenize(text: str) -> list[tuple[str, str, int]]:
    """(kind, value, character offset) triples, ``eof`` terminated."""
    toks: list[tuple[str, str, int]] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise ParseError(f"bad character {text[pos:pos+20]!r}",
                             pos=pos, text=text)
        start, pos = m.start(), m.end()
        kind = m.lastgroup
        val = m.group()
        if kind == "ws":
            continue
        if kind == "name" and val in KEYWORDS:
            toks.append(("kw", val, start))
        elif kind == "string":
            toks.append(("string", val[1:-1], start))
        else:
            toks.append((kind, val, start))
    toks.append(("eof", "", len(text)))
    return toks


# --- Parser ----------------------------------------------------------------


class Parser:
    def __init__(self, text: str) -> None:
        self.text = text
        self.toks = tokenize(text)
        self.i = 0

    # -- helpers
    def peek(self, k: int = 0) -> tuple[str, str]:
        t = self.toks[min(self.i + k, len(self.toks) - 1)]
        return t[0], t[1]

    def pos(self, k: int = 0) -> int:
        return self.toks[min(self.i + k, len(self.toks) - 1)][2]

    def next(self) -> tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t[0], t[1]

    def error(self, message: str, pos: Optional[int] = None) -> ParseError:
        return ParseError(message, pos=self.pos() if pos is None else pos,
                          text=self.text)

    def expect(self, kind: str, val: Optional[str] = None) -> str:
        at = self.pos()
        k, v = self.next()
        if k != kind or (val is not None and v != val):
            raise self.error(
                f"expected {kind}{' ' + repr(val) if val else ''}, "
                f"got {k} {v!r}", pos=at)
        return v

    def accept(self, kind: str, val: Optional[str] = None) -> bool:
        k, v = self.peek()
        if k == kind and (val is None or v == val):
            self.next()
            return True
        return False

    def varname(self) -> str:
        self.expect("sym", "$")
        return self.expect("name")

    # -- grammar
    def parse(self) -> Ast:
        e = self.expr()
        self.expect("eof")
        return e

    def expr(self) -> Ast:
        k, v = self.peek()
        if k == "kw" and v in ("for", "let"):
            return self.flwor()
        if k == "kw" and v == "some":
            return self.some()
        return self.or_expr()

    def flwor(self) -> Ast:
        at = self.pos()
        clauses: list[tuple] = []
        while True:
            k, v = self.peek()
            if k == "kw" and v == "for":
                self.next()
                while True:
                    name = self.varname()
                    self.expect("kw", "in")
                    clauses.append(("for", name, self.expr()))
                    if not self.accept("sym", ","):
                        break
            elif k == "kw" and v == "let":
                self.next()
                name = self.varname()
                self.expect("assign")
                clauses.append(("let", name, self.expr()))
            elif k == "kw" and v == "where":
                self.next()
                clauses.append(("where", self.expr()))
            elif k == "kw" and v == "group":
                self.next()
                self.expect("kw", "by")
                name = self.varname()
                self.expect("assign")
                clauses.append(("groupby", name, self.expr()))
            elif k == "kw" and v == "order":
                self.next()
                self.expect("kw", "by")
                while True:
                    e = self.expr()
                    desc = False
                    if self.accept("kw", "descending"):
                        desc = True
                    else:
                        self.accept("kw", "ascending")
                    clauses.append(("orderby", e, desc))
                    if not self.accept("sym", ","):
                        break
            elif k == "kw" and v == "limit":
                self.next()
                numat = self.pos()
                n = self.expect("number")
                if "." in n:
                    raise self.error(f"limit wants an integer, got {n}",
                                     pos=numat)
                clauses.append(("limit", int(n)))
            elif k == "kw" and v == "return":
                self.next()
                return Flwor(tuple(clauses), self.expr(), pos=at)
            else:
                raise self.error(f"unexpected {k} {v!r} in FLWOR")

    def some(self) -> Ast:
        at = self.pos()
        self.expect("kw", "some")
        var = self.varname()
        self.expect("kw", "in")
        src = self.expr()
        self.expect("kw", "satisfies")
        cond = self.expr()
        return SomeQ(var, src, cond, pos=at)

    def or_expr(self) -> Ast:
        e = self.and_expr()
        while self.accept("kw", "or"):
            e = Bin("or", e, self.and_expr(), pos=e.pos)
        return e

    def and_expr(self) -> Ast:
        e = self.cmp_expr()
        while self.accept("kw", "and"):
            e = Bin("and", e, self.cmp_expr(), pos=e.pos)
        return e

    def cmp_expr(self) -> Ast:
        e = self.add_expr()
        k, v = self.peek()
        if k == "kw" and v in ("eq", "ne", "lt", "le", "gt", "ge"):
            self.next()
            return Bin(v, e, self.add_expr(), pos=e.pos)
        return e

    def add_expr(self) -> Ast:
        e = self.mul_expr()
        while True:
            k, v = self.peek()
            if k == "sym" and v in ("+", "-"):
                self.next()
                e = Bin("add" if v == "+" else "sub", e, self.mul_expr(),
                        pos=e.pos)
            else:
                return e

    def mul_expr(self) -> Ast:
        e = self.unary_expr()
        while True:
            k, v = self.peek()
            if (k == "sym" and v == "*") or (k == "kw" and v == "div"):
                self.next()
                e = Bin("mul" if v == "*" else "div", e,
                        self.unary_expr(), pos=e.pos)
            else:
                return e

    def unary_expr(self) -> Ast:
        at = self.pos()
        if self.accept("sym", "-"):
            inner = self.unary_expr()
            if isinstance(inner, Lit) and inner.typ in ("double",
                                                        "integer"):
                return Lit(-inner.value, inner.typ, pos=at)
            return Bin("sub", Lit(0, "integer", pos=at), inner, pos=at)
        return self.path_expr()

    def path_expr(self) -> Ast:
        at = self.pos()
        e = self.primary()
        steps: list[str] = []
        while self.accept("sym", "/"):
            steps.append(self.expect("name"))
        return Path(e, tuple(steps), pos=at) if steps else e

    def primary(self) -> Ast:
        at = self.pos()
        k, v = self.peek()
        if k == "string":
            self.next()
            return Lit(v, "string", pos=at)
        if k == "number":
            self.next()
            if "." in v:
                return Lit(float(v), "double", pos=at)
            return Lit(int(v), "integer", pos=at)
        if k == "sym" and v == "$":
            return Ref(self.varname(), pos=at)
        if k == "sym" and v == "(":
            self.next()
            items = [self.expr()]
            while self.accept("sym", ","):
                items.append(self.expr())
            self.expect("sym", ")")
            return items[0] if len(items) == 1 else Seq(tuple(items),
                                                        pos=at)
        if k == "name":
            name = v
            if self.peek(1) == ("sym", "("):
                self.next()
                self.next()
                args: list[Ast] = []
                if not self.accept("sym", ")"):
                    args.append(self.expr())
                    while self.accept("sym", ","):
                        args.append(self.expr())
                    self.expect("sym", ")")
                return Fn(name, tuple(args), pos=at)
            self.next()  # bare name (e.g. a type name in casts) — treat
            return Lit(name, "string", pos=at)
        raise self.error(f"unexpected {k} {v!r}")


def parse(text: str) -> Ast:
    return Parser(text).parse()
