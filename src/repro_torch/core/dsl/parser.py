"""Recursive-descent DSL parser (§6.3) with block-granular error recovery:
a failure inside one top-level block records a Level-1 diagnostic and
resumes at the next block keyword, so one bad block never hides the rest.
A copy of ``repro.core.dsl.parser``.
"""

from __future__ import annotations

from typing import Any, Dict, List

from repro_torch.core.dsl.ast_nodes import (BackendDecl, BoolAnd, BoolExpr, BoolNot,
                                            BoolOr, Diagnostic, GlobalDecl,
                                            ModelDecl, PluginDecl, Pos, Program,
                                            RouteDecl, SignalDecl, SignalRefExpr)
from repro_torch.core.dsl.lexer import LexError, Token, lex

TOP_KEYWORDS = ("SIGNAL", "ROUTE", "PLUGIN", "BACKEND", "GLOBAL")


class ParseError(Exception):
    def __init__(self, msg: str, tok: Token):
        super().__init__(f"{msg} (got {tok.kind} {tok.value!r} "
                         f"at {tok.line}:{tok.col})")
        self.tok = tok
        self.msg = msg


class Parser:
    def __init__(self, tokens: List[Token]):
        self.toks = tokens
        self.i = 0

    # -- token helpers ------------------------------------------------------
    def peek(self, off=0) -> Token:
        return self.toks[min(self.i + off, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.peek()
        self.i += 1
        return t

    def expect(self, kind: str, value=None) -> Token:
        t = self.peek()
        if t.kind != kind or (value is not None and t.value != value):
            raise ParseError(f"expected {value or kind}", t)
        return self.next()

    def at_keyword(self, kw: str) -> bool:
        t = self.peek()
        return t.kind == "KEYWORD" and t.value == kw

    # -- values ---------------------------------------------------------------
    def parse_value(self):
        t = self.peek()
        if t.kind == "STRING":
            self.next()
            return t.value[1:-1].replace('\\"', '"')
        if t.kind == "INT":
            self.next()
            return int(t.value)
        if t.kind == "FLOAT":
            self.next()
            return float(t.value)
        if t.kind == "BOOL":
            self.next()
            return t.value == "true"
        if t.kind == "LBRACKET":
            self.next()
            out = []
            while self.peek().kind != "RBRACKET":
                out.append(self.parse_value())
                if self.peek().kind == "COMMA":
                    self.next()
            self.expect("RBRACKET")
            return out
        if t.kind == "LBRACE":
            return self.parse_block()
        if t.kind == "IDENT":
            self.next()
            return t.value
        raise ParseError("expected value", t)

    def parse_block(self) -> Dict[str, Any]:
        self.expect("LBRACE")
        out: Dict[str, Any] = {}
        while self.peek().kind != "RBRACE":
            key_tok = self.peek()
            if key_tok.kind not in ("IDENT", "KEYWORD", "STRING"):
                raise ParseError("expected config key", key_tok)
            self.next()
            key = key_tok.value.strip('"')
            self.expect("COLON")
            out[key] = self.parse_value()
            if self.peek().kind == "COMMA":
                self.next()
        self.expect("RBRACE")
        return out

    def parse_paren_params(self) -> Dict[str, Any]:
        """(key = value, ...)"""
        out: Dict[str, Any] = {}
        if self.peek().kind != "LPAREN":
            return out
        self.next()
        while self.peek().kind != "RPAREN":
            key = self.next().value
            self.expect("EQUALS")
            out[key] = self.parse_value()
            if self.peek().kind == "COMMA":
                self.next()
        self.expect("RPAREN")
        return out

    # -- WHEN grammar (Equations 16-19): OR < AND < NOT < atom ----------------
    def parse_bool(self) -> BoolExpr:
        left = self.parse_and()
        terms = [left]
        while self.at_keyword("OR"):
            self.next()
            terms.append(self.parse_and())
        return terms[0] if len(terms) == 1 else BoolOr(terms)

    def parse_and(self) -> BoolExpr:
        terms = [self.parse_factor()]
        while self.at_keyword("AND"):
            self.next()
            terms.append(self.parse_factor())
        return terms[0] if len(terms) == 1 else BoolAnd(terms)

    def parse_factor(self) -> BoolExpr:
        if self.at_keyword("NOT"):
            self.next()
            return BoolNot(self.parse_factor())
        if self.peek().kind == "LPAREN":
            self.next()
            e = self.parse_bool()
            self.expect("RPAREN")
            return e
        t = self.expect("IDENT")
        self.expect("LPAREN")
        name = self.expect("STRING").value[1:-1]
        self.expect("RPAREN")
        return SignalRefExpr(t.value, name, Pos(t.line, t.col))

    # -- blocks -----------------------------------------------------------------
    def parse_signal(self) -> SignalDecl:
        kw = self.expect("KEYWORD", "SIGNAL")
        type_ = self.expect("IDENT").value
        name = self.expect("IDENT").value
        cfg = self.parse_block()
        return SignalDecl(type_, name, cfg, Pos(kw.line, kw.col))

    def parse_plugin(self) -> PluginDecl:
        kw = self.expect("KEYWORD", "PLUGIN")
        name = self.expect("IDENT").value
        type_ = self.expect("IDENT").value
        cfg = self.parse_block()
        return PluginDecl(name, type_, cfg, Pos(kw.line, kw.col))

    def parse_backend(self) -> BackendDecl:
        kw = self.expect("KEYWORD", "BACKEND")
        name = self.expect("IDENT").value
        type_ = self.expect("IDENT").value
        cfg = self.parse_block()
        return BackendDecl(name, type_, cfg, Pos(kw.line, kw.col))

    def parse_global(self) -> GlobalDecl:
        kw = self.expect("KEYWORD", "GLOBAL")
        return GlobalDecl(self.parse_block(), Pos(kw.line, kw.col))

    def parse_route(self) -> RouteDecl:
        kw = self.expect("KEYWORD", "ROUTE")
        name = self.expect("IDENT").value
        route = RouteDecl(name, pos=Pos(kw.line, kw.col))
        params = self.parse_paren_params()
        route.description = params.get("description", "")
        self.expect("LBRACE")
        while self.peek().kind != "RBRACE":
            t = self.peek()
            if self.at_keyword("PRIORITY"):
                self.next()
                route.priority = int(self.next().value)
            elif self.at_keyword("WHEN"):
                self.next()
                route.when = self.parse_bool()
            elif self.at_keyword("MODEL"):
                self.next()
                while True:
                    mname = self.expect("STRING").value[1:-1]
                    mparams = self.parse_paren_params()
                    route.models.append(ModelDecl(mname, mparams))
                    if self.peek().kind == "COMMA":
                        self.next()
                        continue
                    break
            elif self.at_keyword("ALGORITHM"):
                self.next()
                route.algorithm = self.next().value
                if self.peek().kind == "LBRACE":
                    route.algorithm_config = self.parse_block()
            elif self.at_keyword("SLO"):
                self.next()
                route.slo = self.parse_block()
            elif self.at_keyword("PLUGIN"):
                self.next()
                pname = self.expect("IDENT").value
                if self.peek().kind == "IDENT":       # inline: PLUGIN n type {..}
                    ptype = self.next().value
                    cfg = self.parse_block()
                    route.inline_plugins.append(
                        PluginDecl(pname, ptype, cfg))
                else:                                  # template reference
                    route.plugin_refs.append(pname)
            else:
                raise ParseError("unexpected token in ROUTE body", t)
        self.expect("RBRACE")
        return route

    # -- program with block-granular recovery -------------------------------------
    def parse_program(self) -> Program:
        prog = Program()
        while self.peek().kind != "EOF":
            t = self.peek()
            if t.kind != "KEYWORD" or t.value not in TOP_KEYWORDS:
                prog.diagnostics.append(Diagnostic(
                    1, f"expected top-level block, got {t.value!r}",
                    t.line, t.col))
                self._recover()
                continue
            try:
                if t.value == "SIGNAL":
                    prog.signals.append(self.parse_signal())
                elif t.value == "PLUGIN":
                    prog.plugins.append(self.parse_plugin())
                elif t.value == "ROUTE":
                    prog.routes.append(self.parse_route())
                elif t.value == "BACKEND":
                    prog.backends.append(self.parse_backend())
                elif t.value == "GLOBAL":
                    prog.global_ = self.parse_global()
            except ParseError as e:
                prog.diagnostics.append(Diagnostic(
                    1, e.msg, e.tok.line, e.tok.col))
                self._recover()
        return prog

    def _recover(self):
        """Skip to the next top-level keyword (balanced over braces)."""
        depth = 0
        self.i += 1
        while self.peek().kind != "EOF":
            t = self.peek()
            if t.kind == "LBRACE":
                depth += 1
            elif t.kind == "RBRACE":
                depth = max(0, depth - 1)
            elif depth == 0 and t.kind == "KEYWORD" and \
                    t.value in TOP_KEYWORDS:
                return
            self.i += 1


def parse(src: str) -> Program:
    try:
        tokens = lex(src)
    except LexError as e:
        p = Program()
        p.diagnostics.append(Diagnostic(1, str(e), e.line, e.col))
        return p
    return Parser(tokens).parse_program()
