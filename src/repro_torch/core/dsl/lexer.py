"""DSL lexer (§6.3): 12 token classes with position tracking.  A copy of ``repro.core.dsl.lexer``."""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List

TOKEN_SPEC = [
    ("COMMENT", r"(#|//)[^\n]*"),
    ("FLOAT", r"-?\d+\.\d+"),
    ("INT", r"-?\d+"),
    ("STRING", r'"(?:[^"\\]|\\.)*"'),
    ("BOOL", r"\b(true|false)\b"),
    ("IDENT", r"[A-Za-z_][A-Za-z0-9_.\-]*"),
    ("LBRACE", r"\{"), ("RBRACE", r"\}"),
    ("LPAREN", r"\("), ("RPAREN", r"\)"),
    ("LBRACKET", r"\["), ("RBRACKET", r"\]"),
    ("COLON", r":"), ("COMMA", r","), ("EQUALS", r"="),
    ("NEWLINE", r"\n"), ("WS", r"[ \t\r]+"),
]

_MASTER = re.compile("|".join(f"(?P<{n}>{p})" for n, p in TOKEN_SPEC))

KEYWORDS = {"SIGNAL", "ROUTE", "PLUGIN", "BACKEND", "GLOBAL",
            "PRIORITY", "WHEN", "MODEL", "ALGORITHM", "SLO",
            "AND", "OR", "NOT"}


@dataclass
class Token:
    kind: str
    value: str
    line: int
    col: int

    def __repr__(self):
        return f"{self.kind}({self.value!r}@{self.line}:{self.col})"


class LexError(Exception):
    def __init__(self, msg, line, col):
        super().__init__(f"{msg} at {line}:{col}")
        self.line, self.col = line, col


def lex(src: str) -> List[Token]:
    tokens: List[Token] = []
    line, col = 1, 1
    pos = 0
    while pos < len(src):
        m = _MASTER.match(src, pos)
        if not m:
            raise LexError(f"unexpected character {src[pos]!r}", line, col)
        kind = m.lastgroup
        text = m.group()
        if kind == "NEWLINE":
            line += 1
            col = 1
        else:
            if kind not in ("WS", "COMMENT"):
                if kind == "IDENT" and text.upper() in KEYWORDS and \
                        text == text.upper():
                    tokens.append(Token("KEYWORD", text, line, col))
                else:
                    tokens.append(Token(kind, text, line, col))
            col += len(text)
        pos = m.end()
    tokens.append(Token("EOF", "", line, col))
    return tokens
