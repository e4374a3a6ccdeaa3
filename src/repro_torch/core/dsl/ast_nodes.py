"""Resolved DSL AST (§6.3-§6.4).  A copy of ``repro.core.dsl.ast_nodes``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class Pos:
    line: int = 0
    col: int = 0


@dataclass
class BoolExpr:
    pass


@dataclass
class SignalRefExpr(BoolExpr):
    type: str
    name: str
    pos: Pos = field(default_factory=Pos)


@dataclass
class BoolAnd(BoolExpr):
    children: List[BoolExpr] = field(default_factory=list)


@dataclass
class BoolOr(BoolExpr):
    children: List[BoolExpr] = field(default_factory=list)


@dataclass
class BoolNot(BoolExpr):
    child: BoolExpr = None


@dataclass
class SignalDecl:
    type: str
    name: str
    config: Dict[str, Any]
    pos: Pos = field(default_factory=Pos)


@dataclass
class PluginDecl:
    name: str
    type: str
    config: Dict[str, Any]
    pos: Pos = field(default_factory=Pos)


@dataclass
class ModelDecl:
    name: str
    params: Dict[str, Any] = field(default_factory=dict)


@dataclass
class RouteDecl:
    name: str
    description: str = ""
    priority: int = 0
    when: Optional[BoolExpr] = None
    models: List[ModelDecl] = field(default_factory=list)
    algorithm: Optional[str] = None
    algorithm_config: Dict[str, Any] = field(default_factory=dict)
    plugin_refs: List[str] = field(default_factory=list)
    inline_plugins: List[PluginDecl] = field(default_factory=list)
    slo: Optional[Dict[str, Any]] = None
    pos: Pos = field(default_factory=Pos)


@dataclass
class BackendDecl:
    name: str
    type: str
    config: Dict[str, Any]
    pos: Pos = field(default_factory=Pos)


@dataclass
class GlobalDecl:
    config: Dict[str, Any] = field(default_factory=dict)
    pos: Pos = field(default_factory=Pos)


@dataclass
class Diagnostic:
    level: int          # 1 error, 2 warning, 3 constraint, 4 semantic (L4)
    message: str
    line: int = 0
    col: int = 0
    quickfix: Optional[str] = None
    # Level-4 payload: verifier findings carry a concrete witness signal
    # assignment ({"type:name": bool, ...}) and a fatal flag — fatal
    # findings reject a policy in lint-strict compile/hot-reload/CI.
    witness: Optional[Dict[str, bool]] = None
    fatal: bool = False

    def __str__(self):
        lvl = {1: "ERROR", 2: "WARNING", 3: "CONSTRAINT",
               4: "L4-FATAL" if self.fatal else "L4"}[self.level]
        qf = f"  (did you mean {self.quickfix!r}?)" if self.quickfix else ""
        wit = ""
        if self.witness is not None:
            bits = ", ".join(f"{k}={int(v)}"
                             for k, v in sorted(self.witness.items()))
            wit = f"  witness: {{{bits}}}"
        return f"[{lvl}] {self.line}:{self.col} {self.message}{qf}{wit}"


@dataclass
class Program:
    signals: List[SignalDecl] = field(default_factory=list)
    plugins: List[PluginDecl] = field(default_factory=list)
    routes: List[RouteDecl] = field(default_factory=list)
    backends: List[BackendDecl] = field(default_factory=list)
    global_: Optional[GlobalDecl] = None
    diagnostics: List[Diagnostic] = field(default_factory=list)
