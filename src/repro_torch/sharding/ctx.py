"""Activation-sharding context of the port (``repro.sharding.ctx``' twin).

The serving steps of a sharded member run inside ``sharding_rules(mesh,
rules)``: model code finds the rank mesh there (``current_rules``), as the
reference's ``moe_ep`` and ``smdec`` find theirs.  ``constrain(x, name)``
is the identity: each rank holds its local block already, so there is no
layout for a constraint to impose (the reference lowers it to
``with_sharding_constraint`` for GSPMD).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict

_state = threading.local()


def current_rules():
    """(rules, mesh) installed on this thread, or (None, None)."""
    return getattr(_state, "rules", None), getattr(_state, "mesh", None)


def current_mesh():
    """The mesh installed on this thread, or None."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def sharding_rules(mesh, rules: Dict[str, tuple]):
    prev = current_rules()
    _state.rules, _state.mesh = rules, mesh
    try:
        yield
    finally:
        _state.rules, _state.mesh = prev


def constrain(x, name: str):
    return x
