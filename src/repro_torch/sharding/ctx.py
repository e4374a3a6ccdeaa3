"""Activation-sharding context of the port (``repro.sharding.ctx``' twin).

The serving steps of a sharded member run inside ``sharding_rules(mesh,
rules)``: model code finds the rank mesh there (``current_rules``), as the
reference's ``moe_ep`` and ``smdec`` find theirs.  ``constrain(x, name)``
is the identity: each rank holds its local block already, so there is no
layout for a constraint to impose (the reference lowers it to
``with_sharding_constraint`` for GSPMD).

The serving steps keep the batch whole on every rank.  The train step
(``training.train_lib.build_train_step``) installs its rules with
``rows=True``: the batch is then split as ``rules["act.res"]`` says (the
reference's ``P(dp, None, None)``), each rank's activations hold its rows
only, and ``row_axes()`` names the axes the rows are split over.
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


def row_axes() -> tuple:
    """The mesh axes the batch rows of this thread's activations are split
    over (the rank holds its rows only); () when every rank holds the
    whole batch."""
    return getattr(_state, "rows", ())


@contextlib.contextmanager
def sharding_rules(mesh, rules: Dict[str, tuple], *, rows: bool = False):
    """Install ``mesh`` and ``rules`` on this thread.  ``rows``: the
    activations hold the rank's rows of a batch split over the axes of
    ``rules["act.res"][0]``."""
    prev = capture()
    split = ()
    if rows:
        ax = rules["act.res"][0]
        split = () if ax is None else (ax if isinstance(ax, tuple) else
                                       (ax,))
    _state.rules, _state.mesh, _state.rows = rules, mesh, split
    try:
        yield
    finally:
        _state.rules, _state.mesh, _state.rows = prev


def capture() -> tuple:
    """This thread's rules, mesh and row axes, for ``installed``."""
    return current_rules() + (row_axes(),)


@contextlib.contextmanager
def installed(state: tuple):
    """Install a ``capture()``d state on this thread: the recompute of a
    checkpointed block runs in the backward pass, on autograd's thread for
    the device (not the caller's, on the card)."""
    prev = capture()
    _state.rules, _state.mesh, _state.rows = state
    try:
        yield
    finally:
        _state.rules, _state.mesh, _state.rows = prev


def constrain(x, name: str):
    return x
