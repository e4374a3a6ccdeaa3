"""Engine lint plane of the port (``repro.analysis.jaxpr_lint``' twin):
dynamic passes over the aten ops a hot-path function runs.

The reference walks the jaxpr of a jitted function.  The port runs
eagerly, so :func:`lint_fn` runs the function once under a dispatch mode
(``OpLint``) and checks every aten op it dispatches:

* **materialized-intermediate**: an output above an element budget;
* **banned-shape**: an output whose leading dims match a caller-supplied
  blacklist (the paged decode's contract: no gathered ``(B,
  max_blocks * block_tokens, ...)`` KV view);
* **host-sync** (the reference's host-callback): ops that wait for the
  device and bring a value to the host — ``.item()``
  (``_local_scalar_dense``), ``is_nonzero``, ops whose output size
  depends on the data (``nonzero``, ``masked_select``, ``unique``...),
  and a copy whose destination is on the host and whose source is not.

A hand-written kernel's call is one opaque region (``kernels.observed``):
what its plain version does on the CPU is the kernel's own, as a
``pallas_call`` is one primitive of a jaxpr.

:func:`jit_cache_size` / :class:`RecompileGuard`.  The port compiles at
one point: ``kernels._build`` runs ``nvcc`` and loads a library at first
use, so a cold build inside a request is the multi-second stall the
reference's guard exists to catch.  ``_build`` counts its builds and
loads (``_build.COUNTERS``); the guard probes those counters by name
(``build_counters()``) beside any object with a ``cache_size()``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import kernels
from repro_torch.kernels import _build

__all__ = ["LintFinding", "OpLint", "lint_fn", "jit_cache_size",
           "build_counters", "RecompileGuard", "HOST_SYNC_OPS"]

# ops that wait for the device and hand a value (or an output size) to the
# host: never acceptable inside a serving hot path
HOST_SYNC_OPS = frozenset({
    "aten._local_scalar_dense", "aten.is_nonzero", "aten.nonzero",
    "aten.masked_select", "aten.unique", "aten._unique", "aten._unique2",
    "aten.unique_dim", "aten.unique_consecutive", "aten.bincount",
    "aten.argwhere", "aten.repeat_interleave.Tensor",
    "aten.repeat_interleave.self_Tensor",
})
_COPIES = frozenset({"aten._to_copy", "aten.copy_", "aten._copy_from",
                     "aten._copy_from_and_resize"})


@dataclass
class LintFinding:
    rule: str                       # materialized-intermediate |
    #                                 banned-shape | host-sync
    message: str
    op: str = ""
    shape: Tuple[int, ...] = ()

    def __str__(self):
        return f"[{self.rule}] {self.message}"


def _elems(shape: Sequence[int]) -> int:
    return math.prod(int(s) for s in shape)


def _to_host(name: str, args, kwargs, out) -> bool:
    """A copy whose destination is on the host and whose source is not."""
    if name not in _COPIES:
        return False
    if name == "aten._to_copy":
        src, dst = args[0], out
    else:                            # copy_(dst, src) and friends
        dst, src = args[0], args[1]
    return (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)
            and dst.device.type == "cpu" and src.device.type != "cpu")


class OpLint(TorchDispatchMode):
    """Collects :class:`LintFinding`\\ s of every op run inside it (outside
    kernel regions)."""

    def __init__(self, *, max_intermediate_elems: Optional[int] = None,
                 banned_leading_shapes: Sequence[Tuple[int, ...]] = (),
                 forbid_host_syncs: bool = True):
        super().__init__()
        self.budget = max_intermediate_elems
        self.banned = {tuple(int(x) for x in s)
                       for s in banned_leading_shapes if s}
        self.forbid_host_syncs = forbid_host_syncs
        self.findings: List[LintFinding] = []
        self.opaque = 0

    # -- kernels.observed: a kernel is one opaque op -------------------------

    values = None                   # no costs wanted

    def note_kernel(self, name, cost) -> None:
        pass

    def __enter__(self):
        kernels.OBSERVERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            kernels.OBSERVERS.remove(self)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.opaque:
            return out
        name = str(func.overloadpacket)
        if self.forbid_host_syncs and (
                name in HOST_SYNC_OPS or
                f"{name}.{func._overloadname}" in HOST_SYNC_OPS or
                _to_host(name, args, kwargs, out)):
            self.findings.append(LintFinding(
                "host-sync", f"{name} in hot path (device->host sync)",
                op=name))
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if not isinstance(o, torch.Tensor):
                continue
            shape = tuple(o.shape)
            if any(shape[:len(b)] == b for b in self.banned):
                self.findings.append(LintFinding(
                    "banned-shape", f"{name} materializes banned shape "
                    f"{shape}", op=name, shape=shape))
            elif self.budget is not None and _elems(shape) > self.budget:
                self.findings.append(LintFinding(
                    "materialized-intermediate",
                    f"{name} materializes {_elems(shape)} elements {shape} "
                    f"> budget {self.budget}", op=name, shape=shape))
        return out


def lint_fn(fn, *args, max_intermediate_elems: Optional[int] = None,
            banned_leading_shapes: Sequence[Tuple[int, ...]] = (),
            forbid_host_syncs: bool = True, **kwargs) -> List[LintFinding]:
    """Run ``fn(*args, **kwargs)`` once, eagerly, and lint every aten op
    it dispatches (kernel regions stay opaque)."""
    with OpLint(max_intermediate_elems=max_intermediate_elems,
                banned_leading_shapes=banned_leading_shapes,
                forbid_host_syncs=forbid_host_syncs) as lint:
        fn(*args, **kwargs)
    return lint.findings


# ---------------------------------------------------------------------------
# recompile accounting
# ---------------------------------------------------------------------------

def jit_cache_size(fn) -> int:
    """``fn.cache_size()`` for an object that has one (a compiled
    function's cache entries, a ``build_counters()`` probe), else -1 — as
    the reference's probe gives for a plain function."""
    probe = getattr(fn, "cache_size", None)
    if probe is None:
        return -1
    try:
        return int(probe())
    except (TypeError, ValueError, RuntimeError):
        return -1


class _Counter:
    def __init__(self, key: str):
        self.key = key

    def cache_size(self) -> int:
        return _build.COUNTERS[self.key]


def build_counters() -> Dict[str, Any]:
    """Probes of the kernel build's counters (``nvcc`` builds and library
    loads), for a :class:`RecompileGuard`: a warmed serving path takes
    neither."""
    return {f"kernels.{k}": _Counter(k) for k in _build.COUNTERS}


@dataclass
class RecompileGuard:
    """Assert that a set of warmed probes (``build_counters()``, objects
    with ``cache_size()``) take ZERO new entries across a code region::

        guard = RecompileGuard(build_counters())
        ... replay already-warmed steps ...
        guard.assert_no_recompiles()

    ``misses()`` returns the per-name delta for reporting."""
    fns: Dict[str, Any]
    _baseline: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        self._baseline = {name: jit_cache_size(fn)
                          for name, fn in self.fns.items()}

    def misses(self) -> Dict[str, int]:
        return {name: jit_cache_size(fn) - self._baseline[name]
                for name, fn in self.fns.items()}

    def assert_no_recompiles(self):
        bad = {n: d for n, d in self.misses().items() if d > 0}
        if bad:
            raise AssertionError(f"unexpected recompiles or kernel builds: "
                                 f"{bad}")
