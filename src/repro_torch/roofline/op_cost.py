"""Dispatch-level cost model of a step (``repro.roofline.hlo_cost``' twin).

The reference costs compiled HLO text.  The port runs eagerly and has no
HLO, so ``CostMode``, a ``TorchDispatchMode``, sees every aten op a step
runs and records it as a *signature*: the op's name, its kind (view,
in-place, indexed write, or plain op), and each argument and output
(tensors as shape, dtype, whether it lies on the step's device, whether
the op writes it).  Identical signatures are counted, not repeated.  The
totals are a function of the signatures alone (``signature_cost``), so
an archived trace (``<tag>.ops.json.gz``, ``roofline.reanalyze``)
re-derives the same numbers without a re-trace:

* **FLOPs** by dtype, from ``torch.utils.flop_counter``'s registered
  formulas (the matmul, attention and convolution ops), in the dtype of
  the op's first tensor;
* **bytes**: each device input read once and each device output written
  once; views and allocations count 0; an in-place op counts its other
  inputs and the tensor (or view) it writes; an indexed write
  (``index_put_``, ``scatter``, ``index_copy_``...) counts the slice it
  writes, as ``hlo_cost`` counts a dynamic-update-slice.  Tensors off the
  step's device (the host's) are left out; an op with none on it is a
  host op, counted apart.

A hand-written kernel launch (a ``ctypes`` call) is invisible to the
dispatcher.  Each kernel wrapper is ``kernels.observed``: while this mode
is attached, the wrapper's call is one opaque region (nothing inside it
is counted, on the CPU's plain version and on the card's kernel alike)
and its cost function's ``(flops, bytes, dtype)`` is noted.  A step
therefore counts the same on the CPU, on the meta device and on the card.

On the meta device a kernel's data-dependent cost (the live keys of a
paged decode) needs values that meta tensors do not hold: ``values=``
gives the values of the step's small integer inputs (positions, block
tables), and the mode computes the values of every small integer tensor
derived from them alongside, on the host.

``track_memory`` adds a live-bytes tracker: every device storage alive at
once (``held`` counts what existed before, such as parameters, optimizer
state and cache), its peak standing in for ``memory_analysis()``.

On the meta device most of a trace's time is the meta kernels (Python
shape rules), and a recurrent cell traced token by token (the sLSTM)
repeats the same few ops tens of thousands of times.  So an op that
writes none of its arguments and returns fresh tensors runs once per
argument layout (shape, stride, offset, dtype, scalars); later calls get
fresh meta tensors of the layout it returned.  Every op is still
dispatched, counted and tracked as before, so the signatures, totals
and live bytes are those of the plain trace.
"""

from __future__ import annotations

import math
import weakref
from collections import Counter, defaultdict
from typing import Dict, Iterable, Optional

import torch
from torch.utils import checkpoint
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakTensorKeyDictionary

from repro_torch import kernels
from repro_torch.roofline.analysis import HBM_BW, compute_seconds

T = "@T"                       # tag of an encoded tensor
_FLOP = {str(k): v for k, v in flop_registry.items()}
_MATMUL = ("aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm")
_ALLOC = ("aten.empty", "aten.empty_like", "aten.empty_strided",
          "aten.new_empty", "aten.new_empty_strided")
_INDEXED = {"aten.index_put_", "aten._index_put_impl_", "aten.index_copy_",
            "aten.index_add_", "aten.scatter_", "aten.scatter_add_",
            "aten.scatter_reduce_", "aten.index_fill_"}
SHADOW_LIMIT = 1 << 16         # elements of a meta integer tensor traced
# wraps a tensor the host just made (``torch.tensor(...)``): on the CPU
# only, where that tensor already is on the step's device
_UNCOUNTED = (torch.ops.aten.lift_fresh.default,)
_READS = (torch.ops.aten._local_scalar_dense.default,
          torch.ops.aten.is_nonzero.default)
_SCALARS = (type(None), bool, int, float, str, torch.dtype, torch.device,
            torch.layout, torch.memory_format)


def _dtype_name(dt) -> str:
    return str(dt).split(".")[-1]


def _kind(func) -> str:
    schema = func._schema
    if any(a.alias_info is not None and a.alias_info.is_write
           for a in schema.arguments):
        packet = str(func.overloadpacket)
        return "indexed" if packet in _INDEXED else "inplace"
    for r in schema.returns:
        info = r.alias_info
        if info is None and isinstance(r.type, torch.ListType):
            info = getattr(r.type.getElementType(), "alias_info", None)
        if info is not None and not info.is_write:
            return "view"
    return "op"


def _written_args(func) -> frozenset:
    return frozenset(i for i, a in enumerate(func._schema.arguments)
                     if a.alias_info is not None and a.alias_info.is_write)


_INFO: Dict[object, tuple] = {}


def _info(func) -> tuple:
    """(name, kind, written argument positions) of an op, cached."""
    got = _INFO.get(func)
    if got is None:
        got = _INFO[func] = (str(func), _kind(func), _written_args(func))
    return got


# ---------------------------------------------------------------------------
# signatures and their cost
# ---------------------------------------------------------------------------

_FRESH: Dict[object, bool] = {}


def _fresh(func) -> bool:
    """Whether ``func`` writes none of its arguments and returns tensors
    that alias none of them, cached."""
    got = _FRESH.get(func)
    if got is None:
        sch = func._schema
        got = _FRESH[func] = not sch.is_mutable and all(
            r.alias_info is None for r in sch.returns)
    return got


class _NoKey(Exception):
    pass


def _layout_key(x):
    """A meta op's argument as the layout its output depends on (tensors
    as shape, stride, offset and dtype); ``_NoKey`` for anything else."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise _NoKey
        return (T, tuple(x.shape), x.stride(), x.storage_offset(), x.dtype)
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_layout_key(v) for v in x))
    if isinstance(x, dict):
        return tuple((k, _layout_key(v)) for k, v in sorted(x.items()))
    if isinstance(x, _SCALARS):
        return (type(x), x)
    raise _NoKey


def _flat_tensors(x) -> Iterable:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _flat_tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _flat_tensors(v)


def _fresh_layout(out, inputs):
    """(shape, stride, dtype) of a fresh meta output that ``empty_strided``
    makes as the meta kernel did (a storage of its own, not one of
    ``inputs``' (``_unsafe_view`` shares its input's without saying so),
    offset 0, the same bytes), or None."""
    if not isinstance(out, torch.Tensor) or out.device.type != "meta" or \
            out.storage_offset() or out.untyped_storage()._cdata in inputs:
        return None
    shape, stride = tuple(out.shape), out.stride()
    span = 0 if 0 in shape else 1 + sum((n - 1) * st
                                        for n, st in zip(shape, stride))
    if out.untyped_storage().nbytes() != span * out.element_size():
        return None
    return shape, stride, out.dtype


def _is_t(x) -> bool:
    return isinstance(x, (tuple, list)) and len(x) == 5 and x[0] == T


_ESZ: Dict[str, int] = {}


def _esz(name: str) -> int:
    if name not in _ESZ:
        _ESZ[name] = torch.empty((), dtype=getattr(torch, name)) \
            .element_size()
    return _ESZ[name]


def _nbytes(x) -> int:
    return math.prod(x[1]) * _esz(x[2])


def _tensors(x) -> Iterable:
    if _is_t(x):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


def _shapes(x):
    """An encoded argument with every tensor replaced by its
    ``torch.Size`` (what the flop formulas read)."""
    if _is_t(x):
        return torch.Size(x[1])
    if isinstance(x, (tuple, list)):
        return type(x)(_shapes(v) for v in x) if isinstance(x, tuple) \
            else [_shapes(v) for v in x]
    return x


def _indexed_slice(name: str, args) -> int:
    """Elements an indexed write touches."""
    if name in ("aten.index_put_", "aten._index_put_impl_"):
        self_t, indices = args[0], args[1]
        idx = [i for i in indices if i is not None]
        n = math.prod(torch.broadcast_shapes(*[torch.Size(i[1])
                                               for i in idx])) if idx else 1
        covered = {d for d, i in enumerate(indices) if i is not None}
        return n * math.prod(s for d, s in enumerate(self_t[1])
                             if d not in covered)
    if name in ("aten.scatter_", "aten.scatter_add_",
                "aten.scatter_reduce_"):
        return math.prod(args[2][1])              # index
    if name in ("aten.index_copy_", "aten.index_add_"):
        return math.prod(args[3][1])              # source
    if name == "aten.index_fill_":
        self_t, dim, index = args[0], args[1], args[2]
        return math.prod(index[1]) * math.prod(self_t[1]) // max(
            self_t[1][dim] if self_t[1] else 1, 1)
    raise KeyError(name)


def signature_cost(sig) -> tuple:
    """``(flops, dtype, bytes)`` of one op signature ``(name, kind, args,
    kwargs, outs)`` (device tensors only)."""
    name, kind, args, kw, outs = sig
    base = name.rsplit(".", 1)[0]
    flops, dtype = 0, ""
    formula = _FLOP.get(base)
    if formula is not None:
        ts = list(_tensors(args))
        if ts and ts[0][3]:
            dtype = ts[0][2]
            flops = int(formula(*_shapes(args), **dict(_shapes(kw)),
                                out_val=_shapes(outs)))
    if kind == "view" or base in _ALLOC:
        return flops, dtype, 0
    if kind in ("inplace", "indexed"):
        nbytes = 0
        for t in _tensors((args, kw)):
            if not t[3]:
                continue
            if t[4]:
                nbytes += _indexed_slice(base, args) * _esz(t[2]) \
                    if kind == "indexed" else _nbytes(t)
            else:
                nbytes += _nbytes(t)
        return flops, dtype, nbytes
    nbytes = sum(_nbytes(t) for t in _tensors((args, kw, outs)) if t[3])
    return flops, dtype, nbytes


def on_device(sig) -> bool:
    return any(t[3] for t in _tensors(sig[2:]))


class Totals:
    """Counted FLOPs by dtype, bytes, op and kernel counts of a trace."""

    def __init__(self):
        self.flops_by_dtype: Dict[str, float] = defaultdict(float)
        self.bytes = 0
        self.ops = 0
        self.host_ops = 0
        self.by_op: Dict[str, dict] = defaultdict(
            lambda: {"count": 0, "flops": 0, "bytes": 0})
        self.kernels: Dict[str, dict] = {}

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype.values()))

    @property
    def matmul_flops(self) -> int:
        return sum(v["flops"] for k, v in self.by_op.items()
                   if k.rsplit(".", 1)[0] in _MATMUL)

    @property
    def t_compute(self) -> float:
        return compute_seconds(self.flops_by_dtype)

    @property
    def t_memory(self) -> float:
        return self.bytes / HBM_BW

    @property
    def bound_s(self) -> float:
        return max(self.t_compute, self.t_memory)

    @property
    def bound_by(self) -> str:
        return "operations" if self.t_compute > self.t_memory else "bytes"


def totals(sigs: Dict[tuple, int], kernel_notes: Dict[tuple, int]) -> Totals:
    """The totals of a trace: ``sigs`` op signature -> count,
    ``kernel_notes`` (name, flops, bytes, dtype) -> count."""
    out = Totals()
    for sig, n in sigs.items():
        if not on_device(sig):
            out.host_ops += n
            continue
        flops, dtype, nbytes = signature_cost(sig)
        out.ops += n
        if flops:
            out.flops_by_dtype[dtype] += flops * n
        out.bytes += nbytes * n
        rec = out.by_op[sig[0]]
        rec["count"] += n
        rec["flops"] += flops * n
        rec["bytes"] += nbytes * n
    for (name, flops, nbytes, dtype), n in kernel_notes.items():
        out.ops += n
        if flops:
            out.flops_by_dtype[dtype] += flops * n
        out.bytes += nbytes * n
        rec = out.kernels.setdefault(name, {"count": 0, "flops": 0,
                                            "bytes": 0})
        rec["count"] += n
        rec["flops"] += flops * n
        rec["bytes"] += nbytes * n
    return out


# ---------------------------------------------------------------------------
# the mode
# ---------------------------------------------------------------------------

class CostMode(TorchDispatchMode):
    """Records the op signatures of everything run inside it on
    ``device`` (a device type: ``"cuda"``, ``"cpu"`` or ``"meta"``).

        with CostMode("meta", values={cache["pos"]: pos}) as cm:
            step(...)
        cm.totals().bound_s

    ``values``: tensor -> its host values, for meta tensors whose values a
    kernel's cost reads.  ``track_memory``: the live-bytes tracker, with
    ``held`` the tensors alive before the step; ``peak_bytes`` after.
    ``reuse_layouts``: a fresh meta op's output layouts reused (see the
    module docstring; False runs every meta kernel)."""

    def __init__(self, device, *, values: Optional[dict] = None,
                 track_memory: bool = False, held: Iterable = (),
                 reuse_layouts: bool = True):
        super().__init__()
        # meta ops: argument layout -> output layouts (None: run it)
        self._layouts: Optional[dict] = {} if reuse_layouts else None
        self.device = torch.device(device).type
        self.sigs: Counter = Counter()
        self.kernel_notes: Counter = Counter()
        self.opaque = 0
        self._shadow = WeakTensorKeyDictionary()
        for t, v in (values or {}).items():
            self._shadow[t] = torch.as_tensor(v).cpu()
        self.track_memory = track_memory
        self._live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        if track_memory:
            for t in held:
                self._hold(t)

    # -- kernels.observed ---------------------------------------------------

    def values(self, t):
        return self._shadow.get(t) if t.device.type == "meta" else None

    def note_kernel(self, name: str, cost) -> None:
        flops, nbytes, dtype = cost
        self.kernel_notes[(name, int(flops), int(nbytes), dtype)] += 1

    def __enter__(self):
        # a remat recompute's early stop lands one op sooner under a
        # Python dispatch mode than without one; the full recompute is the
        # op count of the un-traced step
        self._early = checkpoint.set_checkpoint_early_stop(False)
        self._early.__enter__()
        kernels.OBSERVERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            kernels.OBSERVERS.remove(self)
            self._early.__exit__(None, None, None)

    # -- live bytes ----------------------------------------------------------

    def _hold(self, t) -> None:
        if not isinstance(t, torch.Tensor) or t.device.type != self.device:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        self._live[key] = st.nbytes()
        self.live_bytes += st.nbytes()
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    # -- the dispatch --------------------------------------------------------

    def _enc(self, x, written: bool = False):
        if isinstance(x, torch.Tensor):
            return (T, tuple(x.shape), _dtype_name(x.dtype),
                    x.device.type == self.device, written)
        if isinstance(x, (list, tuple)):
            return tuple(self._enc(v) for v in x)
        if x is None or isinstance(x, (bool, int, float, str)):
            return x
        return str(x)

    def _shadow_of(self, func, args, kwargs, out):
        """Host values of a small integer meta output computed from host
        values of its inputs (or from none: a factory op)."""
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if not any(isinstance(o, torch.Tensor) and o.device.type == "meta"
                   and not o.is_floating_point()
                   and o.numel() <= SHADOW_LIMIT for o in outs):
            return
        missing = []

        def host(x):
            if isinstance(x, torch.Tensor) and x.device.type == "meta":
                v = self._shadow.get(x)
                if v is None:
                    missing.append(x)
                return v
            if isinstance(x, torch.device) and x.type == "meta":
                return torch.device("cpu")
            return x
        h_args, h_kw = tree_map(host, (args, kwargs))
        written = [a for i, a in enumerate(args) if i in _info(func)[2]
                   and isinstance(a, torch.Tensor)]
        if missing:
            for w in written:              # a partial update: values lost
                self._shadow.pop(w, None)
            return
        h_out = func(*h_args, **h_kw)
        h_outs = h_out if isinstance(h_out, (tuple, list)) else (h_out,)
        for o, h in zip(outs, h_outs):
            if isinstance(o, torch.Tensor) and isinstance(h, torch.Tensor):
                self._shadow[o] = h

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _READS and args[0].device.type == "meta" and \
                args[0] in self._shadow:
            # ``int(t)`` / ``bool(t)`` of a meta tensor whose values the
            # trace holds: the step's control flow reads them
            out = func(self._shadow[args[0]])
        else:
            out = self._run(func, args, kwargs)
        if self.opaque or func in _UNCOUNTED:
            return out
        name, kind, written = _info(func)
        enc_args = tuple(self._enc(a, i in written)
                         for i, a in enumerate(args))
        enc_kw = tuple(sorted((k, self._enc(v)) for k, v in kwargs.items()))
        sig = (name, kind, enc_args, enc_kw, self._enc(out))
        self.sigs[sig] += 1
        if self.device == "meta" and len(self._shadow):
            self._shadow_of(func, args, kwargs, out)
        if self.track_memory:
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                self._hold(o)
        return out

    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)``, or for a fresh op on meta arguments
        whose layout ran before, fresh meta tensors of its output
        layouts."""
        if self._layouts is None or self.device != "meta" or \
                not _fresh(func):
            return func(*args, **kwargs)
        try:
            key = (func, _layout_key(args), _layout_key(kwargs))
        except _NoKey:
            return func(*args, **kwargs)
        if key in self._layouts:
            outs = self._layouts[key]
            if outs is not None:
                made = [torch.empty_strided(sh, st, dtype=dt, device="meta")
                        for sh, st, dt in outs[1]]
                return made[0] if outs[0] is None else outs[0](made)
        out = func(*args, **kwargs)
        seq = isinstance(out, (tuple, list))
        inputs = {t.untyped_storage()._cdata for t in _flat_tensors(
            (args, kwargs))}
        layouts = [_fresh_layout(o, inputs)
                   for o in (out if seq else (out,))]
        self._layouts[key] = None if None in layouts else (
            type(out) if seq else None, layouts)
        return out

    # -- results -------------------------------------------------------------

    def totals(self) -> Totals:
        return totals(self.sigs, self.kernel_notes)

    def archive(self) -> dict:
        """The trace as JSON-ready data (``roofline.reanalyze`` reads it
        back through ``from_archive``)."""
        return {"device": self.device,
                "ops": [[*sig, n] for sig, n in self.sigs.items()],
                "kernels": [[*k, n] for k, n in self.kernel_notes.items()],
                "peak_bytes": self.peak_bytes}


def _tuples(x):
    if isinstance(x, list):
        return tuple(_tuples(v) for v in x)
    return x


def from_archive(data: dict) -> Totals:
    """``totals`` of an archived trace (``CostMode.archive``)."""
    sigs = {_tuples(op[:-1]): op[-1] for op in data["ops"]}
    notes = {tuple(k[:-1]): k[-1] for k in data["kernels"]}
    return totals(sigs, notes)
