"""Meshes of ranks (``repro.launch.mesh``' twin) and the ranks themselves.

The reference is single-controller: one process drives every device and
GSPMD inserts the collectives the specs imply.  Here each mesh position
is a process (a *rank*) of ``torch.distributed`` and the collectives are
written out (``RankMesh.all_reduce`` / ``all_gather``).

* ``Mesh`` — a shape over named axes (``{"data": 16, "model": 16}``), all
  that ``sharding.rules`` needs; no process behind it.
* ``SpecMesh`` — a ``Mesh`` standing as rank 0 with ``RankMesh``'s
  collective surface and no ranks: its collectives return rank 0's shapes
  and record their traffic (``roofline.collectives``), for the dry run.
* ``RankMesh`` — a ``Mesh`` over the initialised world: rank
  ``r = data_index * model + model_index`` (row-major, as the reference's
  ``reshape(data, model)``), one process group per axis and one over the
  whole mesh.  The ranks talk through ``gloo``: on one card every rank
  shares it (NCCL refuses two ranks on one device), and the collectives
  stage CUDA tensors through host memory (a reduction's ``bf16``/``f16``
  travels as float32, a gather's as its bits).  Their wall time is kept
  in ``RankMesh.stats``.  Training takes their differentiable twins
  (``RankMesh.psum`` / ``enter`` / ``gather`` / ``first``,
  ``torch.autograd.Function``s): the backward of each issues its
  collective in the graph's order, the same on every rank.
* ``make_production_mesh`` / ``make_host_mesh`` / ``data_axes`` /
  ``stage_split`` — the reference's functions over ranks.
* Bringing ranks up: ``host_ranks(world)`` makes this process rank 0 and
  starts ``world - 1`` worker processes (``gloo``, a ``FileStore``
  rendezvous in a temporary directory) that run ``worker_loop``, so one
  controller drives every rank: ``Controller.run`` calls a method of a
  mirrored object, ``Controller.gather(fn, *args)`` runs a module-level
  function on every rank and returns the results.  Under ``torchrun``
  (``env://``) ``host_ranks`` joins the world the launcher made instead,
  and on ranks other than 0 it runs the worker loop before it yields
  None.  Ranks run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import datetime
import itertools
import math
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback
import weakref
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import kernels
from repro_torch.device import resolve_device
from repro_torch.sharding.rules import axis_index

# the command channel (the default group) waits as long as a controller
# may do other work between commands; the model's collectives wait for
# the slowest rank of one step only, so a rank that died fails the run
COMMAND_TIMEOUT = datetime.timedelta(hours=4)
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)
_WIDE = (torch.bfloat16, torch.float16)


class Mesh:
    """Named axes and their sizes, in order (the reference's ``Mesh``
    shape; ``ranks`` holds the global rank at each position)."""

    def __init__(self, shape: Mapping[str, int]):
        self.shape: Dict[str, int] = dict(shape)
        self.axis_names = tuple(self.shape)
        self.ranks = np.arange(math.prod(self.shape.values())).reshape(
            tuple(self.shape.values()))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def coords_of(self, rank: int) -> Dict[str, int]:
        idx = np.unravel_index(rank, self.ranks.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def __repr__(self):
        return f"{type(self).__name__}({self.shape})"


class CollectiveStats:
    """Host-staged collective wall time of one rank (every call of
    ``all_reduce`` / ``all_gather`` with more than one rank in its
    group: the device-to-host copy, the ``gloo`` op and the copy back)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.calls = 0
        self.seconds = 0.0
        self.bytes = 0


class _Collectives(Mesh):
    """What a mesh builds on its three primitive collectives (``all_reduce``,
    ``all_gather``, ``reduce_scatter``): this rank's index and block along
    an axis, and the differentiable twins training takes."""

    def axis_size(self, axis) -> int:
        axes = tuple(axis) if isinstance(axis, tuple) else (axis,)
        return math.prod(self.shape[a] for a in axes)

    def own_block(self, t: torch.Tensor, axis, dim: int) -> torch.Tensor:
        """This rank's block of ``t``'s ``dim`` split over ``axis``."""
        b = t.shape[dim] // self.axis_size(axis)
        return t.narrow(dim, self.index(axis) * b, b)

    def index(self, axis) -> int:
        """This rank's row-major index along ``axis`` (a name or a tuple
        of names)."""
        return axis_index(self, axis, self.coords)

    # -- differentiable twins (training) -----------------------------------

    def psum(self, t: torch.Tensor, axis="model") -> torch.Tensor:
        """Sum of a partial result (a row-parallel product, vocab-parallel
        embedding rows, expert shares, a loss' partial sums): forward
        ``all_reduce``; backward the identity, since what follows is the
        same on every rank of ``axis``."""
        if self.axis_size(axis) == 1:
            return t
        return _PSum.apply(t, self, axis)

    def enter(self, t: torch.Tensor, axis="model") -> torch.Tensor:
        """Entry of a replicated value into a branch split over ``axis``
        (Megatron's "f"): forward the identity; backward the all-reduce of
        the ranks' partial gradients."""
        if self.axis_size(axis) == 1:
            return t
        return _Enter.apply(t, self, axis)

    def gather(self, t: torch.Tensor, axis, dim: int, *,
               grad: str = "sum") -> torch.Tensor:
        """Tiled all-gather of ``t``'s blocks along ``dim``.  Backward:
        ``grad="sum"`` reduce-scatters (the ranks' partial gradients of
        the whole are summed onto each block: what consumes the gathered
        tensor is split over ``axis``); ``"slice"`` keeps the rank's block
        of the gradient (the consumer is replicated over ``axis``, so every
        rank holds the whole gradient)."""
        if self.axis_size(axis) == 1:
            return t
        return _Gather.apply(t, self, axis, dim, grad)

    def first(self, t: torch.Tensor, axis) -> torch.Tensor:
        """The value of index 0 along ``axis`` on every rank of it; the
        gradient reaches each rank's ``t`` divided by the axis' size.  This
        is what GSPMD gives a value that a ``shard_map`` declares
        replicated (``P()``, ``check_rep=False``) while its shards differ:
        the result reads the first device's, and the transpose averages."""
        if self.axis_size(axis) == 1:
            return t
        return _First.apply(t, self, axis)


class RankMesh(_Collectives):
    """A ``Mesh`` whose positions are the ranks of the initialised world;
    this process is ``rank`` at ``coords``.  Built by ``make_host_mesh`` /
    ``make_production_mesh`` on every rank (group creation is collective)."""

    def __init__(self, shape: Mapping[str, int]):
        super().__init__(shape)
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.coords = self.coords_of(self.rank)
        self.stats = CollectiveStats()
        self._groups: Dict[tuple, object] = {}
        if self.size > 1:
            # every non-empty set of axes, in one order on every rank
            for n in range(1, len(self.axis_names) + 1):
                for axes in itertools.combinations(self.axis_names, n):
                    self._groups[axes] = _new_groups(self, axes)

    def _group(self, axis):
        axes = tuple(axis) if isinstance(axis, tuple) else (axis,)
        n = math.prod(self.shape[a] for a in axes)
        if n == 1:
            return None, 1
        if axes not in self._groups:
            raise ValueError(f"no process group over {axes}")
        return self._groups[axes], n

    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        host = t.detach().to("cpu", copy=True)
        return host.float() if host.dtype in _WIDE else host

    def all_reduce(self, t: torch.Tensor, axis="model",
                   op: str = "sum") -> torch.Tensor:
        """``t`` reduced over ``axis`` (a name or a tuple of names): a new
        tensor on ``t``'s device and dtype, identical on every rank."""
        group, n = self._group(axis)
        if n == 1:
            return t
        t0 = time.perf_counter()
        host = self._stage(t)
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        dist.all_reduce(host, op=rop, group=group)
        out = host.to(t.device, t.dtype)
        self._count(t0, host)
        return out

    def all_gather(self, t: torch.Tensor, axis, dim: int) -> torch.Tensor:
        """The blocks of ``t`` of every rank along ``axis``, concatenated
        on ``dim`` in the axis' order (``tiled`` all-gather)."""
        group, n = self._group(axis)
        if n == 1:
            return t
        t0 = time.perf_counter()
        if t.dtype in _WIDE:    # no arithmetic: 16-bit floats move as bits
            host = t.detach().to("cpu").contiguous().view(torch.uint8)
        else:
            host = self._stage(t).contiguous()
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        out = torch.cat(parts, dim=dim)
        if t.dtype in _WIDE:
            out = out.view(t.dtype)
        out = out.to(t.device, t.dtype)
        self._count(t0, host, n)
        return out

    def reduce_scatter(self, t: torch.Tensor, axis, dim: int) -> torch.Tensor:
        """``t`` summed over ``axis``, then this rank's block of ``dim``
        (``gloo`` has no reduce-scatter: an all-reduce and a slice, its
        bytes counted as the all-reduce's)."""
        if self.axis_size(axis) == 1:
            return t
        return self.own_block(self.all_reduce(t, axis), axis,
                              dim).contiguous()

    def barrier(self) -> None:
        """Wait for every rank of the mesh."""
        if self.size > 1:
            dist.barrier(group=self._groups[self.axis_names])

    def gather_to(self, t: torch.Tensor, dst: int) -> Optional[List]:
        """Every rank's ``t`` (equal shapes; staged as ``all_gather``)
        collected on global rank ``dst`` in mesh-rank order; None on the
        other ranks."""
        t0 = time.perf_counter()
        host = self._stage(t).contiguous()
        parts = ([torch.empty_like(host) for _ in range(self.size)]
                 if self.rank == dst else None)
        dist.gather(host, parts, dst=dst,
                    group=self._groups[self.axis_names])
        self._count(t0, host, self.size if self.rank == dst else 1)
        return parts

    def _count(self, t0: float, host: torch.Tensor, n: int = 1):
        self.stats.calls += 1
        self.stats.seconds += time.perf_counter() - t0
        self.stats.bytes += host.numel() * host.element_size() * n


class SpecMesh(_Collectives):
    """A mesh of the given shape with no ranks behind it, standing as rank
    0 (``coords`` all 0): what a dry run builds a production step on
    (``SpecMesh.production()``: 16 x 16, or 2 x 16 x 16).  Parameters and
    caches on it are rank 0's blocks (``init_params(..., mesh=)`` on the
    meta device).  Each collective returns a tensor of rank 0's shape on
    the input's device — an all-reduce its input, an all-gather rank 0's
    block repeated, a reduce-scatter its block — and notes ``(kind,
    operand bytes, group size)`` in ``recorder``
    (``roofline.collectives.Recorder``).  The results are made out of
    sight of the step's cost model (``kernels.unobserved``)."""

    def __init__(self, shape: Mapping[str, int], recorder=None):
        super().__init__(shape)
        self.rank = 0
        self.coords = self.coords_of(0)
        self.recorder = recorder

    @classmethod
    def production(cls, *, multi_pod: bool = False, recorder=None):
        """``make_production_mesh``'s shape without its ranks."""
        shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod else
                 {"data": 16, "model": 16})
        return cls(shape, recorder)

    def _note(self, kind: str, t: torch.Tensor, n: int) -> None:
        if self.recorder is not None:
            self.recorder.note(kind, t.numel() * t.element_size(), n)

    def all_reduce(self, t: torch.Tensor, axis="model",
                   op: str = "sum") -> torch.Tensor:
        n = self.axis_size(axis)
        if n > 1:
            self._note("all-reduce", t, n)
        return t

    def all_gather(self, t: torch.Tensor, axis, dim: int) -> torch.Tensor:
        n = self.axis_size(axis)
        if n == 1:
            return t
        self._note("all-gather", t, n)
        with kernels.unobserved():
            return torch.cat([t.detach()] * n, dim=dim)

    def reduce_scatter(self, t: torch.Tensor, axis, dim: int) -> torch.Tensor:
        n = self.axis_size(axis)
        if n == 1:
            return t
        self._note("reduce-scatter", t, n)
        with kernels.unobserved():
            return self.own_block(t.detach(), axis, dim).contiguous()


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        return mesh.all_reduce(t, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous(), ctx.axis), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim, grad):
        ctx.mesh, ctx.axis, ctx.dim, ctx.grad = mesh, axis, dim, grad
        return mesh.all_gather(t, axis, dim)

    @staticmethod
    def backward(ctx, g):
        m, axis, dim = ctx.mesh, ctx.axis, ctx.dim
        g = m.reduce_scatter(g.contiguous(), axis, dim) \
            if ctx.grad == "sum" else m.own_block(g, axis, dim)
        return g, None, None, None, None


class _First(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.n = mesh.axis_size(axis)
        mine = t if mesh.index(axis) == 0 else torch.zeros_like(t)
        return mesh.all_reduce(mine, axis)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def _new_groups(mesh: Mesh, axes: tuple):
    """One ``gloo`` group per line of the mesh along ``axes``; every rank
    creates every group, in one order.  Returns this rank's group."""
    keep = [mesh.axis_names.index(a) for a in axes]
    other = [i for i in range(len(mesh.axis_names)) if i not in keep]
    perm = np.transpose(mesh.ranks, other + keep)
    lines = perm.reshape(-1, math.prod(mesh.shape[a] for a in axes))
    mine = None
    for line in lines:
        g = dist.new_group([int(r) for r in line], backend="gloo",
                           timeout=COLLECTIVE_TIMEOUT)
        if mesh.rank in line:
            mine = g
    return mine


# ---------------------------------------------------------------------------
# the reference's mesh functions
# ---------------------------------------------------------------------------

_MESHES: Dict[tuple, RankMesh] = {}


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _build_mesh(shape: tuple, axes: tuple) -> RankMesh:
    key = (shape, axes)
    if key not in _MESHES:
        _MESHES[key] = RankMesh(dict(zip(axes, shape)))
    return _MESHES[key]


def _mesh(shape: tuple, axes: tuple) -> RankMesh:
    """The cached mesh, made on every rank (through the controller when
    this process drives looping workers and is not already running a call
    that every rank runs)."""
    key = (shape, axes)
    if key in _MESHES:
        return _MESHES[key]
    if _CONTROLLER is not None and not _CONTROLLER.inside:
        return _CONTROLLER.run(None, _build_mesh, shape, axes, sync=True)
    return _build_mesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False):
    """The 16 x 16 ``("data", "model")`` mesh (``multi_pod``: 2 x 16 x 16
    with a leading ``"pod"`` axis) over the world's ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if _world() < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, have {_world()} — use "
            "launch.mesh.SpecMesh.production() (a spec-only mesh standing "
            "as rank 0, what launch.dryrun builds on) to trace or size "
            "its steps without ranks")
    if _world() > n:
        raise RuntimeError(f"mesh {shape} needs exactly {n} ranks, have "
                           f"{_world()}")
    return _mesh(shape, axes)


def make_host_mesh(model: int = 1) -> RankMesh:
    """The ``(data = world // model, model)`` mesh over the initialised
    world's ranks (a world of one when none is initialised).  ``model``
    carves the model-parallel axis out of the ranks; raises when it
    exceeds them (``host_ranks`` / ``torchrun`` bring ranks up)."""
    world = _world()
    if model < 1 or world < model:
        raise RuntimeError(
            f"model axis {model} needs at least {model} ranks, have "
            f"{world} — bring ranks up with repro_torch.launch.mesh."
            "host_ranks, or torchrun")
    if world % model:
        raise RuntimeError(f"model axis {model} does not divide the "
                           f"world's {world} ranks")
    return _mesh((world // model, model), ("data", "model"))


def data_axes(mesh) -> tuple:
    """Axes that carry batch/gradient sharding."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def stage_split(mesh, n_stages: int) -> List[np.ndarray]:
    """Pipeline-parallel hook: the mesh's ranks split along ``"model"``
    into ``n_stages`` equal slices (the reference returns device slices).
    Not used by the serving paths."""
    axis = mesh.axis_names.index("model")
    size = mesh.ranks.shape[axis]
    assert size % n_stages == 0
    per = size // n_stages
    return [np.take(mesh.ranks, range(s * per, (s + 1) * per), axis=axis)
            for s in range(n_stages)]


# ---------------------------------------------------------------------------
# one controller over looping workers
# ---------------------------------------------------------------------------

_CONTROLLER: Optional["Controller"] = None


def _encode(x):
    """A call's argument on the wire: objects the workers mirror travel as
    their handle (a mirrored cache dict with its scheduler-set ``pos`` /
    ``tbl``), tensors as CPU tensors, containers element-wise."""
    h = getattr(x, "_rank_handle", None)
    if h is not None:
        extra = ({k: x[k].detach().cpu() for k in ("pos", "tbl") if k in x}
                 if isinstance(x, dict) else None)
        return ("h", h, extra)
    if isinstance(x, torch.Tensor):
        return ("t", x.detach().cpu())
    if isinstance(x, dict):
        return ("d", {k: _encode(v) for k, v in x.items()})
    if isinstance(x, (list, tuple)):
        return ("l", type(x) is tuple, [_encode(v) for v in x])
    return ("v", x)


def _decode(x, dev, objs):
    kind = x[0]
    if kind == "h":
        obj = objs[x[1]]
        for k, t in (x[2] or {}).items():
            obj[k] = t.to(dev)
        return obj
    if kind == "t":
        return x[1].to(dev)
    if kind == "d":
        return {k: _decode(v, dev, objs) for k, v in x[1].items()}
    if kind == "l":
        vals = [_decode(v, dev, objs) for v in x[2]]
        return tuple(vals) if x[1] else vals
    return x[1]


class RankDict(dict):
    """A dict that a controller's workers mirror (a member's cache)."""


def _bcast(msg=None):
    box = [msg]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class Controller:
    """Rank 0's side of ``worker_loop``: ``run`` sends one call to every
    worker, then makes it here; the ranks run it together (its collectives
    included).  One call at a time (a lock), so threads of rank 0 never
    interleave their ranks' collectives."""

    def __init__(self):
        self.lock = threading.RLock()
        self._next = 0
        self._freed: List[int] = []
        self._free_lock = threading.Lock()
        self.inside = 0          # calls of ``run`` executing here now

    def _release(self, h: int):
        with self._free_lock:
            self._freed.append(h)

    def run(self, target, method, *args, keep: bool = False,
            sync: bool = False, gather: bool = False, **kwargs):
        """Call ``method(*args, **kwargs)`` on every rank: a module-level
        function (or class) when ``target`` is None, else the attribute
        ``method`` of ``target`` (an object the workers mirror).  ``keep``:
        the workers mirror the result, which comes back here carrying its
        handle (dict results as a ``RankDict``).  ``sync``: wait for every rank and raise with a
        failed worker's traceback (a hot-path call does not wait: a worker
        that fails exits, and the step's collectives time out).
        ``gather``: also return every rank's result, in rank order."""
        with self.lock:
            h = None
            if keep:
                self._next += 1
                h = self._next
            with self._free_lock:
                freed, self._freed = self._freed, []
            th = None if target is None else target._rank_handle
            wait = "value" if gather else ("status" if sync or keep
                                           else None)
            _bcast(("run", th, method, _encode(args), _encode(kwargs), h,
                    freed, wait))
            fn = method if target is None else getattr(target, method)
            self.inside += 1
            try:
                res, err = fn(*args, **kwargs), None
            except BaseException as e:      # noqa: BLE001 — re-raised below
                if wait is None:
                    raise
                res, err = None, e
            finally:
                self.inside -= 1
            if wait is None:
                return self._mirror(res, h)
            outs = [None] * dist.get_world_size()
            dist.gather_object(("ok", res if gather else None), outs, dst=0)
            if err is not None:
                raise err
            bad = [o[1] for o in outs if o[0] == "err"]
            if bad:
                raise RuntimeError("a worker rank failed:\n" + bad[0])
            codes = [o[1] for o in outs if o[0] == "exit"]
            if codes:
                raise RuntimeError(f"worker ranks exited with codes {codes}")
            if gather:
                return [res] + [o[1] for o in outs[1:]]
            return self._mirror(res, h)

    def _mirror(self, res, h):
        if h is None:
            return res
        if isinstance(res, dict):
            res = RankDict(res)
        res._rank_handle = h
        weakref.finalize(res, self._release, h)
        return res

    def gather(self, fn, *args) -> list:
        """``fn(*args)`` on every rank; the results in rank order."""
        return self.run(None, fn, *args, gather=True)

    def stop(self):
        with self.lock:
            _bcast(("stop",))


def controller() -> Optional[Controller]:
    """The controller this process runs (rank 0 of ``host_ranks``), or
    None."""
    return _CONTROLLER


def worker_loop(device="cuda") -> None:
    """A worker rank: run the controller's calls until it stops.  A call
    that fails is reported when the controller waits for it; on the hot
    path (no wait) the rank prints the traceback and exits 1."""
    dev = resolve_device(device)
    rank = dist.get_rank()
    objs: Dict[int, object] = {}
    while True:
        msg = _bcast()
        if msg[0] == "stop":
            return
        _, target, method, args, kwargs, keep, freed, wait = msg
        for h in freed:
            objs.pop(h, None)
        try:
            fn = method if target is None else getattr(objs[target], method)
            res = fn(*_decode(args, dev, objs), **_decode(kwargs, dev, objs))
            if keep is not None:
                objs[keep] = res
            out = ("ok", res if wait == "value" else None)
        except SystemExit as e:
            # the call ended the program (the launcher's crash drill): the
            # rank reports its code and exits with it, as the controller
            # does
            code = e.code if isinstance(e.code, int) else 1
            if wait is not None:
                dist.gather_object(("exit", code), None, dst=0)
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(code)
        except Exception:                  # noqa: BLE001 — reported
            text = f"rank {rank}: {traceback.format_exc()}"
            if wait is None:
                print(text, file=sys.stderr, flush=True)
                os._exit(1)
            out = ("err", text)
        if wait is not None:
            dist.gather_object(out, None, dst=0)


# ---------------------------------------------------------------------------
# bringing ranks up
# ---------------------------------------------------------------------------

def _init(rank: int, world: int, store_path: Optional[str]) -> None:
    if store_path is None:         # torchrun: RANK / WORLD_SIZE / MASTER_*
        dist.init_process_group("gloo", init_method="env://",
                                timeout=COMMAND_TIMEOUT)
    else:
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world, timeout=COMMAND_TIMEOUT)
    # the ranks share the host's cores: each takes its share of the
    # intra-op threads (oversubscribed OpenMP pools spin against each
    # other); torch's default count follows the process' CPU affinity,
    # where os.cpu_count() would give the whole host's
    torch.set_num_threads(max(1, torch.get_num_threads()
                              // dist.get_world_size()))


def _teardown() -> None:
    global _CONTROLLER
    _CONTROLLER = None
    _MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def _child(rank: int, world: int, store_path: str, device) -> None:
    status = 0
    try:
        _init(rank, world, store_path)
        worker_loop(device)
    except Exception:                      # noqa: BLE001 — exit code
        traceback.print_exc()
        status = 1
    finally:
        try:
            _teardown()
        except Exception:                  # noqa: BLE001
            pass
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(status)


def _start(world: int, store_path: str, device) -> list:
    """Start ranks 1 .. world-1 as worker processes."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = []
    for r in range(1, world):
        p = ctx.Process(target=_child, daemon=True,
                        args=(r, world, store_path, device))
        p.start()
        procs.append(p)
    return procs


def _reap(procs, timeout: float) -> List[int]:
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    return [p.exitcode for p in procs]


@contextlib.contextmanager
def host_ranks(world: int, device="cuda"):
    """Make this process rank 0 of ``world`` ranks whose others run
    ``worker_loop`` on ``device``; yields the ``Controller``.  Under
    ``torchrun`` (``RANK`` set) it joins the launcher's world instead: rank
    0 yields the controller, the others run the worker loop until rank 0
    leaves the block, then yield None.  On leaving, the workers stop, the
    spawned ones are joined (a rank that exited non-zero raises) and the
    process group is destroyed.  A call that exits the program on every
    rank (``SystemExit``, the launcher's crash drill) ends each worker
    with its code; the ``SystemExit`` leaves the block only when every
    spawned worker exited with the same code."""
    global _CONTROLLER
    resolve_device(device)
    if _CONTROLLER is not None or dist.is_initialized():
        raise RuntimeError("ranks are already up in this process")
    torchrun = "RANK" in os.environ
    threads = torch.get_num_threads()
    tmp = None if torchrun else tempfile.mkdtemp(prefix="ranks-")
    store = None if torchrun else os.path.join(tmp, "store")
    procs = [] if torchrun else _start(world, store, device)
    ok = False
    exit_code = None
    try:
        _init(0, world, store)
        if dist.get_rank() != 0:
            worker_loop(device)
            yield None
            ok = True
            return
        _CONTROLLER = Controller()
        try:
            yield _CONTROLLER
        except SystemExit as e:
            exit_code = e.code if isinstance(e.code, int) else 1
            raise
        ok = True
    finally:
        try:
            if ok and _CONTROLLER is not None:
                _CONTROLLER.stop()
        finally:
            codes = _reap(procs, 60.0 if ok or exit_code is not None
                          else 5.0)
            _teardown()
            torch.set_num_threads(threads)
            if tmp is not None:
                shutil.rmtree(tmp, ignore_errors=True)
        if exit_code is not None and any(c != exit_code for c in codes):
            raise RuntimeError(f"rank 0 exited with code {exit_code}, the "
                               f"worker ranks with {codes}")
    if any(c != 0 for c in codes):
        raise RuntimeError(f"worker ranks exited with codes {codes}")
