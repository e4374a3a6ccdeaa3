"""Hand-written Hopper kernels of the port.

Each kernel lives in ``csrc/<name>.cu`` (built by ``_build``) with a
wrapper and a plain PyTorch version beside it in its package's ``ops.py``.
No kernel has a gradient (nor has the reference's Pallas kernel): each
wrapper calls ``refuse_grad`` first, on every device, so autograd never
gets a result that silently drops its inputs' gradients.

Each wrapper also has a cost function, ``<kernel>_cost(...) -> (flops,
bytes, dtype)``: bytes of each input read once and each output written
once (K/V or latents of the live keys only), FLOPs over each query
position's frontier.  ``observed`` reports it to the dispatch modes that
watch the step; a ``meta`` tensor gets an empty output of the kernel's
shape (shape propagation for a dry run; nothing is computed).
"""

import contextlib
import functools

import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raise ``NotImplementedError`` when gradients are enabled and one of
    ``tensors`` requires grad (the kernel's output would have no
    ``grad_fn``)."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the kernel has no gradient (nor has the reference's "
            f"Pallas kernel); call it under torch.no_grad() or on inputs "
            f"that do not require grad")


# Observers of kernel launches: dispatch modes (``roofline.op_cost.CostMode``,
# ``analysis.op_lint``) that see a wrapper's call as one opaque op, as a
# ``pallas_call`` is one primitive in a jaxpr.  They watch one thread: a
# kernel launched from another thread while one is attached hides that
# thread's ops from it too.  Each has an ``opaque``
# count (ops dispatched while it is above 0 are the kernel's own: not
# counted, not linted), ``values`` (``values(t)``: a CPU tensor of ``t``'s
# values, or None where it does not know them; ``values`` None: the
# observer takes no costs) and ``note_kernel(name, cost)``.
OBSERVERS: list = []


def host_values(t, values=None) -> torch.Tensor:
    """``t``'s values on the host: ``values(t)`` when an observer gives
    them (a meta tensor's, traced alongside), else a copy of ``t``.  A meta
    tensor whose values nobody traced raises: a data-dependent cost cannot
    be counted from shapes alone."""
    got = values(t) if values is not None else None
    if got is not None:
        return got
    if t.device.type == "meta":
        raise ValueError("a kernel's cost depends on the values of a meta "
                         "tensor that the trace does not hold: give them to "
                         "roofline.op_cost.CostMode(values=...)")
    return t.detach().cpu()


def observed(name: str, cost):
    """Decorator of a kernel wrapper: with no observer the wrapper runs as
    it is (one check of ``OBSERVERS``); with observers the call is one
    opaque region of each, and ``cost(*args, values=, **kw) -> (flops,
    bytes, dtype name)`` is noted once per top-level region (a wrapper
    that calls another, as ``flash_decode`` calls ``flash_attention``, is
    one region)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            if not OBSERVERS:
                return fn(*args, **kw)
            every = tuple(OBSERVERS)
            obs = [ob for ob in every if not ob.opaque]
            for ob in every:
                ob.opaque += 1
            try:
                out = fn(*args, **kw)
                costs = [None if ob.values is None else
                         cost(*args, values=ob.values, **kw) for ob in obs]
            finally:
                for ob in every:
                    ob.opaque -= 1
            for ob, c in zip(obs, costs):
                ob.note_kernel(name, c)
            return out
        return wrapper
    return deco


@contextlib.contextmanager
def unobserved():
    """A block hidden from every observer (``launch.mesh.SpecMesh`` makes
    a collective's result here: its traffic is the collective's, which the
    mesh records, not the step's compute)."""
    every = tuple(OBSERVERS)
    for ob in every:
        ob.opaque += 1
    try:
        yield
    finally:
        for ob in every:
            ob.opaque -= 1
