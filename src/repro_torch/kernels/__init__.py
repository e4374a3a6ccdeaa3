"""Hand-written Hopper kernels of the port.

Each kernel lives in ``csrc/<name>.cu`` (built by ``_build``) with a
wrapper and a plain PyTorch version beside it in its package's ``ops.py``.
No kernel has a gradient (nor has the reference's Pallas kernel): each
wrapper calls ``refuse_grad`` first, on every device, so autograd never
gets a result that silently drops its inputs' gradients.
"""

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
