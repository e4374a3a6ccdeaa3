"""Gradient compression for data parallelism over ranks
(``repro.distributed.compression``' twin).

int8 block-quantised mean all-reduce: each rank quantises its gradient to
int8 with per-block float32 scales (stochastic rounding), the int8 payload
is summed as int32 and the scales as float32 over the axis' ranks, and
the sum is dequantised with the mean scale — ~3.5x fewer gradient bytes
on the wire, at the cost of stochastic-rounding noise.

The noise of leaf ``i`` comes from a ``torch.Generator`` seeded with
``seed + i`` and the rank's index along the axis (the reference folds
the axis index into ``PRNGKey(seed + i)``; the two draws differ, so the
parity tests inject the same noise into both packages).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

BLOCK = 256


def _quantize(x: torch.Tensor, generator: Optional[torch.Generator] = None,
              noise: Optional[torch.Tensor] = None):
    """x -> (q int8 (nblocks, BLOCK), scale float32 (nblocks, 1), pad).
    ``noise`` (uniform in [0, 1), the blocks' shape) replaces the draw from
    ``generator``."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK).float()
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    scaled = blocks / scale
    if noise is None:
        noise = torch.rand(scaled.shape, generator=generator,
                           device=scaled.device)
    noise = noise.to(scaled.device, torch.float32) - 0.5   # stochastic round
    q = torch.clamp(torch.round(scaled + noise), -127, 127).to(torch.int8)
    return q, scale, pad


def _dequantize(q: torch.Tensor, scale: torch.Tensor, pad: int, shape,
                dtype) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape).to(dtype)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def compressed_psum_mean(grads: Any, mesh, axis: str = "data",
                         seed: int = 0, noise: Optional[list] = None) -> Any:
    """Mean-all-reduce a gradient tree (nested dicts / lists of tensors)
    over ``axis`` of the rank ``mesh`` with int8 payloads: the int8 values
    summed as int32 (no overflow below 2^23 ranks), the per-block scales
    summed as float32 and divided by the axis size.  ``noise`` (one
    uniform tensor per leaf, in leaf order) replaces the seeded draws."""
    n = mesh.axis_size(axis)
    j = mesh.coords[axis] if axis in mesh.coords else 0
    out = []
    for i, g in enumerate(_leaves(grads)):
        gen = torch.Generator(device=g.device)
        gen.manual_seed((seed + i) * 1_000_003 + j)
        q, scale, pad = _quantize(g, gen,
                                  None if noise is None else noise[i])
        qs = mesh.all_reduce(q.to(torch.int32), axis)
        ss = mesh.all_reduce(scale, axis) / n
        # approximate: sum_i q_i * mean(scale) — exact when scales agree
        out.append(_dequantize(qs, ss, pad, g.shape, g.dtype) / n)
    return _rebuild(grads, iter(out))


def compression_ratio(grads: Any) -> float:
    """bytes(int8 + scales) / bytes(fp32)."""
    total = sum(g.numel() for g in _leaves(grads))
    comp = total * 1 + (total / BLOCK) * 4
    return comp / (total * 4)
