"""What the references share: the seeded weight draw, the fleet's prompt
tokenization, float32 building blocks, and the arithmetic a forward pass
runs its linear maps in (exact float32, or the fp8 control).

Every function computes in float32 from bf16 or float32 weights; matmuls
take float32 operands, so the caller must keep TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``) for them to be
float32 on the card.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# a leaf: (name, shape, dtype, law); law is "dense" (N(0, 1/fan_in), fan_in
# = shape[-2]), "norm" (1 + N(0, 0.1^2)) or a float (N(0, law^2))
Leaf = Tuple[str, Tuple[int, ...], torch.dtype, object]

FP8_MAX = 448.0            # largest finite float8_e4m3fn


def block_seed(seed: int, index: int) -> int:
    """The generator seed of weight block ``index`` of a run with ``seed``."""
    h = hashlib.blake2b(f"{int(seed)}:{index}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


def _scale(law, shape) -> float:
    if law == "dense":
        return 1.0 / math.sqrt(shape[-2] if len(shape) >= 2 else shape[-1])
    return float(law)


@torch.no_grad()
def draw_block(leaves: Sequence[Leaf], seed: int, index: int,
               device) -> Dict[str, torch.Tensor]:
    """The tensors of one block of weights, drawn from the seed in one
    ``randn`` call per dtype on ``device``, in the dtype they are served
    in.  The same (leaves, seed, index, device type) give the same
    tensors."""
    gen = torch.Generator(device=device).manual_seed(block_seed(seed, index))
    out: Dict[str, torch.Tensor] = {}
    for dtype in (torch.bfloat16, torch.float32):
        mine = [lf for lf in leaves if lf[2] == dtype]
        if not mine:
            continue
        total = sum(math.prod(lf[1]) for lf in mine)
        buf = torch.randn(total, generator=gen, dtype=dtype, device=device)
        off = 0
        for name, shape, _, law in mine:
            n = math.prod(shape)
            t = buf[off:off + n].view(shape)
            off += n
            if law == "norm":
                t.mul_(0.1).add_(1.0)
            else:
                t.mul_(_scale(law, shape))
            out[name] = t
    return out


def hash_tokens(text: str, vocab: int, cap: int) -> List[int]:
    """The fleet's prompt tokenization: one token per whitespace-separated
    lowercase word, ``4 + blake2s(word) % (vocab - 4)``; an empty prompt is
    ``[4]``; a prompt longer than ``cap`` keeps its tail."""
    ids = []
    for w in text.lower().split():
        h = hashlib.blake2s(w.encode(), digest_size=4).digest()
        ids.append(4 + int.from_bytes(h, "little") % (vocab - 4))
    return (ids or [4])[-cap:]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE over the last dim of ``x`` (S, ..., dim) at
    positions 0..S-1."""
    S, dim = x.shape[0], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=x.device) / dim))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    shape = (S,) + (1,) * (x.dim() - 2) + (dim // 2,)
    cos, sin = torch.cos(ang).view(shape), torch.sin(ang).view(shape)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """q (S, H, dq), k (S, Hk, dq), v (S, Hk, dv) with H a multiple of Hk
    (query head h reads key head h // (H // Hk)) -> (S, H, dv)."""
    S, H, _ = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    s = torch.einsum("qhd,khd->hqk", q.float(), k.float()) * scale
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v.float())


def swiglu(x, w_gate, w_up, w_down, ar) -> torch.Tensor:
    return ar.mm(F.silu(ar.mm(x, w_gate)) * ar.mm(x, w_up), w_down)


class Exact:
    """Linear maps in float32: x (.., k) @ w (k, n) upcast."""

    name = "float32"

    def prep(self, w: torch.Tensor) -> torch.Tensor:
        return w.float()

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return x.float()

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.act(x) @ self.prep(w)


class FP8(Exact):
    """The control: every linear map's weight (per output column) and input
    (per row) rounded to float8_e4m3fn with an absmax scale, then
    multiplied in float32: the precision below the configuration's bf16
    that a serving change would reach for first."""

    name = "fp8"

    @staticmethod
    def _q(t: torch.Tensor, dim: int) -> torch.Tensor:
        t = t.float()
        s = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
        return (t / s).to(torch.float8_e4m3fn).float() * s

    def prep(self, w: torch.Tensor) -> torch.Tensor:
        return self._q(w, -2)

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return self._q(x, -1)


def token_gaps(logits: torch.Tensor, tokens: Sequence[int]) -> torch.Tensor:
    """The distance by which ``tokens[t]``'s logit lies below the best
    logit of row ``t`` of ``logits`` (T, V), for each row."""
    idx = torch.as_tensor(list(tokens), device=logits.device).long()
    got = logits.gather(1, idx[:, None])[:, 0]
    return logits.max(dim=1).values - got


def as_ids(tokens, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(tokens, np.int64), device=device)
