"""Recurrent mixers of the port: Mamba-1 (Jamba) and xLSTM (mLSTM / sLSTM)
(``repro.models.ssm``'s twin).

Plain functions on tensors, in the reference's op order.  Prefill paths
are *chunked* as the reference's: the sequence is split into chunks of
``_pick_chunk(S)`` tokens; the recurrent state crosses chunks through a
Python loop (the reference's ``lax.scan`` carry) while the within-chunk
math is parallel — an associative scan for Mamba (``_associative_scan``,
the same odd/even recursion as ``jax.lax.associative_scan``, so the
float32 combine order is the reference's) and the decay-matrix attention
form for mLSTM.  sLSTM is a true nonlinear recurrence and steps token by
token.  Decode paths are single-step recurrences over an explicit state
dict.

There is no Pallas kernel here (the reference uses ``lax.scan`` and
``associative_scan``), so there is no CUDA kernel either: on the card the
scans run as PyTorch ops.  Parameters come in as mappings keyed like the
reference's pytree (``ssm_leaves`` gives their shapes, dtypes and init
rules).

Sharded members (the leaves are a rank's blocks, carrying their spec from
``sharding.rules``): each leaf is gathered over ``"data"`` before use
(``layers.W``, FSDP).  Over ``"model"`` the mLSTM and sLSTM run whole on
every rank (the rules keep their leaves whole there; an sLSTM FFN that
the rules split is tensor-parallel through ``layers.ffn_apply``).  Mamba
is channel-parallel: rank j holds channels ``[j*di/M, (j+1)*di/M)`` of
``conv_w``, ``dt_w``, ``x_proj``, ``A_log`` and ``out_proj`` and of its
state, but its block of ``in_proj``'s columns is a block of the fused
``[x | z]`` output, not of channels (at M = 2 rank 0 holds all of x).  So
the rank's in_proj product is all-gathered over ``"model"`` and the rank
cuts its channels of x and of z out of it (``_mamba_local``).  ``x_proj``'s
rows are the rank's channels: its product is summed over ``"model"``
before it is split into dt / B / C; ``out_proj``'s product too
(``row_parallel_sum``).  The 1-D leaves (``conv_b``, ``dt_b``, ``D``) are
whole on every rank; each rank cuts its channels, after ``layers.enter``
so that a train step sums the ranks' partial gradients.
"""

from __future__ import annotations

import math
from typing import Callable, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (W, enter, ffn_apply, rms_norm,
                                       row_parallel_sum, split_over)
from repro_torch.sharding.ctx import current_mesh

Tensor = torch.Tensor
CHUNK = 256


def _pick_chunk(S: int) -> int:
    if S % CHUNK == 0:
        return CHUNK
    for c in (128, 64, 32, 16, 8, 4, 2, 1):
        if S % c == 0:
            return c
    return 1


def _softplus(x: Tensor) -> Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no large-x threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x: Tensor, w: Tensor, b: Tensor, state: Optional[Tensor]):
    """Depthwise causal conv along seq.  x: (B,S,di); w: (K,di); b: (di,).

    state: (B, K-1, di) trailing inputs from the previous segment (or None
    for zero history).  Returns (y (B,S,di), new_state (B,K-1,di))."""
    B, S, di = x.shape
    K = w.shape[0]
    if state is None:
        state = torch.zeros((B, K - 1, di), dtype=x.dtype, device=x.device)
    xe = torch.cat([state, x], dim=1)                          # (B, S+K-1, di)
    # sum_k w[k] * x[t - (K-1) + k], summed from 0 as Python's sum() does
    y = 0
    for k in range(K):
        y = y + xe[:, k:k + S, :] * w[k]
    y = y + b
    new_state = xe[:, S:, :] if K > 1 else state
    return y, new_state


def _associative_scan(combine: Callable, elems: List[Tensor]) -> List[Tensor]:
    """Inclusive scan of ``elems`` along axis 1 with the associative
    ``combine(left, right)``: ``jax.lax.associative_scan``'s recursion
    (combine adjacent pairs, scan the half, fill the even positions),
    so each output is combined in the same order as the reference's."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = combine([e[:, 0:n - 1:2] for e in elems],
                      [e[:, 1::2] for e in elems])
    odd = _associative_scan(combine, reduced)
    if n % 2 == 0:
        even = combine([o[:, :-1] for o in odd], [e[:, 2::2] for e in elems])
    else:
        even = combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    out = []
    for ev, od in zip(even, odd):
        x = torch.empty((ev.shape[0], n) + tuple(ev.shape[2:]),
                        dtype=ev.dtype, device=ev.device)
        x[:, 0::2] = ev
        x[:, 1::2] = od
        out.append(x)
    return out


# ===========================================================================
# parameter leaves: shape, dtype, init rule
# ===========================================================================
# init rules: "dense" (normal / sqrt(fan_in), fan_in = shape[-2]),
# ("scale", s) (normal * s), "zeros", "ones", or a callable
# (cfg) -> float32 tensor for the constant leaves

def mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    di = cfg.mamba_expand * cfg.d_model
    dt_rank = max(1, cfg.d_model // 16)
    return di, dt_rank, cfg.mamba_d_state


def mlstm_dims(cfg: ModelConfig) -> Tuple[int, int]:
    di = int(cfg.xlstm_proj_factor * cfg.d_model)
    dh = di // cfg.n_heads
    return di, dh


def _dt_bias(cfg):
    di = mamba_dims(cfg)[0]
    return torch.zeros((di,)) + torch.log(torch.expm1(torch.tensor(0.01)))


def _a_log(cfg):
    di, _, N = mamba_dims(cfg)
    return torch.log(torch.arange(1, N + 1, dtype=torch.float32)
                     .repeat(di, 1))


def _gate_bias(cfg):
    H = cfg.n_heads
    return torch.cat([torch.zeros((H,)), torch.full((H,), 3.0)])


def ssm_leaves(cfg: ModelConfig, mixer: str, dtype) -> dict:
    """name -> (shape, dtype, init rule) of a mamba / mlstm / slstm block's
    parameters, keyed like the reference's ``*_init`` pytrees (the sLSTM's
    FFN is a nested dict under ``ffn``)."""
    f32 = torch.float32
    d = cfg.d_model
    if mixer == "mamba":
        di, dt_rank, N = mamba_dims(cfg)
        return {
            "in_proj": ((d, 2 * di), dtype, "dense"),
            "conv_w": ((cfg.mamba_d_conv, di), dtype, ("scale", 0.1)),
            "conv_b": ((di,), dtype, "zeros"),
            "x_proj": ((di, dt_rank + 2 * N), dtype, "dense"),
            "dt_w": ((dt_rank, di), dtype, "dense"),
            "dt_b": ((di,), f32, _dt_bias),
            "A_log": ((di, N), f32, _a_log),
            "D": ((di,), f32, "ones"),
            "out_proj": ((di, d), dtype, "dense"),
        }
    if mixer == "mlstm":
        di, _ = mlstm_dims(cfg)
        H = cfg.n_heads
        return {
            "up_proj": ((d, 2 * di), dtype, "dense"),
            "conv_w": ((cfg.xlstm_conv, di), dtype, ("scale", 0.1)),
            "conv_b": ((di,), dtype, "zeros"),
            "wq": ((di, di), dtype, "dense"),
            "wk": ((di, di), dtype, "dense"),
            "wv": ((di, di), dtype, "dense"),
            "w_gates": ((di, 2 * H), f32, ("scale", 0.02)),
            "b_gates": ((2 * H,), f32, _gate_bias),
            "out_norm": ((di,), dtype, "ones"),
            "down_proj": ((di, d), dtype, "dense"),
        }
    if mixer == "slstm":
        H = cfg.n_heads
        dh = d // H
        ff = int(d * 4 / 3)
        return {
            "w_in": ((d, 4 * d), dtype, "dense"),
            "r": ((H, 4, dh, dh), f32, ("scale", 1.0 / math.sqrt(dh))),
            "b": ((4 * d,), f32, "zeros"),
            "out_norm": ((d,), dtype, "ones"),
            "ffn": {"w_gate": ((d, ff), dtype, "dense"),
                    "w_up": ((d, ff), dtype, "dense"),
                    "w_down": ((ff, d), dtype, "dense")},
        }
    raise ValueError(f"not an SSM mixer: {mixer!r}")


def zero_state(cfg: ModelConfig, mixer: str, batch: int, dtype,
               device, model: int = 1) -> dict:
    """The reference's ``{mamba,mlstm,slstm}_zero_state``; ``model``: the
    ranks a mamba state's channels split over (``di / model`` a rank)."""
    f32 = torch.float32
    kw = dict(device=device)
    if mixer == "mamba":
        di, _, N = mamba_dims(cfg)
        di //= model
        return {"conv": torch.zeros((batch, cfg.mamba_d_conv - 1, di),
                                    dtype=dtype, **kw),
                "h": torch.zeros((batch, di, N), dtype=f32, **kw)}
    if mixer == "mlstm":
        di, dh = mlstm_dims(cfg)
        H = cfg.n_heads
        return {"conv": torch.zeros((batch, cfg.xlstm_conv - 1, di),
                                    dtype=dtype, **kw),
                "C": torch.zeros((batch, H, dh, dh), dtype=f32, **kw),
                "n": torch.zeros((batch, H, dh), dtype=f32, **kw),
                "m": torch.full((batch, H), -1e30, dtype=f32, **kw)}
    if mixer == "slstm":
        d = cfg.d_model
        return {"c": torch.zeros((batch, d), dtype=f32, **kw),
                "n": torch.ones((batch, d), dtype=f32, **kw),
                "m": torch.zeros((batch, d), dtype=f32, **kw),
                "h": torch.zeros((batch, d), dtype=f32, **kw)}
    raise ValueError(f"not an SSM mixer: {mixer!r}")


# ===========================================================================
# Mamba-1 (selective SSM)
# ===========================================================================

def _mamba_local(p: Mapping[str, Tensor], cfg: ModelConfig):
    """A mamba block's leaves as this rank uses them: each gathered over
    ``"data"``; the 1-D leaves cut to the rank's channels.  Returns
    (leaves, loc): loc is ((lo, hi) the rank's channels, whether
    ``in_proj``'s columns are split over ``"model"``, whether the
    channels are)."""
    di = mamba_dims(cfg)[0]
    w = {k: W(v) for k, v in p.items()}
    split = split_over(p["conv_w"], dim=1)
    lo, hi = 0, di
    if split:
        n = w["conv_w"].shape[1]
        lo = current_mesh().coords["model"] * n
        hi = lo + n
    for k in ("conv_b", "dt_b", "D"):
        w[k] = enter(w[k], split)[lo:hi]
    return w, ((lo, hi), split_over(p["in_proj"], dim=1), split)


def _mamba_scan_inputs(w: Mapping[str, Tensor], loc, cfg: ModelConfig,
                       x: Tensor, conv_state):
    """Shared pre-scan compute on ``_mamba_local``'s leaves and channels
    ``loc``.  Returns (dA, dBx, Cc, xs_conv, z, conv_state')."""
    di, dt_rank, N = mamba_dims(cfg)
    (lo, hi), in_split, split = loc
    xz = x @ w["in_proj"]
    if in_split:
        # the rank's columns of the fused [x | z]: every rank's, then
        # its own channels of each half
        xz = current_mesh().gather(xz, "model", xz.dim() - 1)
    xs, z = xz[..., lo:hi], xz[..., di + lo:di + hi]
    xs_conv, conv_state = _causal_conv(xs, w["conv_w"], w["conv_b"],
                                       conv_state)
    xs_conv = F.silu(xs_conv)

    dbc = xs_conv @ w["x_proj"]
    if split:
        # a partial sum over the rank's channels, whole after the sum;
        # it then feeds the rank's channels again
        mesh = current_mesh()
        dbc = mesh.enter(mesh.psum(dbc, "model"), "model")
    dt = dbc[..., :dt_rank]
    Bc = dbc[..., dt_rank:dt_rank + N].float()
    Cc = dbc[..., dt_rank + N:].float()
    dt = _softplus((dt @ w["dt_w"]).float() + w["dt_b"])
    A = -torch.exp(w["A_log"])                                   # (di, N)

    xcf = xs_conv.float()
    dA = torch.exp(dt[..., None] * A)                            # (B,S,di,N)
    dBx = (dt * xcf)[..., None] * Bc[:, :, None, :]              # (B,S,di,N)
    return dA, dBx, Cc, xs_conv, z, conv_state


def _mamba_combine(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return [a1 * a2, a2 * b1 + b2]


def mamba_forward(p: Mapping[str, Tensor], cfg: ModelConfig, x: Tensor,
                  state: Optional[dict] = None, return_state: bool = False):
    """x: (B,S,d) -> (y (B,S,d), new_state|None).  Chunked selective scan:
    the pre-scan compute runs per chunk, so the (B,ck,di,N) tensors never
    exist for more than one chunk at a time.  A sharded member's state
    holds the rank's channels."""
    B, S, d = x.shape
    _, _, N = mamba_dims(cfg)
    w, loc = _mamba_local(p, cfg)
    (lo, hi), in_split, _ = loc
    x = enter(x, in_split)
    if state is None:
        h = torch.zeros((B, hi - lo, N), dtype=torch.float32,
                        device=x.device)
        conv_s = torch.zeros((B, cfg.mamba_d_conv - 1, hi - lo),
                             dtype=x.dtype, device=x.device)
    else:
        h, conv_s = state["h"], state["conv"]
    ck = _pick_chunk(S)
    ys = []
    for c in range(S // ck):
        x_c = x[:, c * ck:(c + 1) * ck]
        dA, dBx, Cc, xs_conv, z, conv_s = _mamba_scan_inputs(w, loc, cfg,
                                                             x_c, conv_s)
        ca, cb = _associative_scan(_mamba_combine, [dA, dBx])
        states = ca * h[:, None] + cb                            # (B,ck,di,N)
        y = torch.einsum("bkdn,bkn->bkd", states, Cc)
        y = y + w["D"] * xs_conv.float()
        ys.append((y.to(x.dtype) * F.silu(z)) @ w["out_proj"])
        h = states[:, -1]
    y = row_parallel_sum(torch.cat(ys, dim=1), p["out_proj"])
    new_state = {"conv": conv_s, "h": h} if return_state else None
    return y, new_state


def mamba_step(p: Mapping[str, Tensor], cfg: ModelConfig, x1: Tensor,
               state: dict):
    """Single-token decode.  x1: (B,1,d)."""
    w, loc = _mamba_local(p, cfg)
    dA, dBx, Cc, xs_conv, z, conv_state = _mamba_scan_inputs(
        w, loc, cfg, enter(x1, loc[1]), state["conv"])
    h = dA[:, 0] * state["h"] + dBx[:, 0]                        # (B,di,N)
    y = torch.einsum("bdn,bn->bd", h, Cc[:, 0])
    y = y + w["D"] * xs_conv[:, 0].float()
    y = (y.to(x1.dtype) * F.silu(z[:, 0])) @ w["out_proj"]
    y = row_parallel_sum(y, p["out_proj"])
    return y[:, None, :], {"conv": conv_state, "h": h}


def _gathered(p: Mapping[str, Tensor]) -> dict:
    """An xLSTM block's leaves gathered over ``"data"`` (FSDP); a nested
    mapping (the sLSTM's FFN) stays as it is, for ``ffn_apply``."""
    return {k: W(v) if isinstance(v, Tensor) else v for k, v in p.items()}


# ===========================================================================
# mLSTM (xLSTM matrix memory) — chunkwise-parallel prefill, recurrent decode
# ===========================================================================

def _mlstm_qkv_gates(p: Mapping[str, Tensor], cfg: ModelConfig, x: Tensor,
                     conv_state):
    B, S, _ = x.shape
    di, dh = mlstm_dims(cfg)
    H = cfg.n_heads
    up = x @ p["up_proj"]
    x_in, z = torch.chunk(up, 2, dim=-1)
    x_conv, conv_state = _causal_conv(x_in, p["conv_w"], p["conv_b"],
                                      conv_state)
    x_conv = F.silu(x_conv)
    q = (x_conv @ p["wq"]).reshape(B, S, H, dh)
    k = (x_conv @ p["wk"]).reshape(B, S, H, dh) / math.sqrt(dh)
    v = (x_in @ p["wv"]).reshape(B, S, H, dh)
    gates = x_in.float() @ p["w_gates"] + p["b_gates"]
    i_pre, f_pre = gates[..., :H], gates[..., H:]                 # (B,S,H)
    f_pre = F.logsigmoid(f_pre)                                   # log forget
    return q, k, v, i_pre, f_pre, z, conv_state


def _mlstm_out(p: Mapping[str, Tensor], cfg: ModelConfig, h: Tensor,
               z: Tensor) -> Tensor:
    """h: (B,S,H,dh) float32 -> (B,S,d)."""
    B, S, H, dh = h.shape
    hf = h.reshape(B, S, H * dh)
    hf = rms_norm(hf.to(z.dtype), p["out_norm"], 1e-6)
    return (hf * F.silu(z)) @ p["down_proj"]


def mlstm_forward(p: Mapping[str, Tensor], cfg: ModelConfig, x: Tensor,
                  state: Optional[dict] = None, return_state: bool = False):
    """Chunkwise-parallel mLSTM.  x: (B,S,d)."""
    B, S, d = x.shape
    di, dh = mlstm_dims(cfg)
    H = cfg.n_heads
    ck = _pick_chunk(S)
    p = _gathered(p)
    if state is None:
        state = zero_state(cfg, "mlstm", B, x.dtype, x.device)
    q, k, v, i_pre, f_pre, z, conv_last = _mlstm_qkv_gates(
        p, cfg, x, state["conv"])
    tri = torch.tril(torch.ones((ck, ck), dtype=torch.bool, device=x.device))
    C0, n0, m0 = state["C"], state["n"], state["m"]              # stabilized
    hs = []
    for c in range(S // ck):
        sl = slice(c * ck, (c + 1) * ck)
        qf, kf, vf = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        it, ft = i_pre[:, sl], f_pre[:, sl]

        b = torch.cumsum(ft, dim=1)                              # (B,ck,H)
        # running stabilizer u_t = max(m0, cummax(i_tau - b_tau))
        g = it - b
        u = torch.maximum(m0[:, None], torch.cummax(g, dim=1).values)
        m = b + u                                                # m_t
        decay_in = torch.exp(b + m0[:, None] - m)                # (B,ck,H)
        # D'[t,tau] = exp(b_t - b_tau + i_tau - m_t), tau <= t
        Dlog = (b[:, :, None] - b[:, None, :] + it[:, None, :]
                - m[:, :, None])                                 # (B,t,tau,H)
        Dmat = torch.where(tri[None, :, :, None], torch.exp(Dlog), 0.0)

        S_mat = torch.einsum("bthd,bshd->btsh", qf, kf)          # (B,t,tau,H)
        W = Dmat * S_mat
        intra = torch.einsum("btsh,bshd->bthd", W, vf)
        inter = torch.einsum("bthd,bhvd->bthv", qf, C0) * decay_in[..., None]
        num = intra + inter                                      # (B,t,H,dh)

        denom_intra = W.sum(dim=2)                               # (B,t,H)
        denom_inter = torch.einsum("bthd,bhd->bth", qf, n0) * decay_in
        denom = denom_intra + denom_inter
        hs.append(num / torch.maximum(torch.abs(denom),
                                      torch.exp(-m))[..., None])

        # carry update to the end of the chunk
        last_m = m[:, -1]                                        # (B,H)
        bL = b[:, -1]                                            # (B,H)
        w_tau = torch.exp(bL[:, None] - b + it - last_m[:, None])  # (B,ck,H)
        decay = torch.exp(bL + m0 - last_m)
        C0 = (decay[..., None, None] * C0
              + torch.einsum("bth,bthv,bthk->bhvk", w_tau, vf, kf))
        n0 = (decay[..., None] * n0
              + torch.einsum("bth,bthk->bhk", w_tau, kf))
        m0 = last_m
    h = torch.cat(hs, dim=1)
    y = _mlstm_out(p, cfg, h, z)
    new_state = ({"conv": conv_last, "C": C0, "n": n0, "m": m0}
                 if return_state else None)
    return y, new_state


def mlstm_step(p: Mapping[str, Tensor], cfg: ModelConfig, x1: Tensor,
               state: dict):
    """Single-token decode.  x1: (B,1,d)."""
    p = _gathered(p)
    q, k, v, i_pre, f_pre, z, conv_state = _mlstm_qkv_gates(
        p, cfg, x1, state["conv"])
    qf, kf, vf = (t[:, 0].float() for t in (q, k, v))
    it, ft = i_pre[:, 0], f_pre[:, 0]                            # (B,H)

    m0 = state["m"]
    m1 = torch.maximum(ft + m0, it)
    i_s = torch.exp(it - m1)
    f_s = torch.exp(ft + m0 - m1)
    C1 = f_s[..., None, None] * state["C"] + i_s[..., None, None] * \
        torch.einsum("bhv,bhk->bhvk", vf, kf)
    n1 = f_s[..., None] * state["n"] + i_s[..., None] * kf
    num = torch.einsum("bhvk,bhk->bhv", C1, qf)
    denom = torch.einsum("bhk,bhk->bh", n1, qf)
    h = num / torch.maximum(torch.abs(denom), torch.exp(-m1))[..., None]
    y = _mlstm_out(p, cfg, h[:, None], z)
    return y, {"conv": conv_state, "C": C1, "n": n1, "m": m1}


# ===========================================================================
# sLSTM (scalar memory, true nonlinear recurrence -> sequential steps)
# ===========================================================================

def _slstm_cell(p: Mapping[str, Tensor], cfg: ModelConfig, pre: Tensor,
                state: dict) -> dict:
    """pre: (B, 4d) input projection for one step."""
    B = pre.shape[0]
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    h_prev = state["h"].reshape(B, H, dh)
    rec = torch.einsum("bhd,hgde->bghe", h_prev, p["r"])        # (B,4,H,dh)
    rec = rec.reshape(B, 4 * d)
    zif_o = pre.float() + rec + p["b"]
    z_pre, i_pre, f_pre, o_pre = torch.chunk(zif_o, 4, dim=-1)   # (B,d) each

    f_log = F.logsigmoid(f_pre)
    m1 = torch.maximum(f_log + state["m"], i_pre)
    i_g = torch.exp(i_pre - m1)
    f_g = torch.exp(f_log + state["m"] - m1)
    c1 = f_g * state["c"] + i_g * torch.tanh(z_pre)
    n1 = f_g * state["n"] + i_g
    h1 = torch.sigmoid(o_pre) * c1 / torch.clamp(n1, min=1e-6)
    return {"c": c1, "n": n1, "m": m1, "h": h1}


def slstm_forward(p: Mapping[str, Tensor], cfg: ModelConfig, x: Tensor,
                  state: Optional[dict] = None, return_state: bool = False):
    B, S, d = x.shape
    if state is None:
        state = zero_state(cfg, "slstm", B, x.dtype, x.device)
    p = _gathered(p)
    pre = x @ p["w_in"]                                          # (B,S,4d)
    hs = []
    for t in range(S):
        state = _slstm_cell(p, cfg, pre[:, t], state)
        hs.append(state["h"])
    h = torch.stack(hs, dim=1).to(x.dtype)                       # (B,S,d)
    h = rms_norm(h, p["out_norm"], 1e-6)
    y = h + ffn_apply(p["ffn"], h)
    return y, (state if return_state else None)


def slstm_step(p: Mapping[str, Tensor], cfg: ModelConfig, x1: Tensor,
               state: dict):
    p = _gathered(p)
    pre = x1[:, 0] @ p["w_in"]
    st1 = _slstm_cell(p, cfg, pre, state)
    h = rms_norm(st1["h"].to(x1.dtype), p["out_norm"], 1e-6)
    y = h + ffn_apply(p["ffn"], h)
    return y[:, None, :], st1


FORWARD = {"mamba": (mamba_forward, mamba_step),
           "mlstm": (mlstm_forward, mlstm_step),
           "slstm": (slstm_forward, slstm_step)}
