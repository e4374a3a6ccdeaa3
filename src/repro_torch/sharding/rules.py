"""Partition-spec rules of the port (``repro.sharding.rules``' twin): every
parameter, cache and activation leaf mapped to a spec over the production
mesh ``("pod", "data", "model")`` or a host mesh ``("data", "model")``.

Strategy (the reference's baseline):
  * 2-D weight sharding (ZeRO-3-style): each matrix shards one dim over
    "data" (FSDP) and, where divisible, its TP-natural dim over "model".
  * batch over ("pod","data"); residual activations replicated over "model".
  * MoE experts over "model" (EP); expert matrices additionally over "data".
  * KV caches: batch over "data"; heads over "model" when divisible, else
    sequence over "model" (SP).
  * dims that do not divide an axis are replicated (``maybe``) — e.g.
    smollm's 15 heads.

Pure Python: a spec is a :class:`P` (a tuple whose entries are an axis
name, a tuple of axis names, or None), and a mesh is anything with
``.shape`` (axis name -> size) and ``.axis_names`` — no process group is
needed to compute one.  The port's blocks are unrolled
(``models/model.py``), so a block leaf's spec here is the reference's
without its leading repeats ``None``; the contiguous cache keeps the
reference's stacked layout and its specs.  ``block_slices`` cuts a leaf's
shape into one mesh position's block.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

from repro_torch.models.config import ModelConfig


class P(tuple):
    """A partition spec: one entry per leading dim (an axis name, a tuple
    of axis names, or None = replicated); dims past its length are
    replicated.  ``P("data", None) == ("data", None)``."""

    def __new__(cls, *axes):
        return tuple.__new__(cls, axes)

    def __repr__(self):
        return "P" + tuple.__repr__(tuple(self))


def _axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= _axis_size(mesh, n)
        return out
    return mesh.shape[name]


def maybe(dim: int, axis, mesh):
    """Return ``axis`` if ``dim`` is divisible by its size, else None."""
    if axis is None:
        return None
    return axis if dim % _axis_size(mesh, axis) == 0 else None


def batch_axes(mesh):
    axes = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    return axes if len(axes) > 1 else axes[0]


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def _param_spec(path: str, shape: Tuple[int, ...], mesh,
                cfg: ModelConfig) -> P:
    """The reference's rule for the leaf at ``path`` (``g0/b0/attn/wq``;
    group leaves carry the leading repeats dim in ``shape``)."""
    dp = "data" if "data" in mesh.axis_names else None
    mp = "model"
    stacked = path.split("/")[0].startswith(("g", "enc_g")) and \
        path.split("/")[0] not in ("final_norm",)
    lead = (None,) if stacked else ()
    body = shape[1:] if stacked else shape

    def out(*spec):
        return P(*(lead + tuple(spec)))

    last = path.split("/")[-1]
    parent = path.split("/")[-2] if "/" in path else ""

    if len(body) <= 1:
        return out(*([None] * len(body)))

    # --- embeddings / head ---------------------------------------------------
    if last == "embed":
        return P(maybe(shape[0], mp, mesh), maybe(shape[1], dp, mesh))
    if last == "lm_head":
        return P(maybe(shape[0], dp, mesh), maybe(shape[1], mp, mesh))

    # --- MoE -----------------------------------------------------------------
    if parent == "moe" or (parent == "shared" and "moe" in path):
        if last == "router":
            return out(None, None)
        if last in ("w_gate", "w_up", "w_down"):
            if len(body) == 3:
                if last == "w_down":
                    return out(maybe(body[0], mp, mesh),
                               maybe(body[1], dp, mesh), None)
                return out(maybe(body[0], mp, mesh), None,
                           maybe(body[2], dp, mesh))
            if last == "w_down":  # shared expert (fs, d)
                return out(maybe(body[0], mp, mesh), maybe(body[1], dp, mesh))
            return out(maybe(body[0], dp, mesh), maybe(body[1], mp, mesh))

    # --- attention -----------------------------------------------------------
    if parent == "attn":
        if last in ("wq",):
            ok = cfg.n_heads % _axis_size(mesh, mp) == 0
            return out(maybe(body[0], dp, mesh), mp if ok else None)
        if last in ("wk", "wv"):
            ok = cfg.n_kv_heads % _axis_size(mesh, mp) == 0
            return out(maybe(body[0], dp, mesh), mp if ok else None)
        if last == "wo":
            ok = cfg.n_heads % _axis_size(mesh, mp) == 0
            return out(mp if ok else None, maybe(body[1], dp, mesh))

    # --- MLA -----------------------------------------------------------------
    if parent == "mla":
        if cfg.shard_variant == "mla_tp":
            if last == "wq_a":
                return out(maybe(body[0], dp, mesh), None)
            if last == "wq_b":
                ok = cfg.n_heads % _axis_size(mesh, mp) == 0
                return out(maybe(body[0], dp, mesh), mp if ok else None)
            if last == "wkv_a":
                return out(maybe(body[0], dp, mesh), None)
        if last == "wq_a":
            return out(maybe(body[0], dp, mesh), maybe(body[1], mp, mesh))
        if last == "wq_b":
            return out(maybe(body[0], mp, mesh), maybe(body[1], dp, mesh))
        if last == "wkv_a":
            return out(maybe(body[0], dp, mesh), maybe(body[1], mp, mesh))
        if last in ("wk_b", "wv_b"):   # (H, r, hd)
            return out(maybe(body[0], mp, mesh), None, None)
        if last == "wo":
            return out(maybe(body[0], mp, mesh), maybe(body[1], dp, mesh))

    # --- dense FFN -------------------------------------------------------------
    if parent == "ffn":
        if last == "w_down":
            return out(maybe(body[0], mp, mesh), maybe(body[1], dp, mesh))
        return out(maybe(body[0], dp, mesh), maybe(body[1], mp, mesh))

    # --- mamba -----------------------------------------------------------------
    if parent == "mamba":
        if last == "in_proj":
            return out(maybe(body[0], dp, mesh), maybe(body[1], mp, mesh))
        if last == "conv_w":
            return out(None, maybe(body[1], mp, mesh))
        if last == "x_proj":
            return out(maybe(body[0], mp, mesh), None)
        if last == "dt_w":
            return out(None, maybe(body[1], mp, mesh))
        if last == "A_log":
            return out(maybe(body[0], mp, mesh), None)
        if last == "out_proj":
            return out(maybe(body[0], mp, mesh), maybe(body[1], dp, mesh))

    # --- xLSTM blocks: small model — DP-shard the largest dim only -------------
    if parent in ("mlstm", "slstm") or "mlstm" in path or "slstm" in path:
        big = max(range(len(body)), key=lambda i: body[i])
        spec = [None] * len(body)
        spec[big] = maybe(body[big], dp, mesh)
        return out(*spec)

    # --- fallback: FSDP over the largest divisible dim ---------------------------
    big = max(range(len(body)), key=lambda i: body[i])
    spec = [None] * len(body)
    spec[big] = maybe(body[big], dp, mesh)
    return out(*spec)


def ref_path(cfg: ModelConfig, name: str) -> str:
    """The reference's tree path of the port's parameter ``name``:
    ``blocks.5.attn.wq`` -> ``g{i}/b{j}/attn/wq`` (block 5 is group i's
    period slot j in some repeat), ``enc_blocks.*`` -> ``enc_g{i}/...``,
    top-level leaves unchanged."""
    head, _, rest = name.partition(".")
    if head not in ("blocks", "enc_blocks"):
        return name.replace(".", "/")
    n_str, _, leaf = rest.partition(".")
    n = int(n_str)
    groups = cfg.groups if head == "blocks" else cfg.encoder_groups
    prefix = "g" if head == "blocks" else "enc_g"
    for i, g in enumerate(groups):
        size = g.repeats * len(g.period)
        if n < size:
            return f"{prefix}{i}/b{n % len(g.period)}/" + leaf.replace(".", "/")
        n -= size
    raise KeyError(f"{name}: block index past the config's groups")


def param_spec(cfg: ModelConfig, name: str, shape: Tuple[int, ...],
               mesh) -> P:
    """Spec of the port's parameter ``name`` with (unstacked) ``shape``:
    the reference's spec of its leaf, the leading repeats entry dropped."""
    path = ref_path(cfg, name)
    if path.startswith(("g", "enc_g")) and path != "final_norm":
        return P(*_param_spec(path, (1,) + tuple(shape), mesh, cfg)[1:])
    return _param_spec(path, tuple(shape), mesh, cfg)


def param_specs(cfg: ModelConfig, shapes: Mapping[str, Tuple[int, ...]],
                mesh) -> Dict[str, P]:
    """``shapes``: the port's parameter names -> full shapes (a ``Model``'s
    ``named_parameters()`` shapes, or ``meta`` tensors)."""
    return {name: param_spec(cfg, name, tuple(s), mesh)
            for name, s in shapes.items()}


# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------

def _cache_spec(path: str, shape, mesh, cfg: ModelConfig) -> P:
    if path == "pos":
        return P()
    dp = batch_axes(mesh)
    mp = "model"
    body = shape[1:]  # strip the stacked repeats dim
    last = path.split("/")[-1]

    def out(*spec):
        return P(*((None,) + tuple(spec)))

    if last in ("k", "v"):            # (B, S, Hkv, hd)
        if cfg.n_kv_heads % _axis_size(mesh, mp) == 0:
            return out(maybe(body[0], dp, mesh), None, mp, None)
        return out(maybe(body[0], dp, mesh), maybe(body[1], mp, mesh),
                   None, None)
    if last in ("ck", "cv"):          # (B, Lc, Hkv, hd)
        return out(maybe(body[0], dp, mesh), None, None, None)
    if last == "ckv":                 # (B, S, r)
        return out(maybe(body[0], dp, mesh), maybe(body[1], mp, mesh), None)
    if last == "krope":               # (B, S, rh)
        return out(maybe(body[0], dp, mesh), maybe(body[1], mp, mesh), None)
    if last == "conv":                # (B, K-1, di)
        return out(maybe(body[0], dp, mesh), None, maybe(body[2], mp, mesh))
    if last == "h" and len(body) == 3:  # mamba state (B, di, N)
        return out(maybe(body[0], dp, mesh), maybe(body[1], mp, mesh), None)
    spec = [None] * len(body)
    if body:
        spec[0] = maybe(body[0], dp, mesh)
    return out(*spec)


def cache_specs(cfg: ModelConfig, cache_shapes: Mapping, mesh) -> dict:
    """``cache_shapes``: the contiguous cache's nested dict (``pos``,
    ``g{i}/b{j}/<leaf>``) of shapes or tensors -> the same tree of specs."""
    def walk(tree, prefix):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, Mapping):
                out[k] = walk(v, path)
            elif path == "pos":
                out[k] = P()
            else:
                out[k] = _cache_spec(path, tuple(getattr(v, "shape", v)),
                                     mesh, cfg)
        return out
    return walk(cache_shapes, "")


# ---------------------------------------------------------------------------
# activation / batch rules
# ---------------------------------------------------------------------------

def act_rules(mesh, batch: Optional[int] = None) -> Dict[str, P]:
    dp = batch_axes(mesh)
    if batch is not None:
        dp = maybe(batch, dp, mesh)
    return {"act.res": P(dp, None, None)}


def batch_spec(mesh, batch: Optional[int] = None) -> P:
    dp = batch_axes(mesh)
    if batch is not None:
        dp = maybe(batch, dp, mesh)
    return P(dp, None)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def axis_index(mesh, axis, coords: Mapping[str, int]) -> int:
    """Row-major index of a mesh position along ``axis`` (a name or a
    tuple of names, as a spec entry holds)."""
    if isinstance(axis, tuple):
        idx = 0
        for a in axis:
            idx = idx * mesh.shape[a] + coords[a]
        return idx
    return coords[axis]


def block_slices(shape: Tuple[int, ...], spec, mesh,
                 coords: Mapping[str, int]) -> Tuple[slice, ...]:
    """The slices of a ``shape`` leaf that mesh position ``coords`` holds
    under ``spec`` (a sharded dim splits into equal contiguous blocks in
    row-major order of its axes)."""
    out = []
    for i, n in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        if ax is None:
            out.append(slice(None))
            continue
        size = _axis_size(mesh, ax)
        if n % size:
            raise ValueError(f"dim {i} of {shape} does not divide {ax!r} "
                             f"({size})")
        b = n // size
        j = axis_index(mesh, ax, coords)
        out.append(slice(j * b, (j + 1) * b))
    return tuple(out)


def block_shape(shape: Tuple[int, ...], spec, mesh) -> Tuple[int, ...]:
    """The shape of one block of a ``shape`` leaf under ``spec``."""
    return tuple(n // _axis_size(mesh, spec[i])
                 if i < len(spec) and spec[i] is not None else n
                 for i, n in enumerate(shape))
