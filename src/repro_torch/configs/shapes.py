"""Input-shape cells and their (arch x shape) applicability (copy of
``repro.configs.shapes``, over the port's registry).

  train_4k     seq_len=4096    global_batch=256   runs train_step
  prefill_32k  seq_len=32768   global_batch=32    runs prefill
  decode_32k   seq_len=32768   global_batch=128   runs serve_step (1 token, 32k KV)
  long_500k    seq_len=524288  global_batch=1     runs serve_step (1 token, 500k cache)

long_500k runs only for sub-quadratic archs (jamba, xlstm); the skips
are surfaced by cells().
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.registry import get_config, list_archs


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def applicable(arch: str, shape: str) -> bool:
    cfg = get_config(arch)
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False
    return True


def cells(include_skips: bool = False):
    """Yield (arch, shape, applicable) triples over the full 40-cell matrix."""
    for arch in list_archs():
        for shape in SHAPES:
            ok = applicable(arch, shape)
            if ok or include_skips:
                yield arch, shape, ok
