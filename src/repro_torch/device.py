"""Device selection shared by the port's entry points.

Entry points default to the card.  With no CUDA device they raise rather
than fall back, so a run never lands on the CPU unless its caller asked
for it with ``device="cpu"`` (the CPU tests do).
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!s}: use 'cuda' or 'cpu'")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` string -> torch dtype."""
    table = {"bfloat16": torch.bfloat16, "float32": torch.float32,
             "float16": torch.float16}
    if name not in table:
        raise ValueError(f"unsupported dtype {name!r}")
    return table[name]
