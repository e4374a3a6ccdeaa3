"""Collective traffic of a step (``repro.roofline.hlo_parse``' twin).

The reference parses collectives out of compiled HLO text.  The port has
no HLO: the mesh's collectives report themselves.  ``launch.mesh.SpecMesh``
calls ``Recorder.note(kind, operand_bytes, group)`` for every collective
a step issues, and ``Recorder.result()`` gives the reference's layout:
``{kind: {"bytes", "count", "ring_time"}, ..., "total": {...}}`` with
operand bytes per kind (the rank's input to the collective) and the
reference's ring-time estimate by group size over ``analysis.NVLINK_BW``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

from repro_torch.roofline.analysis import NVLINK_BW

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def ring_bytes(kind: str, operand_bytes: float, group: int) -> float:
    """Bytes one rank sends in a ring implementation over ``group`` ranks
    (``repro.roofline.hlo_cost``'s model)."""
    n = max(int(group), 1)
    if kind == "all-gather":
        return (n - 1) * operand_bytes
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * operand_bytes
    if kind in ("reduce-scatter", "all-to-all"):
        return (n - 1) / n * operand_bytes
    return float(operand_bytes)


class Recorder:
    """Per-kind totals of the collectives noted while it is attached to a
    mesh: operand bytes, counts and ring time."""

    def __init__(self):
        self._by_kind: Dict[str, dict] = defaultdict(
            lambda: {"bytes": 0.0, "count": 0, "ring_time": 0.0})

    def note(self, kind: str, operand_bytes: int, group: int) -> None:
        if kind not in COLLECTIVES:
            raise ValueError(f"unknown collective {kind!r}")
        if group <= 1:          # a group of one moves nothing
            return
        rec = self._by_kind[kind]
        rec["bytes"] += float(operand_bytes)
        rec["count"] += 1
        rec["ring_time"] += ring_bytes(kind, operand_bytes, group) / NVLINK_BW

    def result(self) -> Dict[str, Dict[str, float]]:
        """``{kind: {"bytes", "count", "ring_time"}}`` plus ``"total"``."""
        out = {k: dict(v) for k, v in self._by_kind.items()}
        out["total"] = {f: sum(v[f] for v in self._by_kind.values())
                        for f in ("bytes", "count", "ring_time")}
        return out
