"""Roofline terms of one step on an NVIDIA H100 (``repro.roofline.analysis``'
twin).

Constants: the H100 SXM data sheet (dense rates, no sparsity, at the full
700 W power limit), the one home of these numbers in the port:
  989e12 FLOP/s bf16 / fp16 on the tensor cores, 495e12 TF32, 67e12
  float32 outside the tensor cores; 3.35e12 B/s HBM3; 450e9 B/s NVLink
  each way.

Terms (seconds), per device:
  compute    = sum over dtypes of FLOPs[dtype] / PEAK_FLOPS[dtype]
  memory     = bytes / HBM_BW
  collective = collective operand bytes / NVLINK_BW

One change from the reference: it divides one FLOP total by the bf16
peak, while ``t_compute`` here sums the FLOPs **by dtype** over that
dtype's peak.  The port runs float32 paths (the signal encoder, kernel 6,
the reduced phases) with TF32 off, at 67 TFLOP/s, not 989.

``t_collective`` is a projection for one card per rank over NVLink.  On
one card the ranks' collectives are host-staged ``gloo`` (``launch.mesh``),
far slower than this term says.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12}
HBM_BW = 3.35e12             # bytes/s, one card
NVLINK_BW = 450e9            # bytes/s each way, one card


def peak_flops(dtype: str) -> float:
    """The peak rate of ``dtype`` (a name such as ``"bfloat16"``); dtypes
    without a rate of their own (float64, integers) take float32's."""
    return PEAK_FLOPS.get(dtype, PEAK_FLOPS["float32"])


def compute_seconds(flops_by_dtype: Dict[str, float]) -> float:
    return sum(f / peak_flops(dt) for dt, f in flops_by_dtype.items())


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_breakdown: Dict[str, float]
    model_flops_total: float
    peak_memory_per_device: float
    # FLOPs by dtype; empty means every FLOP is bf16 (the reference's
    # single-peak record)
    flops_by_dtype: Dict[str, float] = field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        if not self.flops_by_dtype:
            return self.flops_per_device / PEAK_FLOPS["bfloat16"]
        return compute_seconds(self.flops_by_dtype)

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (counted FLOPs summed over chips)."""
        total = self.flops_per_device * self.chips
        return self.model_flops_total / max(total, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved if the step runs at the
        dominant-term time: (MODEL_FLOPS / chips / bf16 peak) / bound_time."""
        ideal = self.model_flops_total / self.chips / PEAK_FLOPS["bfloat16"]
        return ideal / max(self.bound_time, 1e-30)

    def to_dict(self) -> dict:
        d = asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, dominant=self.dominant,
                 useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Roofline":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})


def summarize(r: Roofline) -> str:
    return (f"{r.arch:22s} {r.shape:12s} {r.mesh:9s} "
            f"comp={r.t_compute*1e3:9.3f}ms mem={r.t_memory*1e3:9.3f}ms "
            f"coll={r.t_collective*1e3:9.3f}ms dom={r.dominant:10s} "
            f"useful={r.useful_flops_ratio:6.3f} "
            f"roofline={r.roofline_fraction*100:6.2f}%")
