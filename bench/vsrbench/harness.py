"""One run of one cell: build the system, offer the cell's traffic for the
window, read the device, check the answers against the plain reference,
and compute the cell's metrics.

``run_cell`` is what ``run.py`` calls on the card; the CPU tests and the
tools call its pieces (``build``, ``serve``, ``judge``) with a system
built once and reused, the tests at small sizes (``config``/``encoder``).
"""

from __future__ import annotations

import math
import sys
import time
from typing import Dict, Optional, Tuple

import torch

from vsrbench import check as C
from vsrbench import spec as S
from vsrbench.drive import Run, drive
from vsrbench.traffic import warmup_requests

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: ``repro_torch`` is the program, ``repro`` is not)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def build(cell: S.Cell, seed: int, device: str = "cuda",
          config: Optional[dict] = None, encoder: Optional[dict] = None):
    from vsrbench.system import System
    return System(cell, seed, device=device, config=config, encoder=encoder)


def serve(system, cell: S.Cell, seed: int, seconds: float, trace: bool,
          t_process: float) -> Run:
    """The window: the cell's traffic through the system's frontend,
    drained; with ``trace`` the profiler runs over whole batches."""
    from vsrbench.system import blocked
    from vsrbench.trace import Tracer, prime
    run = Run(cell=cell.name, mix=cell.mix, config=system.config, seed=seed,
              seconds=float(seconds), t_process=t_process)
    tracer = Tracer(cell.mix["trace_seconds"]) if trace else None
    before = None
    if tracer is not None:
        def before(fe):
            # the profiler's first start sets up the device tracer for
            # seconds: do it on the frontend's thread, which starts the
            # traced session later, over one blocked request, before the
            # window opens
            system.on_batch_start = lambda k: prime()
            req = warmup_requests(cell.mix, 1, seed)[0]
            fe.submit(system.make_request(req)).result()
            system.batches.clear()
            system.on_batch_start = tracer.on_batch_start
            system.on_batch_end = tracer.on_batch_end
    try:
        drive(system, run, blocked, before)
    finally:
        system.on_batch_start = system.on_batch_end = None
    if system.device.type == "cuda":
        torch.cuda.synchronize()
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    if tracer is not None:
        run.trace = tracer.finish(len(run.batches))
    return run


def judge(system, run: Run, limits: dict, release: bool = True
          ) -> Dict[str, Tuple[Optional[float], float]]:
    """Each number compared, beside its limit."""
    served = dict(system.served)
    counts = C.judge_answers(run, served, system.model_name)
    picked = C.sample(run, served, int(run.mix["check_sample"]))
    family, device = system.family, system.device
    if release:
        system.release()
    gaps = C.logit_gaps(family, run.config, run.seed, picked, device)
    checks = {k: (float(v), float(limits[k])) for k, v in counts.items()}
    for k, v in gaps.items():
        if k in limits:
            checks[k] = (v, float(limits[k]))
    return checks


def metrics(cell: S.Cell, run: Run, trace: bool) -> Dict[str, dict]:
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = S.reader(m["name"])(run)
        # an infinite latency (a failed request) fails the check instead
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def result_line(cell: S.Cell, run: Run, checks, trace: bool,
                device: dict) -> dict:
    from vsrbench.trace import breakdown
    line = {"correct": C.verdict(checks),
            "attempted": len(run.requests),
            "failed": sum(not r.answered for r in run.requests.values()),
            "metrics": metrics(cell, run, trace),
            "device": device}
    if trace and run.trace is not None:
        line["device"] = dict(device, busy_s=run.trace.busy_s,
                              window_s=run.trace.window_s)
        line["breakdown"] = breakdown(run.trace, run.batches)
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return line


def checks_text(checks) -> str:
    return "\n".join(f"check {k}: {v} (limit {lim})"
                     for k, (v, lim) in checks.items())


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             t_process: float) -> Tuple[Optional[dict], str]:
    """One run on the card: ``(result line, checks text)``; the line is
    None when a module of JAX or of the JAX package was loaded (the text
    then names them)."""
    from vsrbench.system import device_info
    cell = S.resolve(cell_name)
    system = build(cell, seed)
    run = serve(system, cell, seed, seconds, trace, t_process)
    bad = forbidden_modules()
    if bad:
        return None, "loaded modules that the port may not load: " + \
            ", ".join(bad)
    dev = device_info(cell.chips)
    t0 = time.perf_counter()
    checks = judge(system, run, cell.limits)
    print(f"reference check took {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    return result_line(cell, run, checks, trace, dev), checks_text(checks)
