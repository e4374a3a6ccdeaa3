"""What the metric readers (``metrics/<name>.py``) share.  Each reader is
``read(run) -> float | None``: None where the run holds nothing to read,
and the harness then leaves the metric out of the result line."""

from __future__ import annotations

from typing import List, Optional, Sequence

from roofline import PEAKS
from vsrbench import spec as S


def settled(run, recs) -> list:
    """``recs`` less, in a traced run, those answered after the profiler's
    stop: stopping it holds the frontend's thread for seconds (the
    profiler's own processing), which no request should be charged."""
    t = run.trace
    if t is None:
        return list(recs)
    return [r for r in recs if r.done <= t.t_stop]


def served(recs) -> list:
    return [r for r in recs if r.answered and not r.blocked]


def prompt_tokens(run, rec) -> int:
    return min(rec.words, run.cap)


def batch_requests(run, batches) -> list:
    idx = [i for b in batches for i in b.indices]
    return [run.requests[i] for i in idx if i in run.requests]


def stage_ms_per_request(run, include: Optional[Sequence[str]] = None,
                         exclude: Sequence[str] = ()) -> Optional[float]:
    """Batch stage time (``stage:*`` spans) summed over the window's
    batches, per request of those batches."""
    batches = window_or_all(run)
    n = sum(len(b.indices) for b in batches)
    if not n:
        return None
    total = sum(ms for b in batches for name, ms in b.stages
                if (include is None or name in include)
                and name not in exclude)
    return total / n


def window_or_all(run) -> list:
    """The window's whole batches (closed loop), or the batches that
    started within the window (open loop); in a traced run only those that
    ended by the profiler's stop."""
    if run.mix["loop"] == "closed":
        out = run.window_batches()
    else:
        out = [b for b in run.batches if run.t_open <= b.start < run.t_close]
    if run.trace is not None:
        out = [b for b in out if b.end <= run.trace.t_stop]
    return out


def window_requests(run) -> list:
    """The window's requests (``Run.in_window``), settled."""
    return settled(run, run.in_window())


def traced_batches(run) -> list:
    t = run.trace
    if t is None or t.last_batch is None:
        return []
    return run.batches[t.first_batch:t.last_batch + 1]


def traced_requests(run) -> list:
    return served(batch_requests(run, traced_batches(run)))


def model_flops(run, recs) -> float:
    fm = S.flops_model(run.config)
    n_new = int(run.mix["answer_tokens"])
    return sum(fm.request_flops(run.config, prompt_tokens(run, r), n_new)
               for r in recs)


def mfu_pct(run) -> Optional[float]:
    recs = traced_requests(run)
    if not recs or run.trace.window_s <= 0:
        return None
    return 100.0 * model_flops(run, recs) / (
        run.trace.window_s * PEAKS["bf16_flops_per_s"])


def idle_pct(run) -> Optional[float]:
    t = run.trace
    if t is None or t.window_s <= 0 or not t.events:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def kernel_seconds(events: List) -> float:
    return sum(e.end - e.start for e in events)

