"""The load: a closed loop of clients or an open loop of due times, offered
to the system's ``AsyncFrontend`` from one driver thread, and the run's
record (requests, batches, window, trace).

Closed loop: ``clients`` requests are submitted at once; each answer lets
its client submit the next request of the stream, until the window has
run ``seconds`` from the dispatch of the first batch.  Open loop: request
``i`` is submitted at its due time, ``rate_per_s`` on average, for
``seconds``; its latency counts from the due time.  Either way every
submitted request is waited for, up to ``DRAIN_S`` past the window's
close; one that never comes is a failure.
"""

from __future__ import annotations

import math
import time
from concurrent.futures import FIRST_COMPLETED, wait
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from vsrbench import stats
from vsrbench.traffic import Traffic, TrafficRequest, lateness, prompt_cap

DRAIN_S = 60.0


@dataclass
class RequestRecord:
    index: int
    text: str
    words: int
    pii: bool
    due: float                        # perf_counter seconds
    sent: float = math.nan
    done: float = math.inf            # inf: no answer came
    error: Optional[str] = None
    blocked: Optional[bool] = None
    model: str = ""
    finish: str = ""
    content: str = ""
    usage: dict = field(default_factory=dict)
    trace: list = field(default_factory=list)

    @property
    def answered(self) -> bool:
        return self.error is None and math.isfinite(self.done)

    @property
    def latency_s(self) -> float:
        return self.done - self.due if self.answered else math.inf


@dataclass
class Run:
    cell: str
    mix: dict
    config: dict
    seed: int
    seconds: float
    t_process: float                  # perf_counter at process start
    t_first: float = math.nan         # first timed request submitted
    t_open: float = math.nan          # the window
    t_close: float = math.nan
    requests: Dict[int, RequestRecord] = field(default_factory=dict)
    batches: list = field(default_factory=list)     # system.BatchRecord
    lateness_s: Optional[float] = None
    trace: Optional[object] = None                  # trace.TraceData
    memory_peak_bytes: int = 0

    @property
    def setup_s(self) -> float:
        return self.t_first - self.t_process

    @property
    def cap(self) -> int:
        return prompt_cap(self.mix)

    def in_window(self) -> List[RequestRecord]:
        """The requests of the window: in a closed loop those of its whole
        batches, in an open loop those due within it."""
        if self.mix["loop"] == "closed":
            idx = {i for b in self.window_batches() for i in b.indices}
            return [self.requests[i] for i in sorted(idx)
                    if i in self.requests]
        return [r for r in self.requests.values()
                if self.t_open <= r.due < self.t_close]

    def window_batches(self) -> List[object]:
        return [b for b in self.batches
                if b.start >= self.t_open and b.end <= self.t_close]


def _fill(rec: RequestRecord, fut, blocked_fn) -> None:
    try:
        resp, outcome = fut.result()
    except Exception as e:                  # the request failed upstream
        rec.error, rec.done = repr(e), math.inf
        return
    rec.blocked = blocked_fn(resp)
    rec.model, rec.finish = resp.model, resp.finish_reason
    rec.content, rec.usage = resp.content, dict(resp.usage or {})
    rec.trace = list(outcome.trace)
    if resp.finish_reason == "error":
        rec.error = resp.content


def _submit(system, fe, r: TrafficRequest, due: float, pending: dict,
            run: Run) -> None:
    from repro_torch.core.types import RouterOverloadError
    rec = RequestRecord(index=r.index, text=r.text, words=r.words, pii=r.pii,
                        due=due)
    run.requests[r.index] = rec
    req = system.make_request(r)
    rec.sent = time.perf_counter()
    try:
        fut = fe.submit(req)
    except RouterOverloadError as e:
        rec.error = repr(e)
        return
    fut.add_done_callback(
        lambda f, rec=rec: setattr(rec, "done", time.perf_counter()))
    pending[fut] = rec


def _collect(done, pending: dict, blocked_fn) -> List[RequestRecord]:
    out = []
    for f in done:
        rec = pending.pop(f)
        _fill(rec, f, blocked_fn)
        out.append(rec)
    return out


def closed_loop(system, run: Run, blocked_fn, before=None) -> None:
    mix = run.mix
    traffic = Traffic(mix, run.seed)
    fe = system.frontend()
    if before is not None:
        before(fe)
    pending: dict = {}
    nxt = 0
    try:
        run.t_first = time.perf_counter()
        for _ in range(int(mix["clients"])):
            _submit(system, fe, traffic.request(nxt), time.perf_counter(),
                    pending, run)
            nxt += 1
        while pending:
            if math.isnan(run.t_open) and system.batches:
                run.t_open = system.batches[0].start
                run.t_close = run.t_open + run.seconds
            limit = (run.t_close + DRAIN_S) if math.isfinite(run.t_close) \
                else run.t_first + run.seconds + DRAIN_S
            left = limit - time.perf_counter()
            if left <= 0:
                break
            done, _ = wait(list(pending), timeout=min(left, 0.5),
                           return_when=FIRST_COMPLETED)
            for _rec in _collect(done, pending, blocked_fn):
                if math.isnan(run.t_open) or \
                        time.perf_counter() < run.t_close:
                    _submit(system, fe, traffic.request(nxt),
                            time.perf_counter(), pending, run)
                    nxt += 1
    finally:
        fe.close(timeout=DRAIN_S)
    # the window closes at the end of the last whole batch within it
    spans = [(b.start, b.end) for b in system.batches if b.end]
    got = stats.whole_batches(spans, run.t_open, run.seconds)
    run.batches = list(system.batches)
    if got is not None:
        run.t_close = system.batches[got[1]].end


def open_loop(system, run: Run, blocked_fn, before=None) -> None:
    mix = run.mix
    traffic = Traffic(mix, run.seed)
    fe = system.frontend()
    if before is not None:
        before(fe)
    pending: dict = {}
    due_l, sent_l = [], []
    try:
        t0 = time.perf_counter() + 0.05
        run.t_open, run.t_close = t0, t0 + run.seconds
        i = 0
        while True:
            due = t0 + traffic.due_s(i)
            if due >= run.t_close:
                break
            r = traffic.request(i)
            now = time.perf_counter()
            if due > now:
                time.sleep(due - now)
            _submit(system, fe, r, due, pending, run)
            if i == 0:
                run.t_first = run.requests[0].sent
            due_l.append(due)
            sent_l.append(run.requests[i].sent)
            i += 1
            _collect([f for f in list(pending) if f.done()], pending,
                     blocked_fn)
        while pending:
            left = run.t_close + DRAIN_S - time.perf_counter()
            if left <= 0:
                break
            done, _ = wait(list(pending), timeout=min(left, 0.5),
                           return_when=FIRST_COMPLETED)
            _collect(done, pending, blocked_fn)
    finally:
        fe.close(timeout=DRAIN_S)
    run.lateness_s = lateness(due_l, sent_l)
    run.batches = list(system.batches)


def drive(system, run: Run, blocked_fn, before=None) -> None:
    """The window's load on a new frontend; ``before(frontend)`` runs
    first, before any timed request."""
    system.batches.clear()
    (closed_loop if run.mix["loop"] == "closed" else open_loop)(
        system, run, blocked_fn, before)
