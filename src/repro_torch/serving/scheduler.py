"""Disaggregated prefill/decode continuous-batching scheduler (paged).

The port of ``repro.serving.scheduler`` for paged text lanes.  Each fleet
member owns one :class:`DecodeScheduler` holding a persistent decode state
over a fixed pool of batch slots, plus a :class:`PrefillWorker` — the
admission-side half of the lane:

* the decode worker runs ONE batched decode step per ``step()`` over all
  slots with per-row positions (KV writes, rope phases and attention masks
  are per-row);
* the prefill worker runs admission prefills on its OWN cadence: at most
  ``prefill_budget`` prefill calls per scheduler step while decode rows
  are live (unbounded while the engine is idle), each optionally CHUNKED
  to ``prefill_chunk`` tokens.  Prefills write KV blocks straight into the
  shared :class:`BlockPool` under a row-private block table; when the
  prefill completes, the table is handed to the decode worker (``ready``
  queue → slot binding).

Correctness notes (as in the reference):

* Admission prefill is right-padded to a length bucket but samples at the
  row's last real position; pad garbage beyond the prompt is overwritten
  by decode steps before it ever enters a mask.
* Chunked prefill is token-exact vs the monolithic path: the first chunk
  (start == 0) runs local causal attention, later chunks take the
  gathered-view suffix program with per-row start offsets.  Intermediate
  chunk samples are discarded.
* Block hashes register at prefill COMPLETION, never at admission: a
  concurrent admission must not prefix-match blocks whose KV has not
  been written yet.
* The decode batch shape is fixed, so a freed slot still occupies a lane
  of the batched step — but it is MASKED out: its block-table row points
  at the trash block and its sampled token is discarded.

Preemption (QoS): a prefilled arrival that outranks the lowest-priority
running row evicts it at slot-binding time; when the POOL is the
bottleneck the prefill worker parks a strictly-lower-priority victim only
if the victim's releasable blocks make the admission fit.  Parked rows
release their blocks WITH chain hashes and re-enter the queue ahead of
same-priority waiters.

Speculative decoding (``spec=``): a :class:`DraftWorker` proposes k
tokens per row with a draft model over the SAME block table, the member
verifies all k+1 positions in one wide forward, and greedy acceptance keeps
the output identical to plain decode (``DecodeScheduler._decode_spec``).

Host state (positions, tables, last tokens) lives in numpy; each step
copies positions (int32) and tables (int32, the kernels' index type) to
the device.  The overload detector's probes are the reference's:
``queue_depth`` (queued, prefilling and prefilled-waiting requests),
``ttft_ewma`` / ``ttft_samples`` (noted where a request's first token is
stamped) and ``ttft_probe_ms`` (the EWMA floored by
``PrefillWorker.oldest_wait_s``).  The contiguous cache is a later slice
of the port.
"""

from __future__ import annotations

import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional

import numpy as np
import torch

from repro_torch.core.observability import METRICS
from repro_torch.core.prefix import chain_hashes
from repro_torch.serving.paged import BlockPool

# prompt-length buckets for admission prefill (the reference's; they bound
# the number of distinct prefill widths a lane ever runs)
PREFILL_BUCKETS = (16, 64)


def bucket_len(n: int, cap: int) -> int:
    """Padded prefill width for a prompt of ``n`` tokens (<= cap).  The
    reference's ``exact`` widths serve recurrent (SSM) state, not ported
    yet."""
    n = min(n, cap)
    for b in PREFILL_BUCKETS:
        if n <= b <= cap:
            return b
    return cap


@dataclass(frozen=True)
class SpecConfig:
    """Draft-model speculative decoding for one text lane.

    ``draft_arch`` names the registry arch whose model proposes ``k``
    tokens per round; the lane's own member verifies all k+1 positions in
    ONE wide forward, and greedy acceptance keeps output identical to the
    non-speculative path.  ``adaptive`` backs a lane off to plain decode
    when the per-slot acceptance EWMA (weight ``alpha`` per round) falls
    below ``min_accept``; ``probe_every`` is the BASE cadence of full-k
    probe rounds while backed off — each consecutive failed probe doubles
    the interval (capped at 8x) and one successful probe snaps it back."""
    draft_arch: str
    k: int = 4
    adaptive: bool = True
    probe_every: int = 16
    alpha: float = 0.6
    min_accept: float = 0.35


@dataclass
class SpecRuntime:
    """Steps + draft state the fleet hands a speculative lane."""
    cfg: object                      # draft ModelConfig
    params: object                   # draft MD.Model
    verify: object                   # target-side W-wide paged verify
    draft_propose: object            # k chained draft decode steps
    prefill_fresh: object            # draft paged admission prefills
    prefill_suffix: object           # (lazy draft-KV catch-up)
    init_cache_fn: object            # slots -> draft paged cache
    spec: SpecConfig = None


@dataclass
class SequenceState:
    """One in-flight (or queued / finished) request."""
    rid: int
    ids: np.ndarray                 # prompt token ids (exact, unpadded)
    max_new: int                    # tokens still to generate at submit
    t_submit: float
    slot: int = -1                  # -1 while queued
    t_first: float = 0.0            # first-token wall clock
    t_done: float = 0.0
    out: List[int] = field(default_factory=list)
    cached_tokens: int = 0          # prompt tokens served from the prefix cache
    prefill_tokens: int = 0         # prompt tokens actually prefilled
    priority: int = 0               # QoS admission priority (higher first)
    slo: str = ""                   # SLO class label (observability)
    folded: int = 0                 # out tokens folded into ids by _park
    parks: int = 0                  # times this sequence was preempted

    @property
    def ttft_ms(self) -> float:
        return (self.t_first - self.t_submit) * 1e3

    @property
    def tpot_ms(self) -> float:
        n = len(self.out)
        if n <= 1:
            return 0.0
        return (self.t_done - self.t_first) * 1e3 / (n - 1)


@dataclass
class PrefillJob:
    """One admission prefill in flight (or completed, awaiting a slot).
    The job owns its block list/table from ``_begin`` until slot binding
    hands both to the decode worker."""
    seq: SequenceState
    plen: int = 0                   # row position after the full prefill
    first: Optional[int] = None     # sampled first token (set at completion)
    row: Optional[List[int]] = None
    trow: Optional[np.ndarray] = None
    start: int = 0                  # next prompt index to prefill
    hashes: List[int] = field(default_factory=list)
    matched: int = 0

    @property
    def done(self) -> bool:
        return self.first is not None


class PrefillWorker:
    """Admission-side worker: turns queued requests into prefilled rows.

    ``step()`` runs at most ONE prefill call (one chunk), so the scheduler
    can interleave prefill progress with decode steps at a controlled
    budget.  Completed jobs land in ``ready`` (priority ordered) for the
    decode worker to bind into slots.
    """

    def __init__(self, sched: "DecodeScheduler", *,
                 chunk: Optional[int] = None, lookahead: int = 0):
        self.sched = sched
        self.chunk = chunk          # chunk width (None = whole suffix)
        self.lookahead = lookahead  # prefill-ahead depth when slots are full
        self.current: Optional[PrefillJob] = None
        self.ready: Deque[PrefillJob] = deque()
        self.prefills = 0           # prefill calls issued

    @property
    def backlog(self) -> int:
        """Requests prefilling or prefilled but not yet decoding."""
        return (1 if self.current is not None else 0) + len(self.ready)

    def oldest_wait_s(self, now: float) -> float:
        """Age of the oldest request that has not produced a first token
        (queued, mid-prefill, or parked awaiting resume)."""
        oldest = 0.0
        for seq in self.sched.queue:
            oldest = max(oldest, now - seq.t_submit)
        if self.current is not None:
            oldest = max(oldest, now - self.current.seq.t_submit)
        for job in self.ready:
            if job.seq.t_first == 0.0:
                oldest = max(oldest, now - job.seq.t_submit)
        return oldest

    # -- one unit of prefill work -------------------------------------------

    def step(self) -> bool:
        """Run one prefill call (start a job if none is current).
        Returns False when there is nothing runnable (empty queue, slot/
        lookahead gate, or pool stall)."""
        s = self.sched
        if self.current is None:
            if not s.queue or not self._may_begin():
                return False
            job = self._begin(s.queue[0])
            if job is None:          # pool cannot hold the row: retry later
                METRICS.inc("paged_admit_stall_total", arch=s.m.arch)
                return False
            s.queue.popleft()
            self.current = job
        self._chunk_step(self.current)
        self.prefills += 1
        if self.current.done:
            job, self.current = self.current, None
            self._complete(job)
        return True

    def _may_begin(self) -> bool:
        """Start the head request's prefill only if its finished row will
        have somewhere to go: a free slot, a preemptable lower-priority
        row, or lookahead headroom."""
        s = self.sched
        if None in s.active:
            return True
        head = s.queue[0]
        live = [x for x in s.active if x is not None]
        if live and head.priority > min(x.priority for x in live):
            return True              # binding will preempt the victim
        return len(self.ready) < self.lookahead

    def _begin(self, seq: SequenceState) -> Optional[PrefillJob]:
        s, m = self.sched, self.sched.m
        # over-long prompts keep the TAIL: generation needs the newest context
        seq.ids = seq.ids[-m.prompt_cap:]
        n = len(seq.ids)
        blk = m.block_tokens
        hashes = chain_hashes(seq.ids.tolist(), blk)
        matched = s.pool.match(hashes)
        # remaining budget, not max_new: a resumed row's folded output is
        # already inside ``n`` and must not inflate the allocation
        remaining = seq.max_new - len(seq.out)
        total = max(matched, min(s.max_blocks,
                                 -(-(n + remaining + 1) // blk)))
        if total - matched > s.pool.free_blocks:
            # pool exhausted: park a strictly-lower-priority victim ONLY
            # if its actually-releasable blocks make this admission fit
            victim = s._preempt_candidate(seq)
            if victim is None:
                return None
            freed = s.pool.releasable(s.row_blocks[victim.slot] or [])
            if total - matched > s.pool.free_blocks + freed:
                return None
            s._park(victim)
            matched = s.pool.match(hashes)   # victim blocks now matchable
            total = max(matched, min(s.max_blocks,
                                     -(-(n + remaining + 1) // blk)))
        row = s.pool.admit(hashes[:matched], total)
        if row is None:
            return None
        start = min(matched * blk, n - 1)    # >= 1 suffix token to sample
        # blocks freshly allocated for THIS row are ours to write; matched
        # blocks overlapping the write range must be copied first
        fresh = set(row[matched:])
        for src, dst in s.pool.ensure_writable(row, start // blk,
                                               exempt=fresh):
            s.cache = m.copy_block(s.cache, src, dst)
        trow = np.zeros((s.max_blocks,), np.int32)
        trow[:len(row)] = row
        seq.cached_tokens = start
        seq.prefill_tokens = 0
        s.cached_tokens += start
        s.pool.stats.cached_tokens += start
        return PrefillJob(seq=seq, plen=n, row=row, trow=trow, start=start,
                          hashes=hashes, matched=matched)

    def _chunk_step(self, job: PrefillJob):
        s, m = self.sched, self.sched.m
        seq = job.seq
        n = job.plen
        clen = n - job.start
        if self.chunk is not None:
            clen = min(clen, self.chunk)
        width = bucket_len(clen, m.prompt_cap)
        toks = np.zeros((1, width), np.int32)
        toks[0, :clen] = seq.ids[job.start:job.start + clen]
        fn = m.prefill_paged_fresh if job.start == 0 \
            else m.prefill_paged_suffix
        nxt, s.cache = fn(m.params, s._dev(toks), s._dev([clen]),
                          s._dev([job.start]), s._dev(job.trow[None]),
                          s.cache)
        job.start += clen
        seq.prefill_tokens += clen
        s.prefill_tokens += clen
        s.pool.stats.prefill_tokens += clen
        if job.start >= n:
            # intermediate chunk samples are discarded; the final chunk
            # samples at the prompt's true last position
            job.first = int(nxt[0])

    def _complete(self, job: PrefillJob):
        s = self.sched
        seq = job.seq
        if seq.t_first == 0.0:       # resumes keep their original TTFT
            seq.t_first = time.perf_counter()
            s._note_ttft(seq.ttft_ms)
        seq.out.append(job.first)
        # KV for every full prompt block is now written: make the blocks
        # discoverable for prefix matching
        s.pool.register(job.row[:len(job.hashes)], job.hashes)
        # priority-ordered handoff (FIFO within a class; parked resumes
        # ahead of same-priority)
        q = self.ready
        p, resumed = seq.priority, seq.parks > 0
        i = len(q)
        while i > 0 and (q[i - 1].seq.priority < p or
                         (resumed and q[i - 1].seq.priority == p)):
            i -= 1
        if i == len(q):
            q.append(job)
        else:
            q.insert(i, job)


class DraftWorker:
    """Draft-model side of speculative decoding for one decode lane.

    Owns the draft model's OWN paged cache over the same slot/block-table
    geometry as the target: the scheduler's ``tbl`` indexes both pools, so
    draft KV rides the blocks the target's pool already allocated — no
    extra BlockPool accounting, no extra refcounts.

    ``dpos[slot]`` counts how many CORRECT draft KV entries exist, and
    ``catch_up`` lazily prefills the missing token range through the
    draft's own paged prefill right before a speculative round — a freshly
    bound, resumed, or long-backed-off row pays one bucketed draft prefill
    instead of shadowing every admission.  After a round the draft trails
    the target by at most one token (``lag`` in {0, 1}), which the proposal
    loop absorbs by feeding the known-true token at step 1.

    Acceptance is tracked per SLOT (EWMA), deliberately persisting across
    the requests that flow through it: a lane under a homogeneous
    adversarial workload stays backed off to plain decode and only the
    periodic probe rounds re-test the draft."""

    def __init__(self, sched: "DecodeScheduler", rt: SpecRuntime):
        self.sched = sched
        self.rt = rt
        self.spec = rt.spec
        self.cache = rt.init_cache_fn(sched.slots)
        self.dpos = np.zeros((sched.slots,), np.int64)
        self.ewma = np.ones((sched.slots,), np.float64)  # optimistic start
        self.rounds_total = 0       # spec-eligible rounds (probe cadence)
        self.proposals = 0          # draft proposal dispatches
        self.catchup_prefills = 0   # draft catch-up prefill calls
        self.probe_scale = 1        # backoff multiplier on probe_every
        self.next_probe = 0         # rounds_total of the next probe round

    def reset_slot(self, slot: int):
        """Slot re-bound or parked: its draft KV no longer matches the
        sequence; the next round's catch_up rebuilds it.  The acceptance
        EWMA intentionally survives (see class docstring)."""
        self.dpos[slot] = 0

    def reset_stats(self):
        self.dpos[:] = 0
        self.ewma[:] = 1.0
        self.rounds_total = 0
        self.proposals = 0
        self.catchup_prefills = 0
        self.probe_scale = 1
        self.next_probe = 0

    def _full(self, seq: SequenceState) -> np.ndarray:
        """All known-true tokens of ``seq``: indices 0..pos (the last one
        is the pending token whose target KV is not yet written)."""
        if len(seq.out) > seq.folded:
            return np.concatenate(
                [seq.ids, np.asarray(seq.out[seq.folded:], np.int32)])
        return seq.ids

    # -- adaptive width ------------------------------------------------------

    def k_eff(self, slot: int) -> int:
        if not self.spec.adaptive:
            return self.spec.k
        return self.spec.k if self.ewma[slot] >= self.spec.min_accept else 0

    def round_width(self, live: List[int]) -> int:
        """Verify width W for this round: 1 + max k_eff over live rows
        (W == 1 means the scheduler falls through to plain decode).  While
        every live row is backed off, full-k probe rounds re-test the draft
        at ``probe_every`` cadence with exponential backoff: each
        consecutive backed-off probe doubles the interval (cap 8x), and
        any round that speculates at all resets the cadence."""
        round_no = self.rounds_total
        self.rounds_total += 1
        if not self.spec.adaptive:
            return 1 + self.spec.k
        W = 1 + max(self.k_eff(i) for i in live)
        if W > 1:
            self.probe_scale = 1
            return W
        if round_no >= self.next_probe:
            self.next_probe = round_no + \
                max(1, self.spec.probe_every) * self.probe_scale
            self.probe_scale = min(self.probe_scale * 2, 8)
            return 1 + self.spec.k
        return 1

    # -- draft KV maintenance + proposal ------------------------------------

    def catch_up(self, live: List[int]):
        """Bring every live row's draft KV to within one token of the
        target (``lag`` <= 1) via the draft's own chunked paged prefill
        over the known-true tokens."""
        s = self.sched
        m = s.m
        for i in live:
            end = int(s.pos[i])
            start = int(self.dpos[i])
            if end - start <= 1:
                continue
            full = self._full(s.active[i])
            trow = s._dev(s.tbl[i][None])
            while start < end:
                clen = min(end - start, m.prompt_cap)
                width = bucket_len(clen, m.prompt_cap)
                toks = np.zeros((1, width), np.int32)
                toks[0, :clen] = full[start:start + clen]
                fn = self.rt.prefill_fresh if start == 0 \
                    else self.rt.prefill_suffix
                _, self.cache = fn(self.rt.params, s._dev(toks),
                                   s._dev([clen]), s._dev([start]), trow,
                                   self.cache)
                start += clen
                self.catchup_prefills += 1
            self.dpos[i] = end

    def propose(self, live: List[int], W: int) -> np.ndarray:
        """One draft dispatch: W autoregressive draft steps for all slots,
        returning each row's W-1 proposals for target positions
        pos+1..pos+W-1.  Requires ``catch_up`` first (lag <= 1)."""
        s = self.sched
        buf = np.zeros((s.slots, 2), np.int32)
        lag = np.zeros((s.slots,), np.int32)
        for i in live:
            d = int(self.dpos[i])
            lag[i] = int(s.pos[i]) - d
            full = self._full(s.active[i])
            buf[i, 0] = full[d]
            buf[i, 1] = full[d + 1] if d + 1 < len(full) else full[d]
        self.cache["pos"] = s._dev(self.dpos)
        self.cache["tbl"] = s._dev(s.tbl)
        props, self.cache = self.rt.draft_propose(
            self.rt.params, s._dev(buf), s._dev(lag), self.cache, steps=W)
        self.proposals += 1
        return props.cpu().numpy()

    def commit(self, slot: int, W: int):
        """After a verify round: the draft wrote W entries from its old
        dpos; the correct prefix is bounded by the target's new pos."""
        self.dpos[slot] = min(self.dpos[slot] + W, self.sched.pos[slot])


class DecodeScheduler:
    """Slot-based continuous-batching scheduler for one paged member.

    ``member`` supplies the model and the serving steps; the scheduler
    owns the persistent decode cache, the slot bookkeeping, the admission
    queue, and the prefill worker.  Not thread-safe by itself —
    :class:`LocalFleet` serializes access.
    """

    def __init__(self, member, *, gen_tokens: int, init_cache_fn,
                 prefill_chunk: Optional[int] = None,
                 prefill_budget: Optional[int] = 1,
                 prefill_lookahead: int = 0,
                 spec: Optional[SpecRuntime] = None):
        self.m = member
        self.gen_tokens = gen_tokens
        self.slots = member.batch
        self.max_seq = member.max_seq
        self.cache = init_cache_fn(self.slots)
        self.device = self.cache["pos"].device
        self.pool = BlockPool(member.num_blocks, member.block_tokens)
        self.max_blocks = member.max_seq // member.block_tokens
        self.tbl = np.zeros((self.slots, self.max_blocks), np.int32)
        self.row_blocks: List[Optional[List[int]]] = [None] * self.slots
        self.pos = np.zeros((self.slots,), np.int64)
        self.last_tok = np.zeros((self.slots,), np.int32)
        self.active: List[Optional[SequenceState]] = [None] * self.slots
        self.queue: Deque[SequenceState] = deque()
        self.prefill = PrefillWorker(self, chunk=prefill_chunk,
                                     lookahead=prefill_lookahead)
        self.prefill_budget = prefill_budget
        self._rid = 0
        # bounded results side-table for result()-style consumers; the
        # primary delivery path is step()'s return value
        self._finished: "OrderedDict[int, SequenceState]" = OrderedDict()
        self._finished_cap = max(64, 4 * self.slots)
        # stats
        self.admitted = 0
        self.decode_steps = 0
        self.slot_steps = 0              # active slots summed over steps
        self.masked_slot_steps = 0       # freed lanes masked out of decode
        self.prefill_tokens = 0          # prompt tokens actually prefilled
        self.cached_tokens = 0           # prompt tokens served from cache
        self.preempted = 0               # rows parked by priority preemption
        self.ttft_ewma = 0.0             # EWMA TTFT ms (overload detector)
        self.ttft_samples = 0            # EWMA sample count (0 == no data)
        # speculative decoding
        self.drafter: Optional[DraftWorker] = None
        self.spec_enabled = True
        if spec is not None:
            self.drafter = DraftWorker(self, spec)
        self.spec_rounds = 0             # wide verify dispatches
        self.spec_offered = 0            # draft tokens offered to verify
        self.spec_accepted = 0           # draft tokens accepted
        self.spec_emitted = 0            # tokens emitted by spec rounds
        self.spec_acceptance_ewma = 0.0  # mean acceptance, EWMA over rounds

    def _dev(self, a) -> torch.Tensor:
        """Host int32 data -> device int32 tensor."""
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    # -- public API ---------------------------------------------------------

    def submit(self, ids: np.ndarray, *, max_new: Optional[int] = None,
               priority: int = 0, slo: str = "") -> int:
        """Queue one tokenized prompt; returns a request id whose result
        is delivered by a later ``step()``.  ``priority`` orders admission
        (higher first, FIFO within a class) and arms preemption."""
        self._rid += 1
        seq = SequenceState(rid=self._rid, ids=np.asarray(ids, np.int32),
                            max_new=max_new or self.gen_tokens,
                            t_submit=time.perf_counter(),
                            priority=priority, slo=slo)
        self._enqueue(seq)
        return self._rid

    def _enqueue(self, seq: SequenceState, *, requeue: bool = False):
        """Priority-ordered insert: arrivals behind every queued request
        of the same or higher priority, park-requeues AHEAD of
        same-priority waiters."""
        q = self.queue
        p = seq.priority
        i = len(q)
        if requeue:
            while i > 0 and q[i - 1].priority <= p:
                i -= 1
        else:
            while i > 0 and q[i - 1].priority < p:
                i -= 1
        if i == len(q):
            q.append(seq)
        else:
            q.insert(i, seq)

    @property
    def pending(self) -> int:
        return len(self.queue) + self.prefill.backlog + \
            sum(s is not None for s in self.active)

    @property
    def queue_depth(self) -> int:
        """Requests not yet decoding (queued, prefilling, or awaiting a
        slot) — the overload detector's queue-pressure input."""
        return len(self.queue) + self.prefill.backlog

    @property
    def ttft_probe_ms(self) -> float:
        """TTFT as the overload detector should see it: the served EWMA,
        floored by the age of the oldest request still WAITING for its
        first token — a prefill-induced stall (or a parked resume) is
        visible the moment it happens instead of only after the stalled
        request finally finishes."""
        waiting = self.prefill.oldest_wait_s(time.perf_counter()) * 1e3
        return max(self.ttft_ewma, waiting)

    def _note_ttft(self, ms: float):
        # counter, not an ``== 0.0`` sentinel: a genuinely-zero sample
        # must not reset the average
        self.ttft_ewma = ms if self.ttft_samples == 0 else \
            0.8 * self.ttft_ewma + 0.2 * ms
        self.ttft_samples += 1

    def step(self) -> List[SequenceState]:
        """Advance the lane: bind ready prefills into free slots, run the
        prefill worker within its budget, then ONE batched decode step
        over the in-flight batch.  Returns sequences finished this step."""
        done: List[SequenceState] = []
        self._admit(done)
        live = [i for i, s in enumerate(self.active) if s is not None]
        if live:
            self._decode(live, done)
        for seq in done:
            self._finished[seq.rid] = seq
            while len(self._finished) > self._finished_cap:
                self._finished.popitem(last=False)
            METRICS.observe("fleet_ttft_ms", seq.ttft_ms, arch=self.m.arch)
        return done

    def drain(self) -> List[SequenceState]:
        """Step until every submitted request has finished."""
        out: List[SequenceState] = []
        while self.pending:
            out.extend(self.step())
        return out

    def result(self, rid: int) -> Optional[SequenceState]:
        return self._finished.pop(rid, None)

    # -- internals ----------------------------------------------------------

    def _admit(self, done: List[SequenceState]):
        """Prefill-worker budget + ready-row slot binding: while decode
        rows are live at most ``prefill_budget`` prefill calls run per
        step; with the engine idle the budget is unbounded."""
        w = self.prefill
        self._bind_ready(done)
        live = any(s is not None for s in self.active)
        budget = self.prefill_budget if live else None
        if budget is None:
            budget = float("inf")
        while budget > 0 and w.step():
            budget -= 1
            self._bind_ready(done)

    def _bind_ready(self, done: List[SequenceState]):
        """Hand completed prefills to the decode worker: assign a slot,
        point it at the prefilled blocks, seed pos/last_tok.  Preemption
        fires here when a ready row outranks the lowest-priority running
        row."""
        m = self.m
        w = self.prefill
        while w.ready:
            if None not in self.active:
                if not self._try_preempt_for(w.ready[0].seq):
                    break
            slot = self.active.index(None)
            job = w.ready.popleft()
            seq = job.seq
            self.row_blocks[slot] = job.row
            self.tbl[slot] = job.trow
            seq.slot = slot
            self.pos[slot] = job.plen
            self.last_tok[slot] = job.first
            self.active[slot] = seq
            if self.drafter is not None:
                self.drafter.reset_slot(slot)
            self.admitted += 1
            if seq.parks == 0:       # a resume is not a new prompt
                m.prompts_in += 1
            m.tokens_out += 1
            if len(seq.out) >= seq.max_new:
                self._finish(seq, done)

    def _preempt_candidate(self, seq: SequenceState) \
            -> Optional[SequenceState]:
        """Lowest-priority in-flight row STRICTLY below ``seq`` (newest
        submission breaking ties), or None."""
        live = [s for s in self.active if s is not None]
        if not live:
            return None
        victim = min(live, key=lambda s: (s.priority, -s.t_submit))
        return victim if victim.priority < seq.priority else None

    def _try_preempt_for(self, seq: SequenceState) -> bool:
        victim = self._preempt_candidate(seq)
        if victim is None:
            return False
        self._park(victim)
        return True

    def _park(self, seq: SequenceState):
        """Preempt an in-flight row for a later token-exact resume through
        the normal admission path.  The last sampled token's KV was never
        written, so it is POPPED and re-derived by the resume prefill;
        every other generated token folds into ``ids`` and the row's
        blocks are released WITH their chain hashes (matchable at
        resume)."""
        slot = seq.slot
        if len(seq.out) > seq.folded:
            seq.out.pop()            # KV never written: re-derive at resume
        if len(seq.out) > seq.folded:
            seq.ids = np.concatenate(
                [seq.ids, np.asarray(seq.out[seq.folded:], np.int32)])
        seq.folded = len(seq.out)
        if self.row_blocks[slot] is not None:
            self.pool.release(self.row_blocks[slot],
                              chain_hashes(seq.ids.tolist(),
                                           self.m.block_tokens))
            self.row_blocks[slot] = None
            self.tbl[slot] = 0
        self.active[slot] = None
        self.pos[slot] = 0
        self.last_tok[slot] = 0
        if self.drafter is not None:
            self.drafter.reset_slot(slot)
        seq.slot = -1
        seq.parks += 1
        self.preempted += 1
        METRICS.inc("preemptions_total", arch=self.m.arch,
                    slo=seq.slo or "none")
        self._enqueue(seq, requeue=True)

    def _decode(self, live: List[int], done: List[SequenceState]):
        if self.drafter is not None and self.spec_enabled:
            W = self.drafter.round_width(live)
            if W > 1:
                return self._decode_spec(live, done, W)
        m = self.m
        dead = [i for i in range(self.slots) if self.active[i] is None]
        # freed slots are masked out of the step: pos 0 + an all-trash
        # table row, so their garbage KV writes land in the trash block
        assert not set(dead) & set(live)
        self.cache["pos"] = self._dev(self.pos)
        self.cache["tbl"] = self._dev(self.tbl)
        toks = self._dev(self.last_tok[:, None])
        nxt, self.cache = m.decode_rows(m.params, toks, self.cache)
        nxt = nxt.cpu().numpy()
        self.decode_steps += 1
        self.slot_steps += len(live)
        self.masked_slot_steps += len(dead)
        self.pos[live] += 1
        for i in live:
            seq = self.active[i]
            assert seq is not None and len(seq.out) < seq.max_new, \
                f"slot {i}: token sampled for a freed/finished sequence"
            tok = int(nxt[i])
            seq.out.append(tok)
            self.last_tok[i] = tok
            m.tokens_out += 1
            if len(seq.out) >= seq.max_new or self.pos[i] >= self.max_seq - 1:
                self._finish(seq, done)
        for i in dead:
            # no token may be sampled for a freed slot
            assert self.active[i] is None
            self.last_tok[i] = 0

    def _decode_spec(self, live: List[int], done: List[SequenceState],
                     W: int):
        """One speculative round: the draft proposes W-1 tokens per row,
        the target verifies all W positions in ONE wide forward, and greedy
        acceptance emits the longest agreeing prefix plus the target's own
        next token — the same tokens ``_decode`` would emit, since verify
        position t reproduces the decode step at depth pos+t.

        Rollback is free: the verify wrote KV for all W positions through
        the row's existing block table, but entries past the accepted
        prefix sit BEYOND the row's new ``pos`` — outside every future
        attention frontier until overwritten — so no block is allocated,
        copied, or released for a rejection."""
        m = self.m
        dw = self.drafter
        dead = [i for i in range(self.slots) if self.active[i] is None]
        assert not set(dead) & set(live)
        dw.catch_up(live)
        props = dw.propose(live, W)          # (slots, W-1) draft tokens
        toks = np.zeros((self.slots, W), np.int32)
        for i in live:
            toks[i, 0] = self.last_tok[i]    # pending token enters first
            toks[i, 1:] = props[i]
        self.cache["pos"] = self._dev(self.pos)
        self.cache["tbl"] = self._dev(self.tbl)
        ver, self.cache = dw.rt.verify(m.params, self._dev(toks), self.cache)
        ver = ver.cpu().numpy()              # (slots, W) greedy per position
        self.decode_steps += 1
        self.slot_steps += len(live)
        self.masked_slot_steps += len(dead)
        accs = []
        for i in live:
            seq = self.active[i]
            assert seq is not None and len(seq.out) < seq.max_new, \
                f"slot {i}: token sampled for a freed/finished sequence"
            # proposals past the row's remaining token budget can never be
            # emitted: they stay out of the acceptance accounting
            rem = min(seq.max_new - len(seq.out),
                      self.max_seq - 1 - int(self.pos[i]))
            useful = min(W - 1, max(0, rem - 1))
            # greedy acceptance: proposal d_{t+1} == target sample g_t
            a = 0
            while a < useful and props[i, a] == ver[i, a]:
                a += 1
            for t in range(a + 1):           # emit g_0..g_a, budget-capped
                tok = int(ver[i, t])
                seq.out.append(tok)
                self.last_tok[i] = tok
                m.tokens_out += 1
                self.pos[i] += 1
                self.spec_emitted += 1
                if len(seq.out) >= seq.max_new or \
                        self.pos[i] >= self.max_seq - 1:
                    break
            if useful:
                acc = a / useful
                accs.append(acc)
                al = dw.spec.alpha
                dw.ewma[i] = (1.0 - al) * dw.ewma[i] + al * acc
            dw.commit(i, W)
            self.spec_offered += useful
            self.spec_accepted += a
            if len(seq.out) >= seq.max_new or self.pos[i] >= self.max_seq - 1:
                self._finish(seq, done)
        self.spec_rounds += 1
        if accs:
            mean_acc = sum(accs) / len(accs)
            self.spec_acceptance_ewma = mean_acc if self.spec_rounds == 1 \
                else 0.8 * self.spec_acceptance_ewma + 0.2 * mean_acc
            METRICS.observe("spec_accept_rate", mean_acc, arch=m.arch)
        for i in dead:
            # no token may be sampled for a freed slot (its verify lanes
            # computed garbage that is never read)
            assert self.active[i] is None
            self.last_tok[i] = 0

    @property
    def spec_tokens_per_round(self) -> float:
        """Mean tokens emitted per speculative verify dispatch (1.0 == no
        better than plain decode)."""
        return self.spec_emitted / max(1, self.spec_rounds)

    def _finish(self, seq: SequenceState, done: List[SequenceState]):
        seq.t_done = time.perf_counter()
        if seq.t_first == 0.0:
            seq.t_first = seq.t_done
        if seq.slot >= 0 and self.row_blocks[seq.slot] is not None:
            # register the row's full blocks (prompt AND decoded tokens),
            # then drop our references; out tokens up to ``folded`` already
            # live inside ids, and the last sampled token's KV was never
            # written
            written = len(seq.ids) + max(0, len(seq.out) - seq.folded - 1)
            all_ids = np.concatenate(
                [seq.ids,
                 np.asarray(seq.out[seq.folded:-1], np.int32)])[:written]
            self.pool.release(self.row_blocks[seq.slot],
                              chain_hashes(all_ids.tolist(),
                                           self.m.block_tokens))
            self.row_blocks[seq.slot] = None
            self.tbl[seq.slot] = 0      # point the freed lane at trash
        self.active[seq.slot] = None
        self.pos[seq.slot] = 0
        self.last_tok[seq.slot] = 0
        done.append(seq)

    @property
    def occupancy(self) -> float:
        """Mean active slots per decode step (batch utilisation)."""
        return self.slot_steps / max(1, self.decode_steps)
