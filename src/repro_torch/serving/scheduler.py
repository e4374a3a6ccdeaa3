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

Host state (positions, tables, last tokens) lives in numpy; each step
copies positions (int32) and tables (int32, the kernels' index type) to
the device.  The contiguous cache, speculative decoding and the overload
probes (TTFT EWMA, queue depth) are later slices of the port.
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
                 prefill_lookahead: int = 0):
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
        seq.slot = -1
        seq.parks += 1
        self.preempted += 1
        METRICS.inc("preemptions_total", arch=self.m.arch,
                    slo=seq.slo or "none")
        self._enqueue(seq, requeue=True)

    def _decode(self, live: List[int], done: List[SequenceState]):
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
