"""LocalFleet of the port: in-process text and image backends for router
serving.

The port of ``repro.serving.fleet`` for paged text members and the image
lane.  The fleet is a set of **backend lanes** (:class:`BackendLane`), one
per member arch:

* :class:`ARLane` — the continuous-batching autoregressive text lane over
  a paged :class:`DecodeScheduler`;
* :class:`DiffusionLane` — a non-autoregressive fixed-step iterative
  denoiser stub (``sd-tiny``) with image-out payloads: slots hold latents
  at different denoise depths and one ``step()`` advances every active
  latent by one iteration, in torch ops on the fleet's device.

``LocalFleet`` drains its lanes for ``generate`` and for the router
transport ``call_fn`` / ``batch_call``, interleaving steps across every
involved lane.  Content is synthetic (hash tokenizer, random weights);
the serving path (slot admission, paged KV with prefix sharing and COW,
per-row positions, per-request latency) is real and runs on the card
through the port's CUDA kernels when ``decode_impl="flash_paged"`` and
``attn_impl="pallas"`` are selected.

Serving is single-device (no mesh, no sharding rules) and MoE members are
dropless: their capacity factor is raised to ``n_experts / top_k``.
``speculative=SpecConfig(...)`` puts a draft model in front of every lane
(draft proposal, one wide verify per round, greedy acceptance, adaptive
k).  The audio lane (``whisper-tiny``: the registry does not list it),
contiguous caches and ``model_axis > 1`` are later slices and raise.

Concurrency: the fleet lock covers ONLY submission and bookkeeping.
Draining happens outside it — per-lane step locks serialize the steps
while concurrent callers' requests share the same slot pools, and
whichever thread steps a lane publishes every finished request to a
shared results table for the other callers to collect.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field, fields as dc_fields
from dataclasses import replace as dc_replace
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as MD
from repro_torch.models import moe as M
from repro_torch.serving import serve_lib
from repro_torch.serving.paged import PoolStats
from repro_torch.serving.scheduler import (PREFILL_BUCKETS, DecodeScheduler,
                                           SpecConfig, SpecRuntime)

# non-AR diffusion stub archs servable as image lanes (not ModelConfigs —
# the denoiser is the lane itself)
DIFFUSION_ARCHS: Dict[str, dict] = {
    "sd-tiny": dict(hw=8, steps=8),
}


def _validate_decode_impl(decode_impl: Optional[str]):
    if decode_impl == "shardmap":
        raise NotImplementedError("decode_impl='shardmap' is a multi-device "
                                  "path, not ported yet")
    if decode_impl is not None and decode_impl not in MD.DECODE_IMPLS:
        raise ValueError(
            f"unknown decode_impl {decode_impl!r}; valid: "
            + ", ".join(MD.DECODE_IMPLS))


def _spec_draft_archs() -> List[str]:
    """Archs usable as a speculative draft: AR text models the paged cache
    supports (pure attention/MLA stacks)."""
    return [a for a in list_archs()
            if (cfg := get_reduced(a)).family != "audio"
            and MD.paged_supported(cfg)]


def _validate_speculative(spec: Optional[SpecConfig], *, paged: object):
    if spec is None:
        return
    if not isinstance(spec, SpecConfig):
        raise ValueError(
            f"speculative= expects a SpecConfig, got {type(spec).__name__}")
    if paged is False:
        raise ValueError("speculative decoding requires the paged KV "
                         "cache (paged='auto' or True)")
    valid = _spec_draft_archs()
    if spec.draft_arch not in valid:
        raise ValueError(
            f"unknown/unsupported speculative draft_arch "
            f"{spec.draft_arch!r}; valid: " + ", ".join(sorted(valid)))
    if spec.k < 1:
        raise ValueError(f"speculative k must be >= 1, got {spec.k}")
    if spec.probe_every < 1:
        raise ValueError(
            f"speculative probe_every must be >= 1, got {spec.probe_every}")
    if not (0.0 < spec.alpha <= 1.0):
        raise ValueError(
            f"speculative alpha must be in (0, 1], got {spec.alpha}")
    if not (0.0 <= spec.min_accept <= 1.0):
        raise ValueError(
            f"speculative min_accept must be in [0, 1], "
            f"got {spec.min_accept}")


def _dropless(cfg):
    """Serving MoE is dropless: capacity >= the per-call token count, so
    expert keep/drop never depends on which other tokens share the
    dispatch (a 16-wide suffix prefill must match the same tokens inside a
    wider fresh prefill).  No-op without experts."""
    if not cfg.n_experts:
        return cfg
    return cfg.replace(moe_capacity_factor=max(
        cfg.moe_capacity_factor, cfg.n_experts / max(1, cfg.moe_top_k)))


def _validate_arch_overrides(overrides, archs: List[str]):
    """``arch_overrides`` maps a fleet arch to ModelConfig field
    overrides applied on top of its registry config — plus the synthetic
    ``depth_mult`` key, which multiplies every layer group's ``repeats``.
    Validated at construction so a typo'd field fails with the arch named,
    not deep inside a lane build."""
    if overrides is None:
        return
    if not isinstance(overrides, dict):
        raise ValueError(
            f"arch_overrides expects a dict of arch -> field overrides, "
            f"got {type(overrides).__name__}")
    for arch, ov in overrides.items():
        if arch not in archs:
            raise ValueError(
                f"arch_overrides names {arch!r} which is not a fleet "
                f"member; fleet archs: " + ", ".join(archs))
        if not isinstance(ov, dict):
            raise ValueError(
                f"arch_overrides[{arch!r}] expects a dict of ModelConfig "
                f"fields, got {type(ov).__name__}")
        known = {f.name for f in dc_fields(get_reduced(arch))}
        for key in ov:
            if key != "depth_mult" and key not in known:
                raise ValueError(
                    f"arch_overrides[{arch!r}]: unknown ModelConfig "
                    f"field {key!r}")
        if "depth_mult" in ov and int(ov["depth_mult"]) < 1:
            raise ValueError(
                f"arch_overrides[{arch!r}]: depth_mult must be >= 1, "
                f"got {ov['depth_mult']}")


def _apply_arch_overrides(cfg, ov: dict):
    ov = dict(ov)
    mult = int(ov.pop("depth_mult", 1) or 1)
    if mult > 1:
        cfg = cfg.replace(groups=tuple(
            dc_replace(g, repeats=g.repeats * mult) for g in cfg.groups))
    if ov:
        cfg = cfg.replace(**ov)
    return cfg


def hash_tokens(text: str, vocab: int, max_len: int) -> np.ndarray:
    ids = []
    for w in text.lower().split():
        h = hashlib.blake2s(w.encode(), digest_size=4).digest()
        ids.append(4 + int.from_bytes(h, "little") % (vocab - 4))
    # over-long prompts keep the TAIL: the newest turns must survive
    return np.asarray(ids[-max_len:] or [4], np.int32)


def _seed_of(text: str) -> int:
    return int.from_bytes(
        hashlib.blake2s(text.encode(), digest_size=4).digest(), "little")


@dataclass
class MemberStats:
    """Serving stats shared by every lane's member record."""
    calls: int = field(default=0, kw_only=True)       # drains served
    tokens_out: int = field(default=0, kw_only=True)  # work units produced
    prompts_in: int = field(default=0, kw_only=True)  # real requests served
    warmup_ms: float = field(default=0.0, kw_only=True)  # warmup wall

    @property
    def slots_per_call(self) -> float:
        """Mean real prompts per generate()/batch_call drain."""
        return self.prompts_in / max(1, self.calls)


@dataclass
class FleetMember(MemberStats):
    arch: str
    cfg: object
    params: object               # MD.Model on the fleet's device
    decode_rows: object          # (params, toks(B,1), cache) per-row decode
    batch: int                   # decode slots
    max_seq: int
    prompt_cap: int              # longest admissible prompt
    prefill_paged_fresh: object = None   # no-prefix paged admission
    prefill_paged_suffix: object = None  # suffix-only paged admission
    copy_block: object = None            # COW block copy
    block_tokens: int = 16
    num_blocks: int = 0                  # physical blocks incl. trash block
    spec: object = None                  # SpecRuntime (speculative decoding)


@dataclass
class DiffusionMember(MemberStats):
    """Member record for a non-AR diffusion lane (no params/config — the
    denoiser lives on the lane; ``tokens_out`` counts denoise
    slot-iterations)."""
    arch: str
    batch: int


# ---------------------------------------------------------------------------
# backend lanes
# ---------------------------------------------------------------------------

class BackendLane:
    """Protocol for one execution lane of the fleet.

    ``modality``    lane type: "text" or "image" ("audio" is a later
                    slice of the port).
    ``submit(prompt, max_new=, priority=, slo=) -> rid``   queue one
                    request payload.
    ``step() -> [finished]``              advance the lane's batch one
                                          iteration.
    ``pending``     queued + in-flight count.
    ``result(job) -> dict``               transport payload: ``content``,
                                          ``tokens``, ``ttft_ms``,
                                          ``tpot_ms``, ``service_ms``,
                                          ``lane``.
    ``warmup()``    run every production step once; must not pollute
                    serving stats.
    ``occupancy``   mean active slots per step.
    """

    modality = "text"

    def submit(self, prompt: str, max_new: Optional[int] = None,
               priority: int = 0, slo: str = "") -> int:
        raise NotImplementedError

    def step(self) -> List[object]:
        raise NotImplementedError

    @property
    def pending(self) -> int:
        raise NotImplementedError

    def result(self, job) -> dict:
        raise NotImplementedError

    def warmup(self):
        raise NotImplementedError


class ARLane(BackendLane):
    """Continuous-batching autoregressive lane over one fleet member."""

    modality = "text"

    def __init__(self, fleet: "LocalFleet", member: FleetMember):
        self.fleet = fleet
        self.m = member
        self.sched = fleet._make_scheduler(member)

    def submit(self, prompt: str, max_new: Optional[int] = None,
               priority: int = 0, slo: str = "") -> int:
        m = self.m
        return self.sched.submit(
            hash_tokens(prompt, m.cfg.vocab_size, m.prompt_cap),
            max_new=max_new, priority=priority, slo=slo)

    @property
    def pending(self) -> int:
        return self.sched.pending

    def step(self):
        return self.sched.step()

    def result(self, seq) -> dict:
        m = self.m
        return {
            "content": (f"[{m.arch}] {len(seq.out)} tokens: "
                        + " ".join(str(x) for x in seq.out[:10])),
            "tokens": list(seq.out),
            "ttft_ms": seq.ttft_ms,
            "tpot_ms": seq.tpot_ms,
            "service_ms": (seq.t_done - seq.t_submit) * 1e3,
            "lane": self.modality,
        }

    @property
    def occupancy(self) -> float:
        return self.sched.occupancy

    def _warmup_widths(self) -> List[int]:
        m = self.m
        return [b for b in PREFILL_BUCKETS if b <= m.prompt_cap] + \
            [m.prompt_cap]

    def warmup(self):
        """Run every production step once at construction: one throwaway
        request per prompt-length bucket runs the real admit+decode path,
        then cache-hit prompts run the suffix prefill and the COW copy —
        so the first served request pays no kernel build, allocator growth
        or library autotuning inside its ``ttft_ms``."""
        m, sched = self.m, self.sched
        t0 = time.perf_counter()
        widths = list(dict.fromkeys(self._warmup_widths()))
        for wi, w in enumerate(widths):
            # distinct fill per width: every bucket exercises the FRESH
            # prefill path (a shared fill would prefix-match)
            self._warmup_submit(w, fill=4 + wi)
        while self.pending:
            self.step()
        # a fully-cached prompt runs the suffix prefill AND the COW copy
        self._warmup_submit(widths[0], fill=4)
        # partially-matched prompts run the remaining suffix widths
        blk = m.block_tokens
        prev = widths[0]
        for wi, w in enumerate(widths[1:]):
            tail = min(prev + 1, m.prompt_cap - blk)
            if tail <= 0:
                break
            ids = np.concatenate([np.full((blk,), 4, np.int32),
                                  np.full((tail,), 90 + wi, np.int32)])
            self.sched.submit(ids, max_new=2)
            prev = w
        while self.pending:
            self.step()
        if sched.drafter is not None:
            # the drains above ran the wide verify, the draft proposal loop
            # and the FRESH draft catch-up prefills; a lane that backs off
            # accumulates draft lag and its probe rounds catch up through
            # SUFFIX prefills at any width bucket — run that ladder now
            # against the trash block, then the plain decode step a
            # backed-off lane falls back to
            dw = sched.drafter
            trow = sched._dev(np.zeros((1, sched.max_blocks), np.int32))
            for fn, start in ((dw.rt.prefill_fresh, 0),
                              (dw.rt.prefill_suffix, m.block_tokens)):
                for w in widths:
                    _, dw.cache = fn(
                        dw.rt.params, sched._dev(np.zeros((1, w), np.int32)),
                        sched._dev([min(2, w)]), sched._dev([start]), trow,
                        dw.cache)
            sched.spec_enabled = False
            self._warmup_submit(4, fill=7)
            while self.pending:
                self.step()
            sched.spec_enabled = True
        if sched.device.type == "cuda":
            torch.cuda.synchronize(sched.device)
        m.warmup_ms = (time.perf_counter() - t0) * 1e3
        # warmup traffic must not pollute serving stats
        m.tokens_out = m.prompts_in = 0
        sched.admitted = sched.decode_steps = sched.slot_steps = 0
        sched.masked_slot_steps = 0
        sched.prefill_tokens = sched.cached_tokens = 0
        sched.preempted = 0
        sched.ttft_ewma = 0.0
        sched.ttft_samples = 0
        sched.prefill.prefills = 0
        sched.pool.stats = PoolStats()
        if sched.drafter is not None:
            sched.drafter.reset_stats()
            sched.spec_rounds = sched.spec_offered = 0
            sched.spec_accepted = sched.spec_emitted = 0
            sched.spec_acceptance_ewma = 0.0
        sched._finished.clear()

    def _warmup_submit(self, width: int, fill: int = 4):
        self.sched.submit(np.full((width,), fill, np.int32), max_new=2)


@dataclass
class DiffusionJob:
    """One queued / in-flight / finished image request."""
    rid: int
    prompt: str
    t_submit: float
    slot: int = -1
    steps_done: int = 0
    t_first: float = 0.0         # first denoise iteration wall clock
    t_done: float = 0.0
    image: Optional[np.ndarray] = None

    @property
    def ttft_ms(self) -> float:
        return (self.t_first - self.t_submit) * 1e3

    @property
    def tpot_ms(self) -> float:
        if self.steps_done <= 1:
            return 0.0
        return (self.t_done - self.t_first) * 1e3 / (self.steps_done - 1)


class DiffusionLane(BackendLane):
    """Fixed-step iterative denoiser stub (non-autoregressive lane).

    Own batch semantics: a fixed pool of latent slots where each slot sits
    at its OWN denoise depth (``t_idx`` per slot); every ``step()`` admits
    queued prompts into free slots (prompt-seeded noise latent, drawn on
    the host and moved to ``device``) and runs ONE denoise iteration over
    all slots in torch ops on ``device`` ("cuda" by default).  A latent
    that reaches ``steps`` iterations is quantized to a uint8 image
    payload and its slot freed — the image analogue of continuous-batching
    decode."""

    modality = "image"

    def __init__(self, member: DiffusionMember, *, hw: int = 8,
                 steps: int = 8, device: DeviceLike = "cuda"):
        self.m = member
        self.hw = hw
        self.steps = steps
        self.slots = member.batch
        self.device = resolve_device(device)
        self.latents = torch.zeros((self.slots, hw, hw), dtype=torch.float32,
                                   device=self.device)
        self.t_idx = np.zeros((self.slots,), np.int32)
        self.active: List[Optional[DiffusionJob]] = [None] * self.slots
        self.queue: Deque[DiffusionJob] = deque()
        self._rid = 0
        self.decode_steps = 0
        self.slot_steps = 0

    def _denoise(self, lat: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        # per-slot sigma schedule: sigma_t = 1 - t/N; the "noise
        # prediction" is the latent's high-frequency residual, so the
        # fixed-point is a smoothed (structured) image
        sig = (1.0 - t.to(torch.float32) / float(self.steps))[:, None, None]
        blur = (torch.roll(lat, 1, 1) + torch.roll(lat, -1, 1) +
                torch.roll(lat, 1, 2) + torch.roll(lat, -1, 2)) / 4.0
        eps_hat = lat - blur
        return lat - sig * eps_hat

    # -- protocol -----------------------------------------------------------

    def submit(self, prompt: str, max_new: Optional[int] = None,
               priority: int = 0, slo: str = "") -> int:
        # the denoiser's fixed-step FIFO has no priority queue; QoS
        # ordering applies to AR lanes
        self._rid += 1
        self.queue.append(DiffusionJob(self._rid, prompt,
                                       time.perf_counter()))
        return self._rid

    @property
    def pending(self) -> int:
        return len(self.queue) + sum(j is not None for j in self.active)

    def _init_latent(self, prompt: str) -> np.ndarray:
        rng = np.random.default_rng(_seed_of(prompt))
        return rng.standard_normal((self.hw, self.hw)).astype(np.float32)

    def step(self) -> List[DiffusionJob]:
        done: List[DiffusionJob] = []
        while self.queue and None in self.active:
            slot = self.active.index(None)
            job = self.queue.popleft()
            job.slot = slot
            self.latents[slot] = torch.from_numpy(
                self._init_latent(job.prompt)).to(self.device)
            self.t_idx[slot] = 0
            self.active[slot] = job
            self.m.prompts_in += 1
        live = [i for i, j in enumerate(self.active) if j is not None]
        if not live:
            return done
        self.latents = self._denoise(
            self.latents, torch.as_tensor(self.t_idx, device=self.device))
        now = time.perf_counter()
        self.decode_steps += 1
        self.slot_steps += len(live)
        self.m.tokens_out += len(live)
        for i in live:
            job = self.active[i]
            job.steps_done += 1
            self.t_idx[i] += 1
            if job.t_first == 0.0:
                job.t_first = now
            if job.steps_done >= self.steps:
                job.t_done = now
                lat = self.latents[i].cpu().numpy()
                span = float(lat.max() - lat.min()) or 1.0
                job.image = np.clip((lat - lat.min()) / span * 255.0,
                                    0, 255).astype(np.uint8)
                self.active[i] = None
                self.t_idx[i] = 0
                done.append(job)
        return done

    def result(self, job: DiffusionJob) -> dict:
        sig = hashlib.blake2s(job.image.tobytes(),
                              digest_size=4).hexdigest()
        return {
            "content": (f"[{self.m.arch}] image {self.hw}x{self.hw} "
                        f"steps={job.steps_done} sig={sig}"),
            "image": {"hw": self.hw, "sig": sig,
                      "data": job.image.flatten().tolist()},
            "tokens": [],
            "ttft_ms": job.ttft_ms,
            "tpot_ms": job.tpot_ms,
            "service_ms": (job.t_done - job.t_submit) * 1e3,
            "lane": self.modality,
        }

    @property
    def occupancy(self) -> float:
        return self.slot_steps / max(1, self.decode_steps)

    def warmup(self):
        t0 = time.perf_counter()
        self.submit("warmup")
        while self.pending:
            self.step()
        self.m.warmup_ms = (time.perf_counter() - t0) * 1e3
        self.m.tokens_out = self.m.prompts_in = 0
        self.decode_steps = self.slot_steps = 0


# ---------------------------------------------------------------------------
# fleet
# ---------------------------------------------------------------------------

class LocalFleet:
    def __init__(self, archs: List[str], *, reduced: bool = True,
                 batch: int = 4, max_seq: int = 160, gen_tokens: int = 16,
                 moe_impl: str = "ep", seed: int = 0, warmup: bool = True,
                 model_axis: int = 1, paged: object = "auto",
                 block_tokens: int = 16, kv_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefill_budget: Optional[int] = 1,
                 prefill_lookahead: int = 0,
                 decode_impl: Optional[str] = None,
                 speculative: Optional[SpecConfig] = None,
                 arch_overrides: Optional[Dict[str, dict]] = None,
                 device: DeviceLike = "cuda"):
        """The reference's keywords, plus ``device`` ("cuda" by default;
        raises without a GPU unless ``device="cpu"``).

        ``paged`` "auto" and True page every member (the port's lanes are
        all paged); ``kv_blocks`` overrides the physical pool size
        (default: one full table per slot + headroom for retained prefix
        blocks).  ``prefill_chunk`` caps the tokens per admission-prefill
        call, ``prefill_budget`` caps prefill calls interleaved per decode
        step while the batch is live (None = unbounded),
        ``prefill_lookahead`` lets the prefill worker run that many
        admissions ahead of free slots.  ``decode_impl="flash_paged"``
        selects the CUDA block-table decode kernel and
        ``arch_overrides={arch: {"attn_impl": "pallas"}}`` the CUDA
        flash-attention prefill kernel (the reference's option names).
        ``arch_overrides`` maps member archs to ModelConfig field
        overrides (plus ``depth_mult``; ``groups`` cuts a member's depth).
        ``speculative`` enables draft-model speculative decoding on every
        lane: ``SpecConfig.draft_arch`` (its registry config, reduced or
        full as the fleet, with no ``arch_overrides``) proposes ``k`` tokens
        per round, the member verifies all k+1 positions in one wide forward
        (``decode_impl="flash_paged"``: the CUDA verify kernels), and greedy
        acceptance keeps the output token-exact vs the non-speculative path
        (``DecodeScheduler._decode_spec``).
        ``moe_impl`` selects the MoE FFN of MoE members: on one device
        "ep", "ep_serve" and "sort" all run the reference's single-device
        sort/gather path; "gshard" is not ported.  Weights are drawn from a
        ``torch.Generator`` seeded with ``seed`` — not the reference's
        ``jax.random`` draws.  Reduced members draw on the CPU, so one seed
        gives the same weights on every device; full-width members
        (``reduced=False``) draw on the fleet's device, since a CPU
        generator cannot make tens of billions of parameters in a smoke
        run.

        Not ported yet: ``model_axis > 1``, ``paged=False``."""
        if model_axis > 1:
            raise NotImplementedError("model_axis > 1 (multi-device) is not "
                                      "ported yet")
        _validate_decode_impl(decode_impl)
        _validate_speculative(speculative, paged=paged)
        if paged is False:
            raise NotImplementedError("the contiguous cache is not ported "
                                      "yet: use paged='auto' or True")
        _validate_arch_overrides(arch_overrides, list(archs))
        self.device = resolve_device(device)
        self.gen_tokens = gen_tokens
        self.seed = seed
        self.members: Dict[str, FleetMember] = {}
        self.lanes: Dict[str, BackendLane] = {}
        self.schedulers: Dict[str, DecodeScheduler] = {}
        # the fleet lock covers submission/bookkeeping ONLY; draining runs
        # outside it (see _drain) so concurrent callers batch together
        self._lock = threading.RLock()
        self._step_locks: Dict[str, threading.Lock] = {}
        self._done: "OrderedDict[Tuple[str, int], object]" = OrderedDict()
        self._done_cv = threading.Condition()
        self._done_cap = 4096
        self._waiting: set = set()       # keys some drain is waiting on
        self._build = dict(reduced=reduced, batch=batch, max_seq=max_seq,
                           moe_impl=moe_impl, block_tokens=block_tokens,
                           kv_blocks=kv_blocks, decode_impl=decode_impl,
                           speculative=speculative,
                           arch_overrides=arch_overrides or {})
        self._sched_opts = dict(prefill_chunk=prefill_chunk,
                                prefill_budget=prefill_budget,
                                prefill_lookahead=prefill_lookahead)
        self.archs = list(archs)
        for arch in archs:
            self.add_member(arch, warmup=warmup)

    def _build_lane(self, arch: str) -> Tuple[object, BackendLane]:
        """Construct one member + lane (params init, serving steps, paged
        pool sizing).  Pure build — no registration, no warmup."""
        b = self._build
        batch, max_seq = b["batch"], b["max_seq"]
        block_tokens, kv_blocks = b["block_tokens"], b["kv_blocks"]
        if arch in DIFFUSION_ARCHS:
            member: object = DiffusionMember(arch, batch=batch)
            lane: BackendLane = DiffusionLane(member, device=self.device,
                                              **DIFFUSION_ARCHS[arch])
            return member, lane
        cfg = get_reduced(arch) if b["reduced"] else get_config(arch)
        if b["arch_overrides"].get(arch):
            cfg = _apply_arch_overrides(cfg, b["arch_overrides"][arch])
        if b["decode_impl"] is not None:
            cfg = cfg.replace(decode_impl=b["decode_impl"])
        if cfg.n_experts:
            M.check_impl(b["moe_impl"])
        cfg = _dropless(cfg)
        MD.check_supported(cfg)
        if not MD.paged_supported(cfg) or max_seq % block_tokens:
            raise ValueError(
                f"{arch}: paged KV unsupported (SSM/cross-attn state or "
                f"max_seq % block_tokens != 0)")
        bpr = max_seq // block_tokens
        # 1 trash + a full table per slot + retained-prefix headroom
        # (~4 rows) for the cross-request hit rate
        nblk = kv_blocks or (1 + (batch + 4) * bpr)
        spec_rt = None
        if b["speculative"] is not None:
            spec_rt = self._build_spec_runtime(b["speculative"], cfg, nblk)
        params = self._init_params(cfg)
        pf, ps, dec, cpb = serve_lib.build_paged_serve_steps(
            cfg, moe_impl=b["moe_impl"])
        member = FleetMember(arch, cfg, params, dec, batch, max_seq,
                             prompt_cap=max_seq - self.gen_tokens - 1,
                             prefill_paged_fresh=pf,
                             prefill_paged_suffix=ps,
                             copy_block=cpb,
                             block_tokens=block_tokens,
                             num_blocks=nblk,
                             spec=spec_rt)
        return member, ARLane(self, member)

    def _init_params(self, cfg) -> MD.Model:
        """Weights from the fleet's seed.  Reduced members draw on the CPU
        (one seed, the same weights on the card and on the CPU); full-width
        ones on the fleet's device."""
        gen_dev = "cpu" if self._build["reduced"] else self.device
        return MD.init_params(
            cfg, torch.Generator(device=gen_dev).manual_seed(self.seed),
            self.device)

    def _build_spec_runtime(self, spec: SpecConfig, target_cfg,
                            num_blocks: int) -> SpecRuntime:
        """Draft model + speculative steps for one lane.

        The draft draws its weights from the fleet's OWN seed on the same
        generator device as every member, so a ``draft_arch`` that names a
        fleet member proposes with identical weights to that member.  Its
        config is the registry config (reduced or full, as the fleet's),
        dropless, with no ``arch_overrides``.  Its paged cache reuses the
        TARGET pool's geometry (same slots, table and blocks), so the
        scheduler's one block table indexes both pools and speculation adds
        no BlockPool state.  The draft decodes through the plain (``xla``)
        path — its tokens only seed proposals — while the target's verify
        follows the target's ``decode_impl``."""
        b = self._build
        draft_cfg = (get_reduced(spec.draft_arch) if b["reduced"]
                     else get_config(spec.draft_arch))
        draft_cfg = _dropless(draft_cfg.replace(decode_impl="xla"))
        if draft_cfg.vocab_size != target_cfg.vocab_size:
            raise ValueError(
                f"speculative draft_arch {spec.draft_arch!r} vocab "
                f"({draft_cfg.vocab_size}) != target vocab "
                f"({target_cfg.vocab_size})")
        steps = serve_lib.build_spec_steps(target_cfg, draft_cfg,
                                           moe_impl=b["moe_impl"])
        init_cache = lambda slots, c=draft_cfg: MD.init_paged_cache(
            c, slots, b["max_seq"], num_blocks, b["block_tokens"],
            device=self.device)
        return SpecRuntime(cfg=draft_cfg, params=self._init_params(draft_cfg),
                           verify=steps["verify"],
                           draft_propose=steps["draft_propose"],
                           prefill_fresh=steps["draft_prefill_fresh"],
                           prefill_suffix=steps["draft_prefill_suffix"],
                           init_cache_fn=init_cache, spec=spec)

    def add_member(self, arch: str, *, warmup: bool = True) -> bool:
        """Build, warm up, and register one member (the autoscaler's
        scale-up hook).  Construction and warmup run OUTSIDE the fleet
        lock; registration is atomic and race-checked."""
        with self._lock:
            if arch in self.members:
                return False
        member, lane = self._build_lane(arch)
        if warmup:
            lane.warmup()
        with self._lock:
            if arch in self.members:     # raced with a concurrent add
                return False
            self.members[arch] = member
            self.lanes[arch] = lane
            if isinstance(lane, ARLane):
                self.schedulers[arch] = lane.sched
            self._step_locks[arch] = threading.Lock()
        return True

    def remove_member(self, arch: str) -> bool:
        """Deregister an idle member (the autoscaler's scale-down hook).
        Refuses while the lane has queued or in-flight work."""
        with self._lock:
            lane = self.lanes.get(arch)
            if lane is None or lane.pending:
                return False
            del self.members[arch]
            del self.lanes[arch]
            self.schedulers.pop(arch, None)
            self._step_locks.pop(arch, None)
        return True

    def modality_of(self, arch: str) -> str:
        return self.lanes[arch].modality

    def _make_scheduler(self, m: FleetMember) -> DecodeScheduler:
        init_cache = lambda b, cfg=m.cfg: MD.init_paged_cache(
            cfg, m.batch, m.max_seq, m.num_blocks, m.block_tokens,
            device=self.device)
        return DecodeScheduler(m, gen_tokens=self.gen_tokens,
                               init_cache_fn=init_cache, spec=m.spec,
                               **self._sched_opts)

    # -- generation ---------------------------------------------------------

    def generate(self, arch: str, prompts: List[str],
                 max_new: Optional[int] = None, priority: int = 0,
                 slo: str = "") -> List[dict]:
        """Greedy generation (or image synthesis) via the arch's lane.  Any
        number of prompts is accepted: overflow beyond the slot count is queued and admitted
        as slots free."""
        with self._lock:
            self.members[arch].calls += 1
            rids = self._submit(arch, prompts, max_new,
                                priority=priority, slo=slo)
        seqs = self._drain({arch: rids})
        lane = self.lanes[arch]
        return [lane.result(seqs[(arch, r)]) for r in rids]

    def _submit(self, arch: str, prompts: List[str],
                max_new: Optional[int] = None, *, priority: int = 0,
                slo: str = "") -> List[int]:
        lane = self.lanes[arch]
        return [lane.submit(p, max_new=max_new, priority=priority, slo=slo)
                for p in prompts]

    def _drain(self, rids_by_arch: Dict[str, List[int]]
               ) -> Dict[Tuple[str, int], object]:
        """Interleave steps across every involved lane until all request
        ids have finished.  Runs WITHOUT the fleet lock: per-lane step
        locks serialize the steps, and any thread stepping a lane
        publishes every request it finishes to the shared results table,
        waking waiters."""
        all_keys = {(a, r) for a, rids in rids_by_arch.items() for r in rids}
        want = set(all_keys)
        seqs: Dict[Tuple[str, int], object] = {}
        with self._done_cv:
            self._waiting |= want
        try:
            while want:
                stepped = False
                for arch in rids_by_arch:
                    if not any(k[0] == arch for k in want):
                        continue
                    lock = self._step_locks[arch]
                    if not lock.acquire(blocking=False):
                        continue    # another caller is stepping this lane
                    try:
                        lane = self.lanes[arch]
                        if lane.pending:
                            finished = lane.step()
                            stepped = True
                        else:
                            finished = []
                    finally:
                        lock.release()
                    if finished:
                        with self._done_cv:
                            for seq in finished:
                                self._done[(arch, seq.rid)] = seq
                            if len(self._done) > self._done_cap:
                                for k in list(self._done):
                                    if len(self._done) <= self._done_cap:
                                        break
                                    if k not in self._waiting:
                                        del self._done[k]
                            self._done_cv.notify_all()
                with self._done_cv:
                    ready = want & self._done.keys()
                    for k in ready:
                        seqs[k] = self._done.pop(k)
                    want -= ready
                    if want and not stepped and not ready:
                        # another caller is stepping our lanes — wait for
                        # it to publish our results
                        self._done_cv.wait(0.002)
        finally:
            with self._done_cv:
                self._waiting -= all_keys
        return seqs

    # -- router transport -----------------------------------------------------
    def call_fn(self, model_to_arch: Dict[str, str]):
        """Router transport over the lanes: the returned callable serves
        single OpenAI-style requests; its ``batch_call`` attribute submits
        every payload to its arch's lane up front and drains them
        together, so same-arch requests share steps."""

        def _resolve(payload):
            model = payload.get("model") or payload.get("modelId", "")
            arch = model_to_arch.get(model, model)
            if arch not in self.members:
                raise RuntimeError(f"fleet has no backend for {model!r}")
            msgs = payload.get("messages") or \
                payload.get("body", {}).get("messages") or []
            # the WHOLE conversation feeds generation
            prompt = "\n".join(m["content"] for m in msgs)
            prio = int(payload.get("vsr_priority", 0) or 0)
            slo = str(payload.get("vsr_slo", "") or "")
            return model, arch, prompt, prio, slo

        def _wrap(model, prompt, out):
            message = {"content": out["content"]}
            if "image" in out:
                message["image"] = out["image"]
            return {"choices": [{"message": message,
                                 "finish_reason": "stop"}],
                    "model": model,
                    "usage": {"prompt_tokens": len(prompt) // 4,
                              "completion_tokens": len(out["tokens"]),
                              "vsr_service_ms": round(out["service_ms"], 3),
                              "vsr_ttft_ms": round(out["ttft_ms"], 3),
                              "vsr_lane": out.get("lane", "text")}}

        def call(ep, payload, headers):
            model, arch, prompt, prio, slo = _resolve(payload)
            out = self.generate(arch, [prompt], priority=prio, slo=slo)[0]
            return _wrap(model, prompt, out)

        def batch_call(ep, payloads, headers_list):
            resolved = [_resolve(p) for p in payloads]
            with self._lock:
                rids_by_arch: Dict[str, List[int]] = {}
                rid_of: List[int] = []
                for model, arch, prompt, prio, slo in resolved:
                    rid = self._submit(arch, [prompt],
                                       priority=prio, slo=slo)[0]
                    rids_by_arch.setdefault(arch, []).append(rid)
                    rid_of.append(rid)
                for arch in rids_by_arch:
                    self.members[arch].calls += 1
            seqs = self._drain(rids_by_arch)
            return [_wrap(model, prompt,
                          self.lanes[arch].result(seqs[(arch, rid)]))
                    for (model, arch, prompt, _pr, _sl), rid
                    in zip(resolved, rid_of)]

        call.batch_call = batch_call
        return call
