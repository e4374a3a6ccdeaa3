"""LocalFleet of the port: in-process Mixture-of-Modality backends (text,
image, audio) for router serving.

The port of ``repro.serving.fleet``.  The fleet is a set of **backend
lanes** (:class:`BackendLane`), one per member arch:

* :class:`ARLane` — the continuous-batching autoregressive text lane over
  a :class:`DecodeScheduler`, paged (attention / MLA stacks) or
  contiguous (SSM members, cross-attention members, ``paged=False``);
* :class:`AudioLane` — transcription over an encoder/decoder config
  (``whisper-tiny``): the request payload is the *audio* (stub frontend —
  deterministic pseudo frame embeddings), fed as per-request
  cross-attention context to the same slot scheduler; output is a
  transcript payload;
* :class:`DiffusionLane` — a non-autoregressive fixed-step iterative
  denoiser stub (``sd-tiny``) with image-out payloads: slots hold latents
  at different denoise depths and one ``step()`` advances every active
  latent by one iteration, in torch ops on the fleet's device.

``LocalFleet`` drains its lanes for ``generate`` and for the router
transport ``call_fn`` / ``batch_call``, interleaving steps across every
involved lane.  Content is synthetic (hash tokenizer, random weights);
the serving path (slot admission, paged KV with prefix sharing and COW or
contiguous slot rows, per-row positions, per-request latency) is real and
runs on the card through the port's CUDA kernels when
``decode_impl="flash_paged"`` (paged members) and ``attn_impl="pallas"``
are selected.

MoE members are dropless: their capacity factor is raised to
``n_experts / top_k``.  ``speculative=SpecConfig(...)`` puts a draft model
in front of every lane (draft proposal, one wide verify per round, greedy
acceptance, adaptive k) on the paged lanes.

Sharding: ``model_axis > 1`` serves every member over the
``(data = world // model_axis, model_axis)`` mesh of the ranks that
``launch.mesh.host_ranks`` brought up (or ``torchrun``), from rank 0,
which owns the fleet — schedulers, block pools, router, front-end.  Each
rank holds its blocks of every parameter and cache tensor
(:class:`MemberShard`); before each prefill, decode or block copy, rank 0
sends the step and its small inputs (tokens, positions, block tables,
lengths) to the other ranks (``launch.mesh.Controller``), and every rank
runs its share of the same forward, collectives included.  The batch is
whole on every rank.  A request's cross-attention context travels the
same way: the audio lane draws a request's frames on rank 0 and the
controller broadcasts them with the prefill (every rank encodes the same
bits); a vision member's text prompt, which brings no context, attends
to zero patches that the row prefill makes on each rank
(``serve_lib.make_prefill_row_fn``).

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

from repro_torch.bridge import shard_params
from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.launch import mesh as LM
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
    if decode_impl is not None and decode_impl not in MD.DECODE_IMPLS:
        raise ValueError(
            f"unknown decode_impl {decode_impl!r}; valid: "
            + ", ".join(MD.DECODE_IMPLS))


def _spec_draft_archs() -> List[str]:
    """Archs usable as a speculative draft: AR text models the paged cache
    supports (pure attention/MLA stacks; no audio member)."""
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
    prefill_row: object          # (params, toks(1,L), lens, cache1[, cross])
    decode_rows: object          # (params, toks(B,1), cache) per-row decode
    merge_row: object            # slot admission into the contiguous cache
    batch: int                   # decode slots
    max_seq: int
    prompt_cap: int              # longest admissible prompt
    exact_prefill: bool          # SSM state: no pad-bucketing allowed
    # paged KV pool (prefix caching) — False/None for contiguous members
    paged: bool = False
    prefill_paged_fresh: object = None   # no-prefix paged admission
    prefill_paged_suffix: object = None  # suffix-only paged admission
    copy_block: object = None            # COW block copy
    block_tokens: int = 16
    num_blocks: int = 0                  # physical blocks incl. trash block
    spec: object = None                  # SpecRuntime (speculative decoding)
    shard: object = None                 # MemberShard mirrored on the ranks


def _draw_params(cfg, seed: int, reduced: bool, device, mesh=None):
    """A member's weights from one stream seeded ``seed``: reduced members
    draw on the CPU (the same weights on the card and on the CPU),
    full-width ones on ``device``.  With ``mesh`` each leaf is drawn whole
    and the rank keeps its block, so the sharded and unsharded members
    hold the same weights."""
    gen_dev = "cpu" if reduced else device
    return MD.init_params(cfg, torch.Generator(device=gen_dev).manual_seed(
        seed), device, mesh=mesh)


class MemberShard:
    """One rank's share of a sharded member: its parameter blocks and its
    serving steps over the mesh (``serve_lib``'s builders with ``mesh``).
    Rank 0 makes one through the controller, which mirrors it on every
    rank; the fleet's step callables then run on all of them.  The steps
    take no ``params`` (each rank's are its own).  ``draft_cfg``: the
    blocks of the speculative lane's draft too (drawn from the same seed),
    with the speculative steps over the mesh (``serve_lib.build_spec_steps``)
    and the draft's paged cache."""

    def __init__(self, cfg, *, model_axis: int, device: str, reduced: bool,
                 seed: int, moe_impl: str, paged: bool, max_seq: int,
                 num_blocks: int, block_tokens: int, draft_cfg=None):
        self.cfg = cfg
        self.moe_impl = moe_impl
        self.device = resolve_device(device)
        self.mesh = LM.make_host_mesh(model_axis)
        self.paged, self.max_seq = paged, max_seq
        self.num_blocks, self.block_tokens = num_blocks, block_tokens
        self.params = _draw_params(cfg, seed, reduced, self.device, self.mesh)
        self._prefill_row, self._decode, _ = serve_lib.build_row_serve_steps(
            cfg, moe_impl=moe_impl, mesh=self.mesh)
        if paged:
            (self._prefill_fresh, self._prefill_suffix, self._decode,
             self._copy_block) = serve_lib.build_paged_serve_steps(
                cfg, moe_impl=moe_impl, mesh=self.mesh)
        self.draft_cfg = draft_cfg
        if draft_cfg is not None:
            self.draft_params = _draw_params(draft_cfg, seed, reduced,
                                             self.device, self.mesh)
            self._spec = serve_lib.build_spec_steps(
                cfg, draft_cfg, moe_impl=moe_impl, mesh=self.mesh)

    def init_cache(self, slots: int) -> dict:
        if self.paged:
            return MD.init_paged_cache(self.cfg, slots, self.max_seq,
                                       self.num_blocks, self.block_tokens,
                                       self.device, mesh=self.mesh)
        return MD.init_cache(self.cfg, slots, self.max_seq, self.device,
                             mesh=self.mesh)

    def init_draft_cache(self, slots: int) -> dict:
        return MD.init_paged_cache(self.draft_cfg, slots, self.max_seq,
                                   self.num_blocks, self.block_tokens,
                                   self.device, mesh=self.mesh)

    def prefill_row(self, *a):
        return self._prefill_row(self.params, *a)

    def decode(self, *a):
        return self._decode(self.params, *a)

    def prefill_fresh(self, *a):
        return self._prefill_fresh(self.params, *a)

    def prefill_suffix(self, *a):
        return self._prefill_suffix(self.params, *a)

    def copy_block(self, *a):
        return self._copy_block(*a)

    def merge_row(self, *a):
        return serve_lib.merge_row(*a)

    def verify(self, *a):
        return self._spec["verify"](self.params, *a)

    def draft_propose(self, *a, **kw):
        return self._spec["draft_propose"](self.draft_params, *a, **kw)

    def draft_prefill_fresh(self, *a):
        return self._spec["draft_prefill_fresh"](self.draft_params, *a)

    def draft_prefill_suffix(self, *a):
        return self._spec["draft_prefill_suffix"](self.draft_params, *a)

    def apply(self, fn, *args):
        """``fn(self, *args)`` on this rank's share (``fn`` importable by
        name): a measurement or check that needs the member's blocks."""
        return fn(self, *args)

    def load(self, named: Optional[dict], draft: Optional[dict] = None
             ) -> None:
        """Load whole weights (``Model.state_dict()`` keys) of the member
        and, ``draft``, of its draft: the rank keeps its blocks."""
        if named is not None:
            self.params.load_state_dict(shard_params(named, self.cfg,
                                                     self.mesh))
        if draft is not None:
            self.draft_params.load_state_dict(shard_params(
                draft, self.draft_cfg, self.mesh))


def rank_stats(reset: bool = False) -> dict:
    """This rank's kernel launch counts, peak device memory (since the
    process started or last reset it) and host-staged collective time
    (``reset``: zero the counts and times after reading)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_decode import ops as FD
    fns = {"flash_attention": flash_attention,
           "paged_flash_decode": FD.paged_flash_decode,
           "paged_flash_verify": FD.paged_flash_verify,
           "paged_flash_decode_mla": FD.paged_flash_decode_mla,
           "paged_flash_verify_mla": FD.paged_flash_verify_mla}
    out = {"launches": {n: f.launches for n, f in fns.items()},
           "collectives": {"calls": 0, "seconds": 0.0, "bytes": 0},
           "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                    if torch.cuda.is_available() else 0)}
    for m in LM._MESHES.values():
        for k in out["collectives"]:
            out["collectives"][k] += getattr(m.stats, k)
    if reset:
        for f in fns.values():
            f.launches = 0
        for m in LM._MESHES.values():
            m.stats.reset()
    return out


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

    ``modality``    lane type: "text", "image" or "audio".
    ``submit(prompt, max_new=, priority=, slo=) -> rid``   queue one
                    request payload.
    ``step() -> [finished]``              advance the lane's batch one
                                          iteration.
    ``pending``     queued + in-flight count.
    ``result(job) -> dict``               transport payload: ``content``,
                                          ``tokens``, ``ttft_ms``,
                                          ``tpot_ms``, ``service_ms``,
                                          ``lane``, plus modality extras
                                          (``image`` / ``transcript``).
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
        if m.exact_prefill:
            return [4]
        return [b for b in PREFILL_BUCKETS if b <= m.prompt_cap] + \
            [m.prompt_cap]

    def warmup(self):
        """Run every production step once at construction: one throwaway
        request per prompt-length bucket runs the real admit+decode path,
        then cache-hit prompts run the suffix prefill and the COW copy —
        so the first served request pays no kernel build, allocator growth
        or library autotuning inside its ``ttft_ms``.  (Exact-length archs
        run one width; their decode and merge still run.)"""
        m, sched = self.m, self.sched
        t0 = time.perf_counter()
        widths = list(dict.fromkeys(self._warmup_widths()))
        for wi, w in enumerate(widths):
            # distinct fill per width: every bucket exercises the FRESH
            # prefill path (a shared fill would prefix-match)
            self._warmup_submit(w, fill=4 + wi)
        while self.pending:
            self.step()
        if sched.paged:
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
        if sched.paged:
            sched.pool.stats = PoolStats()
        if sched.drafter is not None:
            sched.drafter.reset_stats()
            sched.spec_rounds = sched.spec_offered = 0
            sched.spec_accepted = sched.spec_emitted = 0
            sched.spec_acceptance_ewma = 0.0
        sched._finished.clear()

    def _warmup_submit(self, width: int, fill: int = 4):
        self.sched.submit(np.full((width,), fill, np.int32), max_new=2)


class AudioLane(ARLane):
    """Transcription lane: the request payload is the audio (stub conv
    frontend — deterministic pseudo frame embeddings drawn from a numpy
    generator seeded by the payload), attended by the decoder as
    per-request cross-attention context; the decoder starts from a BOS
    token and emits the transcript."""

    modality = "audio"

    def _frames(self, payload: str) -> torch.Tensor:
        cfg = self.m.cfg
        rng = np.random.default_rng(_seed_of(payload))
        f = rng.standard_normal((1, cfg.cross_ctx_len, cfg.d_model))
        return torch.as_tensor(f, dtype=torch_dtype(cfg.dtype),
                               device=self.fleet.device)

    def submit(self, prompt: str, max_new: Optional[int] = None,
               priority: int = 0, slo: str = "") -> int:
        return self.sched.submit(np.asarray([4], np.int32), max_new=max_new,
                                 cross=self._frames(prompt),
                                 priority=priority, slo=slo)

    def _warmup_widths(self) -> List[int]:
        # audio requests always decode from a 1-token BOS prompt
        return [1]

    def _warmup_submit(self, width: int, fill: int = 4):
        self.sched.submit(np.full((width,), fill, np.int32), max_new=2,
                          cross=self._frames("warmup"))

    def result(self, seq) -> dict:
        out = super().result(seq)
        transcript = " ".join(f"tok{t}" for t in seq.out)
        out["content"] = (f"[{self.m.arch}] transcript "
                          f"{len(seq.out)} tokens: {transcript[:80]}")
        out["transcript"] = transcript
        return out


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

        ``paged="auto"`` pages every member the paged cache supports (pure
        attention / MLA stacks) and keeps SSM and cross-attention members
        on the contiguous cache; ``paged=False`` keeps every member
        contiguous; ``paged=True`` raises for a member that cannot page.
        ``kv_blocks`` overrides the physical pool size
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
        paged lane: ``SpecConfig.draft_arch`` (its registry config, reduced or
        full as the fleet, with no ``arch_overrides``) proposes ``k`` tokens
        per round, the member verifies all k+1 positions in one wide forward
        (``decode_impl="flash_paged"``: the CUDA verify kernels), and greedy
        acceptance keeps the output token-exact vs the non-speculative path
        (``DecodeScheduler._decode_spec``).
        ``moe_impl`` selects the MoE FFN of MoE members: on one device
        "ep", "ep_serve" and "sort" all run the reference's single-device
        sort/gather path, "gshard" the capacity-bucketed dispatch
        (``moe.moe_gshard``).  Weights are drawn from a
        ``torch.Generator`` seeded with ``seed`` — not the reference's
        ``jax.random`` draws.  Reduced members draw on the CPU, so one seed
        gives the same weights on every device; full-width members
        (``reduced=False``) draw on the fleet's device, since a CPU
        generator cannot make tens of billions of parameters in a smoke
        run.  A sharded member draws each leaf whole from the same stream
        and keeps its block, so it holds the unsharded member's weights.

        ``model_axis > 1`` shards every member over the ranks (see the
        module docstring): this process must be rank 0 of
        ``launch.mesh.host_ranks``; raises ``RuntimeError`` ("model axis")
        when fewer ranks are up.  ``decode_impl="shardmap"`` decodes a
        sharded member's contiguous cache by ``smdec`` (unsharded: the
        plain path).  ``speculative`` on a model axis shards the draft
        over the same ranks (the member's ``MemberShard`` holds it), and
        the draft's and the verify's steps run on every rank.  SSM,
        cross-attention and encoder members serve from the contiguous
        cache over the ranks as the others do (a request's context is
        broadcast with its prefill; see the module docstring).  Not
        ported on a model axis: GQA members whose KV heads neither divide
        the axis nor are a divisor of it
        (``models.model.check_shardable``)."""
        _validate_decode_impl(decode_impl)
        _validate_speculative(speculative, paged=paged)
        _validate_arch_overrides(arch_overrides, list(archs))
        self.device = resolve_device(device)
        self.mesh = None
        self.model_axis = model_axis
        if model_axis > 1:
            self.mesh = LM.make_host_mesh(model_axis)
            if LM.controller() is None:
                raise RuntimeError(
                    f"model axis {model_axis}: the fleet serves from rank 0 "
                    f"of launch.mesh.host_ranks (the other ranks run its "
                    f"worker loop)")
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
                           moe_impl=moe_impl, paged=paged,
                           block_tokens=block_tokens,
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
        batch, max_seq, paged = b["batch"], b["max_seq"], b["paged"]
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
        exact = any(s.mixer in MD.SSM_MIXERS
                    for g in cfg.groups for s in g.period)
        can_page = MD.paged_supported(cfg) and max_seq % block_tokens == 0
        if paged is True and not can_page:
            raise ValueError(
                f"{arch}: paged KV unsupported (SSM/cross-attn state or "
                f"max_seq % block_tokens != 0)")
        use_paged = can_page if paged == "auto" else bool(paged)
        pre_row, dec, merge = serve_lib.build_row_serve_steps(
            cfg, moe_impl=b["moe_impl"])
        pf = ps = cpb = None
        nblk = 0
        if use_paged:
            pf, ps, dec, cpb = serve_lib.build_paged_serve_steps(
                cfg, moe_impl=b["moe_impl"])
            bpr = max_seq // block_tokens
            # 1 trash + a full table per slot + retained-prefix headroom
            # (~4 rows) for the cross-request hit rate
            nblk = kv_blocks or (1 + (batch + 4) * bpr)
        spec = b["speculative"] if use_paged and cfg.family != "audio" \
            else None
        draft_cfg = None if spec is None else self._draft_config(spec, cfg)
        shard = None
        if self.mesh is not None:
            MD.check_shardable(cfg, self.mesh)
            if draft_cfg is not None:
                MD.check_shardable(draft_cfg, self.mesh)
            shard = LM.controller().run(
                None, MemberShard, cfg, model_axis=self.model_axis,
                device=str(self.device), reduced=b["reduced"],
                seed=self.seed, moe_impl=b["moe_impl"], paged=use_paged,
                max_seq=max_seq, num_blocks=nblk, block_tokens=block_tokens,
                draft_cfg=draft_cfg, keep=True)
            params = shard.params
            pre_row, dec, merge, pf, ps, cpb = (
                self._remote(shard, n) for n in (
                    "prefill_row", "decode", "merge_row", "prefill_fresh",
                    "prefill_suffix", "copy_block"))
        else:
            params = self._init_params(cfg)
        spec_rt = None if spec is None else self._build_spec_runtime(
            spec, cfg, draft_cfg, nblk, shard)
        member = FleetMember(arch, cfg, params, pre_row, dec, merge, batch,
                             max_seq,
                             prompt_cap=max_seq - self.gen_tokens - 1,
                             exact_prefill=exact,
                             paged=use_paged,
                             prefill_paged_fresh=pf,
                             prefill_paged_suffix=ps,
                             copy_block=cpb,
                             block_tokens=block_tokens,
                             num_blocks=nblk,
                             spec=spec_rt, shard=shard)
        lane_cls = AudioLane if cfg.family == "audio" else ARLane
        return member, lane_cls(self, member)

    @staticmethod
    def _remote(shard: MemberShard, name: str):
        """A step of the member's ranks: rank 0's scheduler calls it with
        its ``params`` first (as an unsharded member's, or the draft's),
        every rank runs ``MemberShard.<name>`` on its own blocks."""
        def step(*args, **kw):
            if name not in ("merge_row", "copy_block"):
                args = args[1:]             # the params: each rank its own
            return LM.controller().run(shard, name, *args, **kw)
        step.__name__ = name
        return step

    def _init_params(self, cfg) -> MD.Model:
        """Weights from the fleet's seed (``_draw_params``)."""
        return _draw_params(cfg, self.seed, self._build["reduced"],
                            self.device)

    def load_params(self, arch: str, named: Optional[dict] = None,
                    draft: Optional[dict] = None) -> None:
        """Load whole weights (``Model.state_dict()`` keys, e.g.
        ``bridge.params_from_jax``) into member ``arch`` and, ``draft``,
        into the draft of its speculative lane: a sharded member sends
        them to every rank, which keeps its blocks."""
        m = self.members[arch]
        if draft is not None and m.spec is None:
            raise ValueError(f"{arch}: no speculative draft to load")
        if m.shard is not None:
            LM.controller().run(m.shard, "load", named, draft, sync=True)
            return
        if named is not None:
            m.params.load_state_dict(named)
        if draft is not None:
            m.spec.params.load_state_dict(draft)

    def rank_stats(self, reset: bool = False) -> List[dict]:
        """``rank_stats`` of every rank of the fleet's mesh (rank order;
        this process alone when unsharded)."""
        if self.mesh is None:
            return [rank_stats(reset)]
        return LM.controller().gather(rank_stats, reset)

    def _draft_config(self, spec: SpecConfig, target_cfg):
        """The draft's config: the registry config of ``spec.draft_arch``
        (reduced or full, as the fleet's), dropless, with no
        ``arch_overrides``, decoding through the plain (``xla``) path —
        its tokens only seed proposals."""
        draft_cfg = (get_reduced(spec.draft_arch) if self._build["reduced"]
                     else get_config(spec.draft_arch))
        draft_cfg = _dropless(draft_cfg.replace(decode_impl="xla"))
        if draft_cfg.vocab_size != target_cfg.vocab_size:
            raise ValueError(
                f"speculative draft_arch {spec.draft_arch!r} vocab "
                f"({draft_cfg.vocab_size}) != target vocab "
                f"({target_cfg.vocab_size})")
        return draft_cfg

    def _build_spec_runtime(self, spec: SpecConfig, target_cfg, draft_cfg,
                            num_blocks: int,
                            shard: Optional[MemberShard] = None
                            ) -> SpecRuntime:
        """Draft model + speculative steps for one lane.

        The draft draws its weights from the fleet's OWN seed on the same
        generator device as every member, so a ``draft_arch`` that names a
        fleet member proposes with identical weights to that member.  Its
        paged cache reuses the TARGET pool's geometry (same slots, table
        and blocks), so the scheduler's one block table indexes both pools
        and speculation adds no BlockPool state.  The target's verify
        follows the target's ``decode_impl``.  A sharded member's
        ``shard`` holds the draft's blocks on every rank: the steps and the
        draft cache are the ranks' (``_remote``), as the member's own."""
        b = self._build
        if shard is not None:
            return SpecRuntime(
                cfg=draft_cfg, params=shard.draft_params,
                verify=self._remote(shard, "verify"),
                draft_propose=self._remote(shard, "draft_propose"),
                prefill_fresh=self._remote(shard, "draft_prefill_fresh"),
                prefill_suffix=self._remote(shard, "draft_prefill_suffix"),
                init_cache_fn=lambda slots: LM.controller().run(
                    shard, "init_draft_cache", slots, keep=True),
                spec=spec)
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
        if m.shard is not None:
            # the ranks make their blocks of the cache; rank 0's carries
            # the handle its steps are sent with
            init_cache = lambda b: LM.controller().run(
                m.shard, "init_cache", m.batch if m.paged else b, keep=True)
        elif m.paged:
            init_cache = lambda b, cfg=m.cfg: MD.init_paged_cache(
                cfg, m.batch, m.max_seq, m.num_blocks, m.block_tokens,
                device=self.device)
        else:
            init_cache = lambda b, cfg=m.cfg: MD.init_cache(
                cfg, b, m.max_seq, device=self.device)
        return DecodeScheduler(m, gen_tokens=self.gen_tokens,
                               init_cache_fn=init_cache,
                               spec=m.spec,
                               **self._sched_opts)

    # -- generation ---------------------------------------------------------

    def generate(self, arch: str, prompts: List[str],
                 max_new: Optional[int] = None, priority: int = 0,
                 slo: str = "") -> List[dict]:
        """Greedy generation (or image / transcript synthesis) via the
        arch's lane.  Any
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
            for extra in ("image", "transcript"):
                if extra in out:
                    message[extra] = out[extra]
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
