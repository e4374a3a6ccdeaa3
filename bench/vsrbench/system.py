"""The system under test, built for one cell: ``repro_torch``'s
``SemanticRouter`` over a ``LocalFleet`` of the cell's one member, the
full-width encoder as its classifier backend, served through an
``AsyncFrontend``, as ``launch/serve.py``'s async mode builds it
(``decode_impl="flash_paged"``, ``attn_impl="pallas"`` on attention
members, an ``OverloadDetector`` attached, the policy linted strictly).

This is the only module of the harness that imports the program.  It
takes from the program the system and what the system reports (responses,
usage, outcome traces, frontend stats); the weights it loads are the
benchmark's own (``reference.common.draw_block``), drawn from the seed.

Two observation points are the harness's own, around calls into the
program: ``route_batch`` is wrapped to record each batch's start, end and
requests (and to start and stop the profiler at batch boundaries), and
the member lane's ``result`` is wrapped to keep every served token list,
keyed by the prompt's token ids, for the correctness check.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from reference.common import block_seed, draw_block
from vsrbench import spec as S
from vsrbench.traffic import TrafficRequest, user_of, warmup_requests

ENCODER_BACKEND = "vsrbench-encoder"


@dataclass
class BatchRecord:
    start: float
    end: float = 0.0
    indices: List[int] = field(default_factory=list)   # traffic indices
    stages: List[Tuple[str, float]] = field(default_factory=list)


class System:
    """Router, fleet and encoder of one cell on ``device``.  ``config``
    and ``encoder`` (the CPU tests' small sizes) replace the configuration
    file and ``router.json``'s encoder widths; on the card both are as the
    files give them."""

    def __init__(self, cell: S.Cell, seed: int, device: str = "cuda",
                 config: Optional[dict] = None,
                 encoder: Optional[dict] = None):
        from repro_torch.analysis.policy_verify import verify_config
        from repro_torch.core.dsl import compile_source

        self.cell = cell
        self.device = torch.device(device)
        self.config = config if config is not None else cell.config
        self.mix = cell.mix
        self.family = S.family(self.config)
        self.blocks = self.family.blocks(self.config)
        pm = self.family.port_model(self.config)
        self.arch = pm["arch"]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        self.router_cfg, diags = compile_source(cell.policy)
        fatal = [d for d in verify_config(self.router_cfg) if d.fatal]
        if fatal:
            raise ValueError(f"policy of {cell.config_name} fails the "
                             f"verifier: {fatal}")
        m2a = {m: p.arch for m, p in self.router_cfg.model_profiles.items()
               if p.arch}
        if set(m2a.values()) != {self.arch}:
            raise ValueError(f"the policy's members {m2a} are not the "
                             f"configuration's one member {self.arch}")
        self.model_name = next(iter(m2a))
        self._build_encoder(encoder, seed)
        self.router_cfg.classifier_backend = ENCODER_BACKEND
        self.fleet = self._build_fleet(pm)
        self.params = self.fleet.members[self.arch].params
        self.load_weights(seed)
        self.fleet.lanes[self.arch].warmup()
        self._capture_tokens()
        self.router = self._build_router(m2a)
        self.batches: List[BatchRecord] = []
        self._index_of: Dict[int, int] = {}
        self.on_batch_start: Optional[Callable[[int], None]] = None
        self.on_batch_end: Optional[Callable[[int], None]] = None
        self._wrap_route_batch()
        self._warm_router(seed)

    # -- build ------------------------------------------------------------
    def _build_encoder(self, widths: Optional[dict], seed: int):
        import dataclasses

        from repro_torch.classifiers.backend import register_backend
        from repro_torch.classifiers.encoder import (EncoderBackend,
                                                     EncoderConfig,
                                                     init_adapters,
                                                     init_encoder)
        router = S.load_json(S.BENCH / "router.json")
        widths = widths if widths is not None else router["encoder"]
        ecfg = dataclasses.replace(EncoderConfig(), **widths)
        gen = torch.Generator(device=self.device).manual_seed(
            block_seed(seed, 1 << 20))
        params = init_encoder(ecfg, gen, self.device)
        adapters = init_adapters(ecfg, gen, self.device)
        for ad in adapters.values():
            # nonzero LoRA B, so kernel 6's deltas are real work
            for k in ("b_q", "b_v"):
                ad[k].normal_(0.0, 0.02, generator=gen)
        for task in router["trained"]:
            # a zero head: the trained task runs the encoder and kernel 6
            # and decides BENIGN for every text
            adapters[task]["head"].zero_()
        self.encoder = EncoderBackend(ecfg, params, adapters,
                                      trained=set(router["trained"]))
        register_backend(ENCODER_BACKEND, self.encoder)

    def _build_fleet(self, pm: dict):
        from repro_torch.models.config import BlockSpec, LayerGroup
        from repro_torch.serving.fleet import LocalFleet

        ov = dict(pm["fields"])
        ov["groups"] = tuple(LayerGroup((BlockSpec(mx, ff),), n)
                             for mx, ff, n in pm["groups"] if n)
        if any(mx == "attn" for mx, _, _ in pm["groups"]):
            ov["attn_impl"] = "pallas"
        mix = self.mix
        return LocalFleet([self.arch], reduced=False,
                          batch=int(mix["slots"]),
                          max_seq=int(mix["max_seq"]),
                          gen_tokens=int(mix["answer_tokens"]),
                          decode_impl="flash_paged",
                          arch_overrides={self.arch: ov},
                          device=self.device, warmup=False)

    @torch.no_grad()
    def load_weights(self, seed: int):
        """Draw every block of weights from ``seed`` and copy it into the
        member, block by block; every parameter of the member is set."""
        named = dict(self.params.named_parameters())
        seen = set()
        for i, leaves in enumerate(self.blocks):
            for name, t in draw_block(leaves, seed, i, self.device).items():
                p = named.get(name)
                if p is None or tuple(p.shape) != tuple(t.shape) or \
                        p.dtype != t.dtype:
                    raise ValueError(
                        f"{name}: drawn {tuple(t.shape)} {t.dtype}, the "
                        f"member holds "
                        f"{None if p is None else (tuple(p.shape), p.dtype)}")
                p.copy_(t)
                seen.add(name)
            del t
        missing = set(named) - seen
        if missing:
            raise ValueError(f"member parameters not drawn: {sorted(missing)}")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _capture_tokens(self):
        """Keep each served request's tokens as the lane produces them."""
        self.served: Dict[Tuple[int, ...], List[int]] = {}
        lane = self.fleet.lanes[self.arch]
        inner = lane.result

        def result(seq):
            out = inner(seq)
            self.served[tuple(int(t) for t in seq.ids)] = list(out["tokens"])
            return out

        lane.result = result

    def _build_router(self, m2a):
        from repro_torch.core.router import SemanticRouter
        from repro_torch.serving.overload import OverloadDetector

        router = SemanticRouter(self.router_cfg,
                                call_fn=self.fleet.call_fn(m2a),
                                device=self.device)
        router.policies.lint = "strict"
        detector = OverloadDetector()
        detector.attach_fleet(self.fleet)
        router.overload = detector
        return router

    def _wrap_route_batch(self):
        inner = self.router.route_batch

        def route_batch(reqs):
            k = len(self.batches)
            if self.on_batch_start is not None:
                self.on_batch_start(k)
            rec = BatchRecord(start=time.perf_counter(),
                              indices=[self._index_of.get(id(r), -1)
                                       for r in reqs])
            self.batches.append(rec)
            pairs = inner(reqs)
            rec.end = time.perf_counter()
            if pairs:
                rec.stages = [(s["span"], s["ms"]) for s in pairs[0][1].trace
                              if s["span"].startswith("stage:")]
            if self.on_batch_end is not None:
                self.on_batch_end(k)
            return pairs

        self.router.route_batch = route_batch

    def _warm_router(self, seed: int):
        """Every router stage at the traffic's batch sizes (1 and the
        frontend's largest), on requests the router blocks, so nothing
        reaches the member: the member's own warm-up ran its prefill widths
        and decode step."""
        for n in sorted({1, int(self.mix["max_batch"])}):
            reqs = [self.make_request(r)
                    for r in warmup_requests(self.mix, n, seed)]
            pairs = self.router.route_batch(reqs)
            if not all(blocked(resp) for resp, _ in pairs):
                raise RuntimeError("the router served a warm-up request "
                                   "that carries an SSN")
        self.batches.clear()
        self._index_of.clear()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- serving ------------------------------------------------------------
    def make_request(self, r: TrafficRequest):
        from repro_torch.core.types import Message, Request
        req = Request(messages=[Message("user", r.text)],
                      user=user_of(r.index))
        self._index_of[id(req)] = r.index
        return req

    def frontend(self):
        from repro_torch.serving.frontend import AsyncFrontend
        fe = AsyncFrontend(self.router, window_ms=float(self.mix["window_ms"]),
                           max_batch=int(self.mix["max_batch"]))
        self.router.overload.attach_frontend(fe)
        return fe

    def release(self):
        """Drop the program's state (weights, caches, encoder) and return
        the card's memory to the allocator's pool."""
        from repro_torch.classifiers.backend import register_backend
        self.router.close()
        register_backend(ENCODER_BACKEND, None)
        for name in ("router", "fleet", "params", "encoder"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def blocked(resp) -> bool:
    """Whether the router answered ``resp`` itself (the safety route's
    fast response) instead of the member."""
    return resp.headers.get("x-vsr-fast-response") == "true"


def device_info(chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(d)
                                         for d in range(chips)))}

