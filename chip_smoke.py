#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases kernels,mla_model   # a subset, no result

Phases, in order; any failure exits non-zero before the result line:

1. card + build: the card's name and power limit (``nvidia-smi``), then
   the CUDA kernels built from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, in parallel) with their build seconds.
2. kernels: each kernel's wrapper against its plain PyTorch version on the
   card at the paths' shapes, float32 (TF32 off) and bfloat16; the MLA
   kernels also at a reduced shape (4 heads: one 16-row tile).
   The verify kernels are also held to the decode kernels bitwise
   (position t of a W = 5 verify == a decode launch at its frontier;
   W = 1 == decode) with dead positions (frontier <= 0) exact zeros.
   Kernels 2 and 3 also at a wide table: B = 8, every row at all 2048
   keys of max_seq 2048 (a cluster of 8 CTAs of 256 keys), W 1 and 5;
   kernels 4 and 5 at the same wide table at deepseek-v2's widths.
   Kernel 3 also at W = 12 positions x G = 16 heads of hd 128 (192 query
   rows, max_blocks 1 and 8): too wide for one launch, so the wrapper runs
   chunks of positions, each position still == decode bitwise.
   Kernels 1 and 2 also at the router fleet's other GQA shapes: qwen3-1.7b
   (16/8 heads) and glm4-9b (32/2, G = 16), hd 128, prefill at S = 479
   (causal, and lens + window) and decode over the fleet's table; kernel 1
   also at the whisper encoder's bidirectional shape (S 1500, 6/6 heads of
   64) and jamba's attention (32/8 heads of 128, causal, S 479).
   The multi-adapter LoRA kernel at the encoder path's shape (5 tasks x 12
   texts x 512 tokens, rows sorted by task), at sorted runs of 1, 127, 129
   and 257 rows (across its 128-row tile edges), at
   ``tests/test_kernels.py``'s LORA_CASES with shuffled ids and one task
   absent, and with out-of-range ids (exact zero rows); the contiguous
   ``flash_decode`` wrapper at the reference's DECODE_CASES.
3. model: full-width smollm-360m (random weights from a seeded
   ``torch.Generator``) through ``prefill`` + 16 ``decode_step``s on the
   kernel path and on the plain path, teacher-forced with the kernel
   path's greedy tokens; logits and tokens compared.  Then 5 random
   tokens per row through ``verify`` (W = 5) and through 5 successive
   ``decode_step``s on the same cache, on both paths.
4. fleet: the served path — ``LocalFleet(...).call_fn(...).batch_call``
   answering 12 OpenAI-style requests at full width with both kernels on;
   launch counts are zeroed just before and read just after.  Then one
   batch under ``torch.profiler`` (the card's busy share, top kernels),
   and a reduced float32 fleet on the card held token-for-token against
   the same fleet on the CPU (the plain path).
5. spec_fleet: the same 12 requests through the full-width smollm fleet
   with ``speculative=SpecConfig("smollm-360m", k=4)`` (an aligned draft:
   the registry config, the same seeded weights): verify kernel launches
   == 32 layers x speculative rounds; tokens against the fleet phase's,
   any divergence shown to be a near-tie; the profiler batch; then
   reduced float32 speculative fleets (smollm and deepseek, aligned
   drafts) on the card against the CPU plain fleets, token for token.
   The smollm fleets and model are freed before the deepseek phases.
6. signals: the learned-signal path — ``SignalEngine.extract_many`` over
   16 requests (12 distinct texts) with a full-width float32 encoder
   (ModernBERT-base widths: 22 layers, d 768, 12 heads, LoRA rank 32;
   ``max_len`` cut from 32 768 to 512) as classifier, hash embeddings,
   and one signal of each learned type plus a keyword signal: one fused
   ``classify_all`` and one ``token_classify`` per batch, the LoRA kernel
   launched 2 x 22 times per fused call, repeated texts identical; fused
   vs one forward per task (labels equal but for near-ties); the decision
   gate on the card == ``DecisionEngine`` per request (crisp/priority and
   fuzzy/confidence); a reduced float32 encoder on the card == the CPU;
   wall per batch and request, and the profiler batch.
7. mla_model: deepseek-v2-236b at its published widths (160 experts, top-6,
   2 shared; MLA r 512, rope 64) with its depth cut to 1 dense + 7 MoE
   layers of 60, bf16, through prefill + 16 teacher-forced decode steps on
   ``decode_impl="flash_paged"`` (the MLA kernels) and ``"xla"``, then the
   W = 5 verify against 5 decode steps.  (A full-width deepseek
   speculative fleet cannot run: its draft takes the registry depth, 60
   layers, ~471 GB.)
8. mla_fleet: the same cut model served through ``batch_call`` (the same
   12 requests, MLA kernel on, launches counted), the profiler batch, and
   a reduced float32 deepseek fleet on the card against the CPU.
9. contig: the contiguous (slot-row) cache at full width.  smollm-360m
   served from ``paged=False`` and from ``paged=True`` with ``xla`` and
   ``flash_paged`` decode, the 12 requests each (kernel 1 on the prefill):
   the 7 requests without the shared system prompt give identical tokens
   on the contiguous and the paged ``xla`` fleets, bit for bit; every
   other divergence must be a near-tie.  xlstm-350m at full width cut to
   one period, 2 of 24 layers (mLSTM + sLSTM, exact prefill widths, no
   kernel); jamba-v0.1-52b
   at every width cut to one period of its four (8 of 32 layers: 1
   attention with kernel 1, 7 mamba, 4 MoE of 16 experts; ~13.3 B
   parameters).  Each prints TTFT / TPOT p50, the profiler batch's busy
   share and peak memory; the xlstm and jamba tokens of the requests
   ``shard_mixers`` serves, with each member's bf16 logit error, stay for
   that phase.  Then reduced float32 contiguous smollm, jamba and xlstm
   fleets on the card against the CPU, token for token.
10. router: ``SemanticRouter.route_batch`` end to end, built by
   ``repro_torch.launch.serve.build_router`` at full width: its demo DSL
   as the default policy (lint strict), the ``cost`` and ``privacy``
   tenants from ``examples/policies``, one bf16 fleet of smollm-360m,
   qwen3-1.7b, glm4-9b and deepseek-v2 cut to 1 dense + 3 MoE layers
   (24.8 B parameters), the full-width encoder (ModernBERT-base widths,
   ``max_len`` 512, seed 0) as classifier serving the jailbreak signal
   (kernel 6).  The earlier phases' models are freed first.  With the
   launch counts zeroed just before: a warm-up batch of 8 of serve.py's
   demo requests (``user{i % 3}``, policies cycling default / cost /
   privacy), then three timed batches of 8; each batch checked (no error
   response, the gate == each program's engine, one gate call per policy
   sub-batch, fast responses never reach the fleet, ``live_refs() == 0``)
   and replayed request by request through ``route()`` from the state it
   started from (equal decisions and models).  Kernels 1, 2, 4 and 6 must
   launch, every member must serve.  Prints the wall per batch, ms per
   pipeline stage (the ``stage_scope`` spans), the router overhead per
   request ((wall - dispatch stage) / 8), each model's TTFT / TPOT p50,
   the card's busy share over a batch and over its non-dispatch stages,
   and ``max_memory_allocated``; then a reduced float32 router and fleet
   of the four archs on the card against the CPU (decisions, models and
   tokens equal).  When ``qos`` or ``audio`` runs too, the router and
   fleet stay for it.
11. qos: SLO admission, shedding, degradation and preemption on the router
   phase's full-width router and fleet (built here when that phase did not
   run), launch counts zeroed just before: the ``qos`` tenant (the
   reference's ``benchmarks/t_slo_burst.py`` policy on the router's model
   names, lint strict: premium -> qwen3 at SLO priority 100, batch-class
   -> glm4 degrading to qwen3, best-effort -> glm4, GLOBAL overload at
   queue depth 8); an open-loop burst through ``AsyncFrontend`` (window 5
   ms, batches of 8, depth bound 200, the detector sampling at every
   admission and watching the frontend's queue): a warm-up and 8 premium
   requests unloaded, then 12 batch-class + 12 best-effort flood requests
   back to back and 8 premium, every future read (a failure on the
   frontend's thread fails the phase).  Checks: no premium shed, every shed
   with ``x-vsr-error: overload`` and ``retry-after: 0.25``, sheds,
   degrades and preemptions == the admission metrics' deltas, at least
   one shed and one degrade, the detector at ``overload``, no error
   response, ``live_refs() == 0`` on every member, kernels 1, 2 and 6
   launched, peak memory flat across the burst.  Prints premium TTFT
   p50/p99 unloaded and under the burst, submit-to-answer times, the
   counts, the detector's samples and last ``EngineLoad``, frontend
   batches, the burst's wall, and the card's busy share over the burst's
   first ``route_batch`` (the one batch run under the profiler; its trace
   is parsed after the whole burst).  Then
   scheduler-direct preemption round trips (``tests/test_qos.py``'s, with
   8 victims filling the slots) on the smollm-360m lane (kernel 2) and
   the deepseek-v2 lane (kernel 4): victims' tokens == an uninterrupted
   run's but for near-ties, one park, a clean pool, the VIP's TTFT under
   preemption vs FIFO.  Then ``sd-tiny`` joins the fleet and serve.py's
   image requests go through ``route_batch`` of a ``text,image`` router:
   image-lane answers with an 8 x 8 uint8 payload, ``sig`` == the CPU
   lane's.  Last, a reduced float32 QoS router and fleet (smollm-360m,
   deepseek-v2) with the detector forced ok / busy / overload on the card
   against the CPU: equal decisions, sheds, degrades and tokens.  When
   ``audio`` runs too, the router and fleet stay for it.
12. audio: whisper-tiny at full width (4 + 4 layers, d 384, 1500 stub
   frames, ``attn_impl="pallas"``) joins the router phase's fleet (with
   sd-tiny if qos did not add it; both built here when neither ran), and
   one ``route_batch`` of 10 requests (4 text, serve.py's 2 image and 4
   audio ones) runs through a router on ``build_dsl(("text", "image",
   "audio"))`` over that fleet, launch counts zeroed just before: every
   audio request comes back from the audio lane with a transcript, the
   transcripts differ by payload, kernel 1 ran at the encoder's shape
   (1, 1500, 6, 64) once per encoder layer and audio request.  One more
   batch under the profiler; the audio lane's payloads, tokens and the
   member's bf16 logit error stay for ``shard_mixers``; then a reduced
   float32 whisper fleet on the card against the CPU.
13. train: checkpoint and training, launching none of the six kernels
   (counts zeroed just before the main path and checked to stay 0).
   (a) smollm-360m at published widths and depth (32 layers, d 960,
   15/5 heads of 64, vocab 49 152, tied, bf16; seeded torch weights)
   through ``repro_torch.launch.train.main``: ``TokenStream`` batch 8 x
   seq 512, lr 3e-4, warmup 1, remat on, 12 steps; every loss finite, the
   last below the first; step ms p50, tokens/s, the model-FLOP share
   (``models.config.model_flops``: 6 N T over 989 TFLOP/s), peak memory.  Then the crash drill in a temporary
   directory (deleted after): ``--ckpt-every 6 --fail-at-step 9`` must end
   in SystemExit(17), the re-run resumes at step 6 and its final loss
   equals the uninterrupted run's within rel 1e-4 (if the card's atomics
   break that, both runs again with deterministic algorithms, whose step
   time is printed); checkpoint bytes, write and read seconds; one more
   step under the profiler.  (b) ``examples/train_moe.py``'s ~100 M-class
   MoE (d 512, 8 attention + MoE layers of 16 experts top-2) for 4 steps
   under "gshard" and "ep": finite losses, nonzero ``moe_lb`` /
   ``moe_z``.  (c) ``build_router(train_adapters=True)`` (the default
   encoder, three tasks x 60 steps): "trained", then "loaded" from the
   same cache, equal adapters; ``train_adapter`` for jailbreak on the
   full-width encoder (ModernBERT-base widths, max_len 512, float32, TF32
   off) at 60 steps over 72 texts: loss below ln 3, seconds, peak memory,
   then the fused ``classify_all`` (kernel 6) on the trained adapter.
   (d) reduced float32 llama3.2-1b and qwen3-moe ("gshard") trained 8
   steps on the card and on the CPU from the same weights: losses within
   rel 1e-4; the card's checkpoint restores on the CPU bit for bit.
14. shard: the model axis on the one card.  (b) qwen3-moe-235b-a22b at
   published widths (d 4096, 64/4 heads of 128, 128 experts top-8, d_ff
   1536, vocab 151 936, qk-norm) cut to 4 of 94 layers (11.20 B
   parameters), ``attn_impl="pallas"``, ``decode_impl="flash_paged"``,
   ``moe_impl="ep"``, drawn from one seeded stream, served alone in
   this process: the 12 requests, TTFT/TPOT p50, peak memory; its bf16
   logits against the same weights in float32 over the 12 sequences'
   decision positions (the limit of every full-width check below is
   twice that error); then freed.
   (a) The same member and seeds over 2 ranks (``launch.mesh.host_ranks``:
   this process is rank 0, one worker process, both on the card, ``gloo``;
   mesh data 1 x model 2): each rank holds about half the bytes, some
   spec holds "model" (the reference's SHARDED_OK), the 12 requests with
   every rank's launch counts zeroed just before and read just after
   (kernels 1 and 2, equal on both ranks and non-zero), tokens == the
   unsharded member's or the first divergence a near-tie of the sharded
   logits (within the limit), the sharded-vs-unsharded logit error within
   the limit,
   TTFT/TPOT p50, each rank's peak memory, the decode steps' host-staged
   collective time.  (c) ``build_serve_steps`` on the same ranks and
   blocks: 8 rows of 64-token prompts, 32 tokens, ``shardmap`` (split-KV
   ``smdec`` over the sequence-sharded contiguous cache) vs ``xla`` (the
   head-sharded cache): logit error within the limit, tokens equal or a
   near-tie.  (d)
   ``compressed_psum_mean`` over the 2 ranks of a gradient tree shaped as
   smollm-360m's parameters (361.8 M float32): within one quantum, ratio
   < 0.27, seconds (host-staged).  (e) The reduced float32 sharded fleet,
   and ``build_serve_steps`` under ``shardmap`` and ``xla`` (4 rows, 8
   tokens), on the card's ranks == on 2 CPU ranks == unsharded on the CPU,
   token for token.
15. shard_train: the model axis, training half, on the one card (no
   kernel: every count zeroed before the sharded steps stays 0).  (a)
   qwen3-moe-235b-a22b at published widths cut to 1 of 94 layers (3.73 B
   parameters), batch 8 x seq 512, ``moe_impl="ep"``, remat on,
   ``attn_impl="blocked"``, weights from one seeded stream (each leaf
   drawn whole, then cut): step 0 of the same weights in float32 (the
   independent reading: twice the unsharded bf16 member's error against
   it bounds the loss, gradient-norm and gradient checks below), then
   ``make_step_fn`` unsharded in this process for 3 steps, freed; then
   ``build_train_step`` on ``make_host_mesh(model=2)`` over 2 ranks
   sharing the card, the same 3 steps: each rank holds about half the
   parameter and moment bytes, every step's loss and gradient norm
   within the limits of the unsharded run's; then one sharded step at lr
   3e-4 from step 0 (warmup 1, which moves bf16 weights) from the same
   draw: its gradient, gathered whole (``bridge.whole_params``), leaf by
   leaf within twice that leaf's bf16-vs-float32 error norm of the
   unsharded gradient, and its weights within one bf16 rounding of the
   one-process ``adamw_update`` of that gradient; step ms p50 sharded and
   unsharded, host-staged collective seconds a step and their share,
   each rank's peak memory, the model-FLOP share (``model_flops``: 6 x
   active parameters x tokens over 989 TFLOP/s).  (b) smollm-360m at
   published widths cut to 4 of 32 layers (``--layers 4``) through
   ``launch.train.main`` on 2 ranks (data 2 x model 1: data parallelism
   with FSDP), batch 8 x seq 512: 5 steps
   uninterrupted; the crash drill (``--ckpt-every 3 --fail-at-step 4``)
   ends every rank with code 17, a fresh 2-rank world resumes to the
   uninterrupted run's final loss (rel 1e-4); the 2 ranks' step-3
   checkpoint restores in one process without ranks and gives the
   uninterrupted run's step-3 loss (rel 1e-4); step ms p50 beside the
   ``train`` phase's unsharded one, checkpoint bytes, write and read
   seconds.  (c) reduced float32 llama3.2-1b and qwen3-moe, 3 steps of
   ``build_train_step`` on 2 card ranks, on 2 CPU ranks, and
   ``make_step_fn`` unsharded on the CPU: losses and gradient norms
   within rel 1e-5.
16. shard_gqa: query heads split over the model axis while the KV heads
   do not, and speculation over ranks.  glm4-9b at published widths (hf
   ``THUDM/glm-4-9b``: d 4096, 32/2 heads of 128, d_ff 13 696, vocab
   151 552) cut to 4 of 40 layers, paged, kernels 1-3 on.  (a) The first
   8 requests served alone in this process, then over 4 ranks on the
   card (mesh data 1 x model 4: a rank's 8 query heads read one KV head,
   which its pools alone hold): tokens equal or a near-tie (twice the
   unsharded member's bf16 logit error), launches of kernels 1 and 2 on
   every rank, per-rank peak memory and KV-pool bytes, TTFT / TPOT p50,
   the collectives' share of a decode step; one request under the
   profiler.  (b) The same sharded fleet with ``SpecConfig("glm4-9b",
   k=4)``: the draft is the registry config at all 40 layers, sharded
   over the same ranks; the first 2 requests, their tokens equal to
   (a)'s sharded tokens or diverging at a near-tie of the sharded
   target's logits (the same limit: one wide verify's GEMMs may round
   otherwise than W decode steps'), kernel 3 launched on every rank,
   acceptance, TPOT p50.  (c) Kernels
   1-3 at a rank's local shape (8/1 heads of 128; kernel 3 at W = 5, 40
   query rows) against their plain versions, kernel 3's positions ==
   kernel 2 bitwise, timed beside their plain versions and SDPA: three
   more rows of the JSON line (``"phase": "shard_gqa"``).
17. shard_mixers: SSM, cross-attention and encoder members over the
   model axis, at published widths in one ``LocalFleet(model_axis=2)``
   on 2 ranks (data 1 x model 2): jamba-v0.1-52b cut to one period (8 of
   32 layers; a rank holds 16/4 heads, 8 of 16 experts, 4096 of 8192
   mamba channels), xlstm-350m cut to one period (2 of 24; mixers whole
   on every rank over a vocab-parallel embedding), whisper-tiny whole
   (4 + 4 layers, 1500 frames through its audio lane) and
   llama-3.2-vision-90b cut to one period (5 of 100: 4 self-attention +
   1 cross-attention over 1600 patches).  Each member's first requests
   (jamba 8, the others 4) with every rank's launch counts zeroed just
   before and read just after: tokens equal to the unsharded member's
   (the contig and audio phases', else served alone here) or a near-tie
   (twice its bf16 logit error); the sharded member's teacher-forced
   logits over the same sequences within 1.5 x that error of the
   unsharded float32 logits; kernel 1 once per layer and request on
   every rank at each of its rank shapes (a spy on every rank sorts the
   calls), TTFT / TPOT p50, the collectives' share of a step, per-rank
   peak memory; jamba's per-rank mamba state (16 056 320 B), KV
   (8 388 608 B) and parameter bytes exactly as reckoned from the widths
   and the rules.  Then kernel 1 at the ranks' shapes (jamba 16/4 heads
   of 128, whisper's encoder 3/3 of 64 over 1500 frames and its decoder
   self-attention 3/3 of 64 over its 16-token BOS bucket, vision 32/4 of
   128) against its plain version at every width the path gave it,
   timed beside it and SDPA: four more rows of the JSON line
   (``"phase": "shard_mixers"``).
18. times: kernel, plain version and one PyTorch library call at the
   paths' shapes (median of CUDA-event timings, L2 flushed before each
   run), beside each kernel's bound; kernel 1 at S = 16, 64 and 479 (and
   at the whisper encoder's bidirectional 1500 frames and jamba's 32/8
   heads of 128, log lines) and
   the contiguous ``flash_decode`` at the fleet's decode shape and at
   DECODE_CASES, kernels 2-5 also at the wide table (log lines beside
   the rows), kernels 1 and 2 also at the qwen3-1.7b and glm4-9b shapes
   (log lines), with ``ptxas``'s registers for ``flash_attention.cu``,
   ``paged_decode.cu``, ``paged_mla_decode.cu`` (and its launch geometry)
   and ``multi_lora.cu``; kernel 6 also in bf16 and with shuffled ids at
   the path's shape (log lines).  Each bound comes from the kernel's cost
   function (``kernels.observed``) and the peaks of ``roofline.analysis``.
19. roofline: the main path's own steps at full width on the H100
   roofline, launch counts zeroed just before: (a) smollm-360m's fresh
   paged prefill of the fleet's longest prompt (479 tokens,
   ``attn_impl="pallas"``: kernel 1), (b) its batch-8 decode step under
   ``flash_paged`` (kernel 2, rows at ``ROOF_LENS``), (d) the ``train``
   phase's step (batch 8 x 512, remat, AdamW), (c) the deepseek-v2 cut's
   batch-8 decode step (1 dense + 7 MoE layers, kernel 4).  Each: the
   median of 10 CUDA-event runs, the profiler's device-busy time, and
   ``roofline.op_cost.CostMode`` traced on the card — FLOPs by dtype,
   bytes, the bound and its term, the predicted peak against
   ``max_memory_allocated`` — held exactly to the same step traced on the
   meta device, its matmul FLOPs within 1% of ``torch.profiler``'s
   (``with_flops``), the roofline share (bound / measured) at most 1.05,
   the model-FLOP share from ``model_flops``; ``op_lint`` clean on (b)
   and (c) (no gathered (B, max_seq) KV view, no host sync); no kernel
   built or loaded while a warmed step is replayed.  Beside the card's
   work, ``launch.dryrun`` runs qwen3-1.7b x decode_32k, qwen3-moe-235b-a22b
   x train_4k (their query heads split over a model axis of 16, their KV
   heads stay whole), smollm-360m x decode_32k and deepseek-v2-236b x
   train_4k on the 16 x 16 mesh (rank 0, meta device, subprocesses) and
   prints their counts.

The last two lines are one JSON object with a row per kernel, then
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX and
nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

ARCH = "smollm-360m"
MLA_ARCH = "deepseek-v2-236b"
MLA_MOE_LAYERS = 7                        # 1 dense + 7 MoE of the 60 layers
MLA_LAYERS = 1 + MLA_MOE_LAYERS
MAX_SEQ = 512
BLOCK = 16
BATCH = 8
GEN = 32
PROMPT_CAP = MAX_SEQ - GEN - 1            # the fleet's longest prefill (479)
NUM_BLOCKS = 1 + (BATCH + 4) * (MAX_SEQ // BLOCK)
# kernel vs plain: |a - b| <= TOL + TOL * |b| (tests/test_kernels.py:_tol's
# atol = rtol; bf16: a couple of bf16 ulps of the O(1) outputs)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the H100 SXM data sheet's rates (the port's one home of them); a
# checkout without the package stops here, before any result
from repro_torch.roofline.analysis import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.roofline.analysis import PEAK_FLOPS as PEAK_OPS  # noqa: E402
W_SPEC = 5                                # verify width: pending token + k = 4
# the wide table of kernels 2-5: every row at 2048 keys (C = 8, P = 16)
WIDE_SEQ = 2048
WIDE_BLOCKS = 1 + BATCH * (WIDE_SEQ // BLOCK)
PHASES = ("kernels", "model", "fleet", "spec_fleet", "signals", "mla_model",
          "mla_fleet", "contig", "router", "qos", "audio", "train", "shard",
          "shard_train", "shard_gqa", "shard_mixers", "times", "roofline")
# the encoder signal path: ModernBERT-base widths with max_len cut to 512
# (the reference's dense (B, H, S, S) float32 logits need ~51.5 GB per row
# at 32 768); 16 requests over 12 distinct texts, 5 fused sequence tasks
ENC_MAX_LEN = 512
SEQ_TASKS = ("domain", "jailbreak", "fact_check", "user_feedback",
             "modality")
N_TEXTS = 12
# N, din, dout, T, r of tests/test_kernels.py's LORA_CASES
LORA_CASES = ((256, 768, 768, 6, 32), (130, 512, 256, 3, 16),
              (256, 384, 384, 10, 64), (64, 128, 128, 1, 8))
# (Hq, Hkv, hd) of the router fleet's GQA members beyond smollm-360m's
# 15/5 heads of hd 64: kernels 1 and 2 are held and timed at these too
FLEET_HEADS = {"qwen3-1.7b": (16, 8, 128), "glm4-9b": (32, 2, 128)}
# B, Skv, Hq, Hkv, hd of tests/test_kernels.py's DECODE_CASES
DECODE_CASES = ((4, 512, 8, 2, 64), (2, 384, 6, 6, 128), (3, 1024, 16, 4, 64),
                (2, 256, 4, 1, 64))


def log(msg: str) -> None:
    print(msg, flush=True)


class Failure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise Failure(msg)


# ---------------------------------------------------------------------------
# phase 1: card + build
# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
        f"total {time.perf_counter() - t0:.2f} s")
    for name in _build.SOURCES:
        for line in ptxas_lines(name):
            log(f"  ptxas {name}: {line}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _rand(shape, dtype, gen):
    import torch
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def flash_cases(dtype, gen):
    """(label, q, k, v, lens, causal, window) at the fleet's prefill
    shapes: B=1, Hq=15, Hkv=5, hd=64, causal, S in the width buckets; one
    lens + window case in which every query row sees a key; the whisper
    encoder's and jamba's attention shapes."""
    import torch
    cases = []
    for S in (16, 64, PROMPT_CAP):
        cases.append((f"causal S={S}", _rand((1, S, 15, 64), dtype, gen),
                      _rand((1, S, 5, 64), dtype, gen),
                      _rand((1, S, 5, 64), dtype, gen), None, True, 0))
    S = PROMPT_CAP
    lens = torch.tensor([S, 300], dtype=torch.int32, device="cuda")
    cases.append((f"lens+window S={S}", _rand((2, S, 15, 64), dtype, gen),
                  _rand((2, S, 5, 64), dtype, gen),
                  _rand((2, S, 5, 64), dtype, gen), lens, True, 256))
    # the whisper encoder's bidirectional self-attention (1500 frames, 6/6
    # heads of 64) and jamba's attention layer (32/8 heads of 128, causal)
    B, S, H, hd = ENC_SHAPE
    cases.append((f"whisper encoder bidirectional S={S}",
                   _rand((B, S, H, hd), dtype, gen),
                   _rand((B, S, H, hd), dtype, gen),
                   _rand((B, S, H, hd), dtype, gen), None, False, 0))
    S = PROMPT_CAP
    cases.append((f"jamba 32/8 hd 128 causal S={S}",
                   _rand((1, S, 32, 128), dtype, gen),
                   _rand((1, S, 8, 128), dtype, gen),
                   _rand((1, S, 8, 128), dtype, gen), None, True, 0))
    return cases


def decode_case(dtype, gen, heads=(15, 5, 64)):
    """B=8 rows over the fleet's pool (385 blocks of 16; ``heads`` = (Hq,
    Hkv, hd), smollm-360m's 15/5 of hd 64 by default) through a random
    permutation of physical blocks; kv_len covers 0, 1, partial blocks and
    the full 512-token table."""
    import torch
    max_blocks = MAX_SEQ // BLOCK
    perm = torch.randperm(NUM_BLOCKS - 1, generator=torch.Generator()
                          .manual_seed(1)) + 1
    tbl = perm[:BATCH * max_blocks].reshape(BATCH, max_blocks)
    tbl = tbl.to(torch.int32).cuda().contiguous()
    kv_len = torch.tensor([0, 1, 7, 16, 100, 257, 511, 512],
                          dtype=torch.int32, device="cuda")
    Hq, Hkv, hd = heads
    q = _rand((BATCH, Hq, hd), dtype, gen)
    kpool = _rand((NUM_BLOCKS, BLOCK, Hkv, hd), dtype, gen)
    vpool = _rand((NUM_BLOCKS, BLOCK, Hkv, hd), dtype, gen)
    return q, kpool, vpool, tbl, kv_len


def mla_shapes(full=True):
    """(H, r, rh, nope) of deepseek-v2's MLA decode: the published widths,
    or the reduced config's (4 heads: one 16-row tile)."""
    return (128, 512, 64, 128) if full else (4, 16, 8, 16)


def mla_decode_case(dtype, gen, full=True):
    """B=8 rows over the MLA fleet's latent pool (385 blocks of 16 tokens)
    through a random permutation of physical blocks; kv_len covers 0, 1,
    partial blocks and the full 512-token table.  Returns (q_lat, q_rope,
    ckv_pool, krope_pool, tbl, kv_len, scale)."""
    H, r, rh, nope = mla_shapes(full)
    _, _, _, tbl, kv_len = decode_case(dtype, gen)
    return (_rand((BATCH, H, r), dtype, gen), _rand((BATCH, H, rh), dtype, gen),
            _rand((NUM_BLOCKS, BLOCK, r), dtype, gen),
            _rand((NUM_BLOCKS, BLOCK, rh), dtype, gen), tbl, kv_len,
            1.0 / math.sqrt(nope + rh))


def verify_case(dtype, gen, full=True, mla=False, heads=(15, 5, 64)):
    """decode_case's / mla_decode_case's table and pools (GQA: ``heads``
    as decode_case's) with W = 5 query positions per row.  kv_len (the
    TOTAL length, the 5 new entries included) covers dead positions (kv_len 1 and 3: the first positions'
    frontiers kv_len - 5 + t + 1 are <= 0; row 0's table is all trash),
    5 (first frontier 1), partial blocks and the full 512-token table.
    Returns (query tensors, rest of the arguments, kv_len, kwargs)."""
    import torch
    kv_len = torch.tensor([1, 3, W_SPEC, 16, 100, 257, 511, 512],
                          dtype=torch.int32, device="cuda")
    if mla:
        H, r, rh, _ = mla_shapes(full)
        _, _, ckv, krope, tbl, _, scale = mla_decode_case(dtype, gen, full)
        tbl[0] = 0
        return ((_rand((BATCH, W_SPEC, H, r), dtype, gen),
                 _rand((BATCH, W_SPEC, H, rh), dtype, gen)),
                (ckv, krope, tbl), kv_len, {"scale": scale})
    _, kpool, vpool, tbl, _ = decode_case(dtype, gen, heads)
    tbl[0] = 0
    return ((_rand((BATCH, W_SPEC, heads[0], heads[2]), dtype, gen),),
            (kpool, vpool, tbl), kv_len, {})


def wide_case(dtype, gen, W):
    """Kernels 2 and 3 at a wide table: B=8 rows, every row at all 2048
    keys of its table (max_seq 2048), a pool of 1025 blocks of 16 through
    a random permutation, 15/5 heads, hd 64; W query positions per row
    (W = 0: a decode query (B, Hq, hd)).  Returns (q, kpool, vpool, tbl,
    kv_len)."""
    import torch
    max_blocks = WIDE_SEQ // BLOCK
    perm = torch.randperm(WIDE_BLOCKS - 1, generator=torch.Generator()
                          .manual_seed(5)) + 1
    tbl = perm.reshape(BATCH, max_blocks).to(torch.int32).cuda().contiguous()
    kv_len = torch.full((BATCH,), WIDE_SEQ, dtype=torch.int32, device="cuda")
    q = _rand((BATCH, W, 15, 64) if W else (BATCH, 15, 64), dtype, gen)
    kpool = _rand((WIDE_BLOCKS, BLOCK, 5, 64), dtype, gen)
    vpool = _rand((WIDE_BLOCKS, BLOCK, 5, 64), dtype, gen)
    return q, kpool, vpool, tbl, kv_len


def mla_wide_case(dtype, gen, W):
    """Kernels 4 and 5 at ``wide_case``'s table (B=8 rows, every row at
    all 2048 keys, a pool of 1025 blocks of 16 through a random
    permutation) at deepseek-v2's widths; W query positions per row (W =
    0: decode queries (B, H, r)).  Returns (q_lat, q_rope, ckv_pool,
    krope_pool, tbl, kv_len, scale)."""
    import torch
    H, r, rh, nope = mla_shapes()
    max_blocks = WIDE_SEQ // BLOCK
    perm = torch.randperm(WIDE_BLOCKS - 1, generator=torch.Generator()
                          .manual_seed(6)) + 1
    tbl = perm.reshape(BATCH, max_blocks).to(torch.int32).cuda().contiguous()
    kv_len = torch.full((BATCH,), WIDE_SEQ, dtype=torch.int32, device="cuda")
    lead = (BATCH, W, H) if W else (BATCH, H)
    return (_rand(lead + (r,), dtype, gen), _rand(lead + (rh,), dtype, gen),
            _rand((WIDE_BLOCKS, BLOCK, r), dtype, gen),
            _rand((WIDE_BLOCKS, BLOCK, rh), dtype, gen), tbl, kv_len,
            1.0 / math.sqrt(nope + rh))


def split_verify_case(dtype, gen, max_blocks):
    """Kernel 3 beyond one launch's shared memory: W = 12 positions x G =
    16 query heads (32 over 2 KV heads) of hd 128, 192 query rows, over a
    40-block pool through a random table of ``max_blocks`` blocks of 16;
    kv_len 1 (dead positions), 12 (first frontier 1), the full table and
    two random.  Returns (qs, rest, kv_len, kwargs) for ``hold_verify``."""
    import random

    import torch
    W, nb = 12, 40
    S = max_blocks * BLOCK
    rnd = random.Random(max_blocks)
    lens = [1, W, S] + [rnd.randrange(W, S + 1) for _ in range(2)]
    tbl = torch.tensor([[rnd.randrange(1, nb) for _ in range(max_blocks)]
                        for _ in lens], dtype=torch.int32, device="cuda")
    return ((_rand((len(lens), W, 32, 128), dtype, gen),),
            (_rand((nb, BLOCK, 2, 128), dtype, gen),
             _rand((nb, BLOCK, 2, 128), dtype, gen), tbl),
            torch.tensor(lens, dtype=torch.int32, device="cuda"), {})


def hold_verify(label, verify, plain, decode, qs, rest, kv_len, kw, dname):
    """The verify kernel against its plain version within the tolerance;
    position t against the decode kernel at its frontier kv_len - W + t + 1
    bitwise; a W = 1 verify against decode bitwise; positions whose
    frontier is <= 0 exact zeros.  Returns the max abs error."""
    import torch
    out = verify(*qs, *rest, kv_len, **kw)
    ref = plain(*qs, *rest, kv_len, **kw)
    W = qs[0].shape[1]
    steps = [decode(*(q[:, t].contiguous() for q in qs), *rest,
                    kv_len - (W - 1 - t), **kw) for t in range(W)]
    one = verify(*(q[:, :1].contiguous() for q in qs), *rest, kv_len, **kw)
    dec = decode(*(q[:, 0].contiguous() for q in qs), *rest, kv_len, **kw)
    torch.cuda.synchronize()
    err, ok = _compare(out, ref, TOL[dname])
    frontier = kv_len[:, None] - W + 1 + \
        torch.arange(W, device=kv_len.device)[None]
    zeros = bool((out[frontier <= 0] == 0).all().item())
    bitwise = all(torch.equal(out[:, t], steps[t]) for t in range(W))
    w1 = torch.equal(one[:, 0], dec)
    ok = ok and zeros and bitwise and w1
    log(f"  {label} {dname} q {tuple(qs[0].shape)} kv_len "
        f"{kv_len.tolist()}: max_abs_err {err:.3e}, each position == decode "
        f"kernel at its frontier bitwise: {bitwise}, W=1 == decode: {w1}, "
        f"dead positions exact zeros: {zeros} {'ok' if ok else 'FAIL'}")
    check(ok, f"{label} {dname}: err {err} bitwise={bitwise} w1={w1} "
          f"zeros={zeros}")
    return err


def _compare(out, ref, tol):
    """(max abs error, within |a - b| <= tol + tol * |b| everywhere)."""
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    ok = math.isfinite(err) and bool(
        (diff <= tol + tol * ref.float().abs()).all().item())
    return err, ok


def lora_path_case(dtype, gen):
    """Kernel 6 at the encoder path's shape: T = 5 tasks x 12 texts x 512
    tokens = 30 720 rows, din = dout = 768, r = 32, rows sorted by task as
    ``multitask_logits`` lays them out.  Returns (x, a, b, ids)."""
    import torch
    T, N, d, r = len(SEQ_TASKS), len(SEQ_TASKS) * N_TEXTS * ENC_MAX_LEN, 768, 32
    ids = (torch.arange(N, device="cuda") // (N // T)).to(torch.int32)
    return (_rand((N, d), dtype, gen), _rand((T, d, r), dtype, gen) * 0.05,
            _rand((T, r, d), dtype, gen) * 0.05, ids.contiguous())


def lora_cases(dtype, gen):
    """(label, x, a, b, ids, scale): the path's shape (scale 1, the
    encoder's); sorted runs of 1, 127, 129 and 257 rows at the path's
    widths (runs straddling the kernel's 128-row tile edges); LORA_CASES at
    scale 2 with the ids shuffled and task T-1 absent (T > 1); one case
    with ids outside [0, T) mixed in."""
    import torch
    cases = [("path sorted", *lora_path_case(dtype, gen), 1.0)]
    runs = (1, 127, 129, 257)
    ids = torch.cat([torch.full((n,), t) for t, n in enumerate(runs)])
    N, T = int(ids.numel()), len(runs)
    cases.append((f"N={N} runs {runs} sorted (tile edges)",
                  _rand((N, 768), dtype, gen),
                  _rand((T, 768, 32), dtype, gen) * 0.05,
                  _rand((T, 32, 768), dtype, gen) * 0.05,
                  ids.to(torch.int32).cuda(), 2.0))
    perm_gen = torch.Generator().manual_seed(3)
    for N, din, dout, T, r in LORA_CASES:
        ids = (torch.arange(N) % max(1, T - 1))[torch.randperm(
            N, generator=perm_gen)]
        cases.append((f"N={N} din={din} dout={dout} T={T} r={r} shuffled",
                      _rand((N, din), dtype, gen),
                      _rand((T, din, r), dtype, gen) * 0.05,
                      _rand((T, r, dout), dtype, gen) * 0.05,
                      ids.to(torch.int32).cuda(), 2.0))
    N, din, dout, T, r = LORA_CASES[1]
    ids = torch.randint(0, T, (N,), generator=perm_gen)
    ids[::7], ids[3::11], ids[5::13] = -1, T, 1 << 20
    cases.append((f"N={N} T={T} out-of-range ids", _rand((N, din), dtype, gen),
                  _rand((T, din, r), dtype, gen) * 0.05,
                  _rand((T, r, dout), dtype, gen) * 0.05,
                  ids.to(torch.int32).cuda(), 2.0))
    return cases


def check_lora_and_flash_decode(errs, dtype, dname, gen):
    """Kernel 6 on ``lora_cases`` and the contiguous ``flash_decode``
    wrapper on DECODE_CASES, each against its plain version."""
    import torch
    from repro_torch.kernels.flash_decode.ops import (flash_decode,
                                                      flash_decode_plain)
    from repro_torch.kernels.multi_lora.ops import multi_lora, multi_lora_plain
    for label, x, a, b, ids, scale in lora_cases(dtype, gen):
        out = multi_lora(x, a, b, ids, scale=scale)
        ref = multi_lora_plain(x, a, b, ids, scale=scale)
        torch.cuda.synchronize()
        err, ok = _compare(out, ref, TOL[dname])
        dead = (ids < 0) | (ids >= a.shape[0])
        zeros = bool((out[dead] == 0).all().item())
        ok = ok and zeros
        log(f"  multi_lora {dname} {label}: max_abs_err {err:.3e} (max "
            f"|out| {out.float().abs().max().item():.3e}), "
            f"{int(dead.sum())} out-of-range rows exact zeros: {zeros} "
            f"{'ok' if ok else 'FAIL'}")
        check(ok, f"multi_lora {dname} {label}: {err} zeros={zeros}")
        errs["multi_lora"] = max(errs.get("multi_lora", 0.0), err)
    for B, Skv, Hq, Hkv, hd in DECODE_CASES:
        q = _rand((B, Hq, hd), dtype, gen)
        k, v = (_rand((B, Skv, Hkv, hd), dtype, gen) for _ in range(2))
        kl = torch.randint(1, Skv + 1, (B,), generator=gen, device="cuda",
                           dtype=torch.int32)
        out = flash_decode(q, k, v, kl)
        ref = flash_decode_plain(q, k, v, kl)
        torch.cuda.synchronize()
        err, ok = _compare(out, ref, TOL[dname])
        log(f"  flash_decode {dname} B={B} Skv={Skv} {Hq}/{Hkv} heads hd "
            f"{hd} kv_len {kl.tolist()}: max_abs_err {err:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        check(ok, f"flash_decode {dname} Skv={Skv}: {err}")


def check_fleet_heads(errs, dtype, dname, gen):
    """Kernels 1 and 2 at the router fleet's other GQA shapes
    (FLEET_HEADS: qwen3-1.7b 16/8 and glm4-9b 32/2 heads of hd 128):
    causal prefill at the longest prefill (S = 479) and a lens + window
    case, decode over ``decode_case``'s table, each against its plain
    version."""
    import torch
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    from repro_torch.kernels.flash_decode.ops import (
        paged_flash_decode, paged_flash_decode_plain)
    S = PROMPT_CAP
    for arch, (Hq, Hkv, hd) in FLEET_HEADS.items():
        lens = torch.tensor([S, 300], dtype=torch.int32, device="cuda")
        for label, B, ln, window in (("causal", 1, None, 0),
                                     ("lens+window", 2, lens, 256)):
            q = _rand((B, S, Hq, hd), dtype, gen)
            k = _rand((B, S, Hkv, hd), dtype, gen)
            v = _rand((B, S, Hkv, hd), dtype, gen)
            out = flash_attention(q, k, v, ln, causal=True,
                                  sliding_window=window)
            ref = flash_attention_plain(q, k, v, ln, causal=True,
                                        sliding_window=window)
            torch.cuda.synchronize()
            err, ok = _compare(out, ref, TOL[dname])
            log(f"  flash_attention {dname} {arch} {Hq}/{Hkv} heads hd {hd} "
                f"{label} S={S}: max_abs_err {err:.3e} "
                f"{'ok' if ok else 'FAIL'}")
            check(ok, f"flash_attention {dname} {arch} {label}: {err}")
            errs["flash_attention"] = max(errs.get("flash_attention", 0.0),
                                          err)
        q, kpool, vpool, tbl, kv_len = decode_case(dtype, gen, (Hq, Hkv, hd))
        out = paged_flash_decode(q, kpool, vpool, tbl, kv_len)
        ref = paged_flash_decode_plain(q, kpool, vpool, tbl, kv_len)
        torch.cuda.synchronize()
        err, ok = _compare(out, ref, TOL[dname])
        zeros = bool((out[kv_len == 0] == 0).all().item())
        ok = ok and zeros
        log(f"  paged_flash_decode {dname} {arch} {Hq}/{Hkv} heads hd {hd} "
            f"B={BATCH} kv_len={kv_len.tolist()}: max_abs_err {err:.3e}, "
            f"kv_len==0 rows exact zeros: {zeros} {'ok' if ok else 'FAIL'}")
        check(ok, f"paged_flash_decode {dname} {arch}: {err} zeros={zeros}")
        errs["paged_flash_decode"] = max(errs.get("paged_flash_decode", 0.0),
                                         err)


def check_wide_paged(errs, dtype, dname, gen):
    """Kernels 2 and 3 at ``wide_case``: decode against its plain version;
    verify at W = 5 and W = 1 through ``hold_verify``."""
    import torch
    from repro_torch.kernels.flash_decode.ops import (
        paged_flash_decode, paged_flash_decode_plain, paged_flash_verify,
        paged_flash_verify_plain)
    q, kpool, vpool, tbl, kv_len = wide_case(dtype, gen, 0)
    out = paged_flash_decode(q, kpool, vpool, tbl, kv_len)
    ref = paged_flash_decode_plain(q, kpool, vpool, tbl, kv_len)
    torch.cuda.synchronize()
    err, ok = _compare(out, ref, TOL[dname])
    log(f"  paged_flash_decode {dname} wide B={BATCH} max_seq {WIDE_SEQ} "
        f"kv_len all {WIDE_SEQ}: max_abs_err {err:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"paged_flash_decode {dname} wide: {err}")
    errs["paged_flash_decode"] = max(errs.get("paged_flash_decode", 0.0), err)
    for W in (W_SPEC, 1):
        q, kpool, vpool, tbl, kv_len = wide_case(dtype, gen, W)
        err = hold_verify(f"paged_flash_verify wide max_seq {WIDE_SEQ}",
                          paged_flash_verify, paged_flash_verify_plain,
                          paged_flash_decode, (q,), (kpool, vpool, tbl),
                          kv_len, {}, dname)
        errs["paged_flash_verify"] = max(errs.get("paged_flash_verify", 0.0),
                                         err)


def check_wide_mla(errs, dtype, dname, gen):
    """Kernels 4 and 5 at ``mla_wide_case``: decode against its plain
    version; verify at W = 5 through ``hold_verify``."""
    import torch
    from repro_torch.kernels.flash_decode.ops import (
        paged_flash_decode_mla, paged_flash_decode_mla_plain,
        paged_flash_verify_mla, paged_flash_verify_mla_plain)
    *args, scale = mla_wide_case(dtype, gen, 0)
    out = paged_flash_decode_mla(*args, scale=scale)
    ref = paged_flash_decode_mla_plain(*args, scale=scale)
    torch.cuda.synchronize()
    err, ok = _compare(out, ref, TOL[dname])
    log(f"  paged_flash_decode_mla {dname} wide B={BATCH} max_seq {WIDE_SEQ} "
        f"kv_len all {WIDE_SEQ}: max_abs_err {err:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"paged_flash_decode_mla {dname} wide: {err}")
    errs["paged_flash_decode_mla"] = max(
        errs.get("paged_flash_decode_mla", 0.0), err)
    ql, qr, ckv, kr, tbl, kv_len, scale = mla_wide_case(dtype, gen, W_SPEC)
    err = hold_verify(f"paged_flash_verify_mla wide max_seq {WIDE_SEQ}",
                      paged_flash_verify_mla, paged_flash_verify_mla_plain,
                      paged_flash_decode_mla, (ql, qr), (ckv, kr, tbl),
                      kv_len, {"scale": scale}, dname)
    errs["paged_flash_verify_mla"] = max(
        errs.get("paged_flash_verify_mla", 0.0), err)


def phase_kernels(errs):
    import torch
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    from repro_torch.kernels.flash_decode.ops import (
        paged_flash_decode, paged_flash_decode_mla,
        paged_flash_decode_mla_plain, paged_flash_decode_plain,
        paged_flash_verify, paged_flash_verify_mla,
        paged_flash_verify_mla_plain, paged_flash_verify_plain,
        verify_chunks)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("kernels: float32 references with TF32 off "
        "(torch.backends.cuda.matmul.allow_tf32 = False); limits "
        f"|a - b| <= tol + tol * |b|: float32 tol {TOL['float32']}, "
        f"bfloat16 tol {TOL['bfloat16']}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for label, q, k, v, lens, causal, window in flash_cases(dtype, gen):
            out = flash_attention(q, k, v, lens, causal=causal,
                                  sliding_window=window)
            ref = flash_attention_plain(q, k, v, lens, causal=causal,
                                        sliding_window=window)
            torch.cuda.synchronize()
            err, ok = _compare(out, ref, TOL[dname])
            log(f"  flash_attention {dname} {label}: max_abs_err {err:.3e} "
                f"{'ok' if ok else 'FAIL'}")
            check(ok, f"flash_attention {dname} {label}: {err}")
            errs["flash_attention"] = max(errs.get("flash_attention", 0.0),
                                          err)
        q, kpool, vpool, tbl, kv_len = decode_case(dtype, gen)
        out = paged_flash_decode(q, kpool, vpool, tbl, kv_len)
        ref = paged_flash_decode_plain(q, kpool, vpool, tbl, kv_len)
        torch.cuda.synchronize()
        err, ok = _compare(out, ref, TOL[dname])
        zeros = bool((out[kv_len == 0] == 0).all().item())
        ok = ok and zeros
        log(f"  paged_flash_decode {dname} B={BATCH} "
            f"kv_len={kv_len.tolist()}: max_abs_err {err:.3e}, "
            f"kv_len==0 rows exact zeros: {zeros} {'ok' if ok else 'FAIL'}")
        check(ok, f"paged_flash_decode {dname}: {err} zeros={zeros}")
        errs["paged_flash_decode"] = max(errs.get("paged_flash_decode", 0.0),
                                         err)
        for full in (True, False):
            *args, scale = mla_decode_case(dtype, gen, full)
            out = paged_flash_decode_mla(*args, scale=scale)
            ref = paged_flash_decode_mla_plain(*args, scale=scale)
            torch.cuda.synchronize()
            err, ok = _compare(out, ref, TOL[dname])
            kv_len = args[-1]
            zeros = bool((out[kv_len == 0] == 0).all().item())
            ok = ok and zeros
            H, r, rh, _ = mla_shapes(full)
            log(f"  paged_flash_decode_mla {dname} B={BATCH} H={H} r={r} "
                f"rh={rh} kv_len={kv_len.tolist()}: max_abs_err {err:.3e}, "
                f"kv_len==0 rows exact zeros: {zeros} "
                f"{'ok' if ok else 'FAIL'}")
            check(ok, f"paged_flash_decode_mla {dname} H={H}: {err} "
                  f"zeros={zeros}")
            errs["paged_flash_decode_mla"] = max(
                errs.get("paged_flash_decode_mla", 0.0), err)
        qs, rest, kv_len, kw = verify_case(dtype, gen)
        err = hold_verify("paged_flash_verify", paged_flash_verify,
                          paged_flash_verify_plain, paged_flash_decode, qs,
                          rest, kv_len, kw, dname)
        errs["paged_flash_verify"] = max(errs.get("paged_flash_verify", 0.0),
                                         err)
        check_wide_paged(errs, dtype, dname, gen)
        check_fleet_heads(errs, dtype, dname, gen)
        for max_blocks in (1, 8):
            qs, rest, kv_len, kw = split_verify_case(dtype, gen, max_blocks)
            chunks = verify_chunks(12, 16, max_blocks, BLOCK, 128,
                                   qs[0].element_size())
            before = paged_flash_verify.launches
            err = hold_verify(f"paged_flash_verify split {chunks} max_blocks "
                              f"{max_blocks}", paged_flash_verify,
                              paged_flash_verify_plain, paged_flash_decode,
                              qs, rest, kv_len, kw, dname)
            # the W = 12 verify launches once a chunk, the W = 1 one once
            n = paged_flash_verify.launches - before
            check(len(chunks) > 1 and n == len(chunks) + 1,
                  f"split verify {dname}: {n} launches for chunks {chunks}")
            errs["paged_flash_verify"] = max(
                errs.get("paged_flash_verify", 0.0), err)
        for full in (True, False):
            qs, rest, kv_len, kw = verify_case(dtype, gen, full, mla=True)
            err = hold_verify("paged_flash_verify_mla",
                              paged_flash_verify_mla,
                              paged_flash_verify_mla_plain,
                              paged_flash_decode_mla, qs, rest, kv_len, kw,
                              dname)
            errs["paged_flash_verify_mla"] = max(
                errs.get("paged_flash_verify_mla", 0.0), err)
        check_wide_mla(errs, dtype, dname, gen)
        check_lora_and_flash_decode(errs, dtype, dname, gen)


# ---------------------------------------------------------------------------
# phase 3: full-width model, kernel path vs plain path
# ---------------------------------------------------------------------------

# max |logit difference| kernel path vs plain path over prefill + 16 steps;
# an H100 run measured 6.3e-6 (float32) and 6.25e-2 (bf16: a few bf16 ulps
# of logits of magnitude ~4, compounded over 32 layers)
MODEL_TOL = {"float32": 1e-3, "bfloat16": 0.25}


def kernel_vs_plain(label, paths, params, toks, lens_l, tol, *,
                    per_row=False, moe_impl="ep"):
    """Prefill ``toks`` (B rows, real lengths ``lens_l``) then 16 decode
    steps on the "kernel" and "plain" configs of ``paths``, teacher-forced
    with the kernel path's greedy tokens; logs and checks the max |logit
    difference| against ``tol`` and that any greedy divergence is a
    near-tie.  ``per_row`` prefills one row per call, as the fleet does.
    Returns the caches (for the caller to free)."""
    import torch
    from repro_torch.models import model as MD
    from repro_torch.serving.serve_lib import greedy
    B = len(lens_l)
    max_blocks = MAX_SEQ // BLOCK
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    tbl = (1 + torch.arange(B * max_blocks, device="cuda")
           .reshape(B, max_blocks)).to(torch.int32)
    caches, logits = {}, {}
    for name, c in paths.items():
        caches[name] = MD.init_paged_cache(c, B, MAX_SEQ, 1 + B * max_blocks,
                                           BLOCK, device="cuda")
        if per_row:
            logits[name] = torch.cat([
                MD.prefill(c, params, toks[b:b + 1, :lens_l[b]],
                           caches[name], moe_impl=moe_impl,
                           tbl=tbl[b:b + 1], paged_fresh=True)[0]
                for b in range(B)])
        else:
            logits[name], _ = MD.prefill(c, params, toks, caches[name],
                                         moe_impl=moe_impl, lens=lens,
                                         tbl=tbl, paged_fresh=True)
        caches[name]["pos"] = lens.clone()
        caches[name]["tbl"] = tbl
    max_diff, agree, total, first_div, scale = 0.0, 0, 0, None, 0.0
    diffs = []
    for step in range(17):
        lk, lp = logits["kernel"].float(), logits["plain"].float()
        check(bool(torch.isfinite(lk).all()) and
              bool(torch.isfinite(lp).all()),
              f"{label}: non-finite logits at step {step}")
        d = (lk - lp).abs().max().item()
        diffs.append(d)
        max_diff = max(max_diff, d)
        scale = max(scale, lp.abs().max().item())
        tk, tp = greedy(lk), greedy(lp)
        same = tk == tp
        agree += int(same.sum())
        total += B
        if first_div is None and not bool(same.all()):
            r = int((~same).nonzero()[0, 0])
            top2 = torch.topk(lp[r], 2).values
            first_div = (step, r, (top2[0] - top2[1]).item(), d)
        if step == 16:
            break
        nxt = greedy(logits["kernel"])[:, None]   # teacher forcing
        for name, c in paths.items():
            logits[name], _ = MD.decode_step(c, params, nxt, caches[name],
                                             moe_impl=moe_impl)
    torch.cuda.synchronize()
    log(f"{label}: prefill lens {lens_l} + 16 decode steps, max |logit "
        f"diff| kernel vs plain {max_diff:.4e} (limit {tol}; max |logit| "
        f"{scale:.3f}), greedy tokens agree {agree}/{total}")
    log(f"  max |logit diff| per call: "
        f"{' '.join(f'{d:.2e}' for d in diffs)}")
    check(max_diff <= tol, f"{label}: logit diff {max_diff}")
    if first_div is not None:
        step, r, gap, d = first_div
        log(f"  first divergence: step {step} row {r}, top-2 logit gap "
            f"{gap:.4e} vs logit diff {d:.4e} at that step")
        check(gap < d, f"{label}: divergence is not a near-tie")
    return caches


def verify_vs_decode(label, paths, params, caches, tol, *, moe_impl="ep"):
    """The speculative verify at full width: 5 random tokens per row
    through ``model.verify`` (W = 5) on each path's cache, then the same
    tokens through 5 successive ``decode_step``s on that cache.  Compares
    verify vs decode on each path and kernel vs plain verify: max |logit
    difference| against ``tol``, greedy agreement, any greedy divergence
    a near-tie (top-2 gap of the second logits below the pair's logit
    difference at that position).  Returns the largest difference."""
    import torch
    from repro_torch.models import model as MD
    from repro_torch.serving.serve_lib import greedy
    B = caches["kernel"]["pos"].shape[0]
    vocab = paths["kernel"].vocab_size
    toks = torch.randint(4, vocab, (B, W_SPEC), device="cuda",
                         dtype=torch.int32,
                         generator=torch.Generator(device="cuda")
                         .manual_seed(3))
    logits = {}
    for name, c in paths.items():
        cache = caches[name]
        pos0 = cache["pos"].clone()
        logits[f"{name} verify"], _ = MD.verify(c, params, toks, cache,
                                                moe_impl=moe_impl)
        check(torch.equal(cache["pos"], pos0), f"{label}: verify moved pos")
        steps = []
        for t in range(W_SPEC):
            lg, _ = MD.decode_step(c, params, toks[:, t:t + 1], cache,
                                   moe_impl=moe_impl)
            steps.append(lg)
        logits[f"{name} decode"] = torch.stack(steps, dim=1)
    torch.cuda.synchronize()
    worst = 0.0
    for a, b in (("kernel verify", "kernel decode"),
                 ("plain verify", "plain decode"),
                 ("kernel verify", "plain verify")):
        la, lb = logits[a].float(), logits[b].float()
        check(bool(torch.isfinite(la).all()) and
              bool(torch.isfinite(lb).all()), f"{label}: non-finite logits")
        diff = (la - lb).abs()
        d = diff.max().item()
        worst = max(worst, d)
        same = greedy(la) == greedy(lb)
        log(f"{label}: W={W_SPEC} {a} vs {b}: max |logit diff| {d:.4e} "
            f"(limit {tol}), greedy agree {int(same.sum())}/{same.numel()}")
        check(d <= tol, f"{label}: {a} vs {b} logit diff {d}")
        for r, t in (~same).nonzero().tolist():
            top2 = torch.topk(lb[r, t], 2).values
            gap = (top2[0] - top2[1]).item()
            dt = diff[r, t].max().item()
            log(f"  divergence row {r} position {t}: top-2 gap {gap:.4e} vs "
                f"max logit diff {d:.4e} (there {dt:.4e})")
            check(gap < d, f"{label}: {a} vs {b} divergence is not a "
                  f"near-tie")
    return worst


def phase_model(ctx):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as MD
    B, lens_l = 4, [PROMPT_CAP, 300, 37, 128]
    for dname in ("bfloat16", "float32"):
        cfg = get_config(ARCH).replace(dtype=dname)
        t0 = time.perf_counter()
        params = MD.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        n_par = sum(p.numel() for p in params.parameters())
        tok_gen = torch.Generator(device="cuda").manual_seed(1)
        toks = torch.randint(4, cfg.vocab_size, (B, PROMPT_CAP),
                             generator=tok_gen, device="cuda",
                             dtype=torch.int32)
        paths = {"kernel": cfg.replace(attn_impl="pallas",
                                       decode_impl="flash_paged"),
                 "plain": cfg.replace(attn_impl="einsum", decode_impl="xla")}
        caches = kernel_vs_plain(f"model {ARCH} {dname} ({n_par} params)",
                                 paths, params, toks, lens_l, MODEL_TOL[dname])
        ctx[f"{ARCH} {dname} verify err"] = verify_vs_decode(
            f"model {ARCH} {dname}", paths, params, caches, MODEL_TOL[dname])
        log(f"  {time.perf_counter() - t0:.1f} s")
        del params, caches
        gc.collect()
        torch.cuda.empty_cache()


def mla_cut_groups(moe_layers=MLA_MOE_LAYERS):
    """deepseek-v2's depth cut to fit one 80 GB card: its dense layer 0 and
    ``moe_layers`` of its 59 MoE layers, every width kept."""
    from repro_torch.models.config import BlockSpec, LayerGroup
    return (LayerGroup((BlockSpec("mla", "dense"),), 1),
            LayerGroup((BlockSpec("mla", "moe"),), moe_layers))


# max |logit difference| MLA kernel path vs plain path over prefill + 16
# decode steps.  float32 (TF32 off): summation order only, as smollm's.
# bfloat16: the kernel rounds P·ckv once from float32 where the plain
# einsum's bf16 output differs by up to one bf16 ulp; across layers such a
# difference can flip one of a token's top-6 of 160 near-tied experts,
# which changes that token's FFN output outright, so the limit is loose
# and any greedy divergence must also be a near-tie.  The float32 run
# keeps 1 dense + 2 MoE layers (42.8 GB of weights) to fit the card.
MLA_MODEL_TOL = {"float32": 1e-3, "bfloat16": 2.0}
MLA_F32_MOE_LAYERS = 2


def phase_mla_model(ctx):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as MD
    for dname, moe_layers in (("bfloat16", MLA_MOE_LAYERS),
                              ("float32", MLA_F32_MOE_LAYERS)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(MLA_ARCH).replace(groups=mla_cut_groups(moe_layers),
                                           dtype=dname)
        cfg = cfg.replace(moe_capacity_factor=max(
            cfg.moe_capacity_factor, cfg.n_experts / cfg.moe_top_k))
        t0 = time.perf_counter()
        params = MD.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()            # the float32 draws of the init
        n_par = sum(p.numel() for p in params.parameters())
        free, total = torch.cuda.mem_get_info()
        log(f"mla_model: {MLA_ARCH} at full width, {1 + moe_layers} of 60 "
            f"layers (1 dense + {moe_layers} MoE, {cfg.n_experts} experts "
            f"top-{cfg.moe_top_k}, {cfg.n_shared_experts} shared), {n_par} "
            f"params {dname}, init {time.perf_counter() - t0:.1f} s, card "
            f"memory free {free / 2**30:.2f} of {total / 2**30:.2f} GiB")
        tok_gen = torch.Generator(device="cuda").manual_seed(1)
        toks = torch.randint(4, cfg.vocab_size, (4, PROMPT_CAP),
                             generator=tok_gen, device="cuda",
                             dtype=torch.int32)
        paths = {"kernel": cfg.replace(decode_impl="flash_paged"),
                 "plain": cfg.replace(decode_impl="xla")}
        t0 = time.perf_counter()
        caches = kernel_vs_plain(f"mla_model {MLA_ARCH} {dname}", paths,
                                 params, toks, [PROMPT_CAP, 300, 37, 128],
                                 MLA_MODEL_TOL[dname], per_row=True,
                                 moe_impl="ep")
        ctx[f"{MLA_ARCH} {dname} verify err"] = verify_vs_decode(
            f"mla_model {MLA_ARCH} {dname}", paths, params, caches,
            MLA_MODEL_TOL[dname])
        log(f"  {time.perf_counter() - t0:.1f} s, max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del params, caches
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: the served path
# ---------------------------------------------------------------------------

def payloads(arch=ARCH):
    """12 OpenAI-style requests to ``arch`` (more than the 8 slots).  Five share a
    32-word system prompt (two full 16-token blocks); one of those is the
    shared prompt alone, fully cached, so its admission copies a block
    (COW) and prefills a 1-token suffix."""
    shared = " ".join(f"policy{i}" for i in range(32))
    users = ["summarize the incident report for the on call team",
             "translate the release notes into plain english",
             "what is the capital of the country with the longest coast",
             "write a haiku about paged attention",
             "list three risks of speculative decoding in production",
             "explain continuous batching to a new engineer",
             "how many tokens fit in a sixteen token block",
             "draft an apology for the delayed shipment",
             "compare grouped query attention with multi head attention",
             "name two reasons to keep a trash block in a kv pool",
             "give a one line status update", "what changed since yesterday"]
    out = []
    for i, u in enumerate(users):
        if i in (0, 2, 4, 6):
            msgs = [{"role": "system", "content": shared},
                    {"role": "user", "content": u}]
        elif i == 9:
            msgs = [{"role": "system", "content": shared}]
        else:
            msgs = [{"role": "user", "content": u}]
        out.append({"model": arch, "messages": msgs})
    return out


def profiled(fn):
    """Run ``fn`` under torch.profiler (CPU and CUDA activities).  Returns
    (profiler, wall s); the trace is parsed only when ``profile_report``
    reads it, so a caller whose other threads still run can read it after
    they finish (the parse holds the GIL for seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def profile_report(label, prof, wall):
    """Device busy share, the top kernels by device time and the port's
    own kernels (``csrc/*.cu``, in an anonymous namespace) of a
    ``profiled`` run.  The profiler's overhead inflates the wall time, so
    the busy share is a floor; only device-side events are summed (a CPU
    op's device time repeats its kernels').  Returns (wall ms, busy ms)."""
    from torch.autograd import DeviceType
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in events)
    log(f"{label}, wall {wall * 1e3:.1f} ms under the profiler, device busy "
        f"{dev_us / 1e3:.1f} ms ({100 * dev_us / 1e6 / wall:.1f}%)")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    own = [e for e in ranked[8:] if "(anonymous namespace)" in e.key]
    for e in ranked[:8] + own:
        log(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x "
            f"{e.key[:90]}")
    return wall * 1e3, dev_us / 1e3


def profile_run(label, fn):
    """``profile_report`` of ``fn`` run under the profiler."""
    return profile_report(label, *profiled(fn))


def profile_fleet(fleet, prompts, arch=ARCH, max_new=8):
    """``profile_run`` over the fleet serving one batch (8 prompts, one
    per slot, ``max_new`` tokens)."""
    profile_run(f"profile: {len(prompts)} requests x {max_new} tokens",
                lambda: fleet.generate(arch, prompts, max_new=max_new))


def served_batch(label, fleet, arch, kernels, card):
    """The 12 requests through ``batch_call`` with ``kernels`` (name ->
    wrapper) counted from zero just before and read just after.  Logs
    answers, launches, pool (paged members) and latency numbers and checks
    12 answers of 32 tokens and, on a paged member, a clean pool and the
    prefix-hit path.  Returns (launch counts, tokens per request, prompt
    ids per request)."""
    import torch
    call = fleet.call_fn({arch: arch})
    reqs = payloads(arch)
    sched = fleet.schedulers[arch]
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    answers = call.batch_call(None, reqs, [{}] * len(reqs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in kernels.items()}
    # the scheduler's bounded results table holds the finished sequences
    # (the answers' content carries only their first 10 tokens)
    seqs = [sched._finished[r] for r in sorted(sched._finished)][-len(reqs):]
    ntok = [a["usage"]["completion_tokens"] for a in answers]
    ttft = [a["usage"]["vsr_ttft_ms"] for a in answers]
    tpot = [(a["usage"]["vsr_service_ms"] - a["usage"]["vsr_ttft_ms"])
            / max(1, n - 1) for a, n in zip(answers, ntok)]
    cache = "contiguous cache"
    if sched.paged:
        stats = sched.pool.stats
        cache = (f"live_refs {sched.pool.live_refs()}, cached_tokens "
                 f"{stats.cached_tokens}, cow_copies {stats.cow_copies}")
    log(f"{label}: {len(answers)} answers, tokens each {sorted(set(ntok))}, "
        f"launches {json.dumps(counts)}, {cache}, prefill calls "
        f"{sched.prefill.prefills}, decode steps {sched.decode_steps}, "
        f"occupancy {sched.occupancy:.2f}")
    log(f"{label}: wall {wall * 1e3:.1f} ms, decode tokens/s "
        f"{sum(ntok) / wall:.1f}, TTFT ms p50 {statistics.median(ttft):.1f} "
        f"max {max(ttft):.1f}, TPOT ms p50 {statistics.median(tpot):.2f} "
        f"max {max(tpot):.2f} [{card}]")
    check(len(answers) == 12 and all(n == GEN for n in ntok),
          f"{label}: expected 12 answers of {GEN} tokens, got {ntok}")
    check([len(s.out) for s in seqs] == ntok,
          f"{label}: results table out of step with the answers")
    if sched.paged:
        check(sched.pool.live_refs() == 0,
              f"{label}: blocks leaked after drain")
        check(stats.cached_tokens > 0 and stats.cow_copies > 0,
              f"{label}: the prefix-hit suffix prefill / COW copy did not "
              f"run")
    return counts, [list(s.out) for s in seqs], [s.ids for s in seqs]


def prompts_of(arch=ARCH):
    return [" ".join(m["content"] for m in r["messages"])
            for r in payloads(arch)]


def reduced_card_vs_cpu(label, arch, overrides, card_kernels=None,
                        speculative=None, per_round=None, paged="auto"):
    """Small input against the reference path: a reduced float32 fleet with
    the kernels on the card (speculative when ``speculative`` is given)
    vs the plain fleet on the CPU, token for token.  ``card_kernels``
    (name -> wrapper) are counted on the card run; each must launch, and
    ``per_round`` times the speculative rounds when given.  ``paged`` as
    ``LocalFleet``'s (SSM and cross-attention members are contiguous
    under "auto")."""
    from repro_torch.serving.fleet import LocalFleet
    ov = {arch: dict(overrides, dtype="float32")}
    prompts = prompts_of(arch)
    outs, counts = {}, {}
    for dev, spec in (("cuda", speculative), ("cpu", None)):
        small = LocalFleet([arch], batch=4, gen_tokens=8, warmup=False,
                           decode_impl="flash_paged", arch_overrides=ov,
                           speculative=spec, paged=paged, device=dev)
        for fn in (card_kernels or {}).values():
            fn.launches = 0
        outs[dev] = [o["tokens"] for o in small.generate(arch, prompts)]
        sched = small.schedulers[arch]
        if dev == "cuda":
            counts = {n: fn.launches for n, fn in (card_kernels or {}).items()}
            spec_rounds = sched.spec_rounds
        if sched.paged:
            check(sched.pool.live_refs() == 0,
                  f"{label}: reduced fleet leaked")
    same = outs["cuda"] == outs["cpu"]
    what = "speculative " if speculative is not None else \
        "" if sched.paged else "contiguous "
    log(f"{label}: reduced float32 {what}fleet, card kernels vs CPU plain "
        f"path: tokens identical for {len(prompts)} prompts: {same}"
        + (f"; card launches {json.dumps(counts)}, spec rounds "
           f"{spec_rounds}" if counts else ""))
    check(same, f"{label}: reduced fleet tokens differ between card and CPU")
    check(all(v > 0 for v in counts.values()),
          f"{label}: a kernel was not launched on the reduced card fleet: "
          f"{counts}")
    if per_round is not None:
        check(all(v == per_round * spec_rounds for v in counts.values()),
              f"{label}: launches {counts} != {per_round} x {spec_rounds} "
              f"speculative rounds")
    return counts


def serve_fleet(label, arch, overrides, small_overrides, kernels, launches,
                card, per_step=None):
    """The served path for ``arch`` at full width: 12 requests through
    ``batch_call`` (``served_batch``), launches read into ``launches``;
    then the profiler batch, and a reduced float32 fleet on the card
    against the CPU.  ``per_step``: launches each kernel must make per
    decode step.  Returns the served tokens and prompt ids."""
    import torch
    from repro_torch.serving.fleet import LocalFleet
    t0 = time.perf_counter()
    fleet = LocalFleet([arch], reduced=False, batch=BATCH, max_seq=MAX_SEQ,
                       gen_tokens=GEN, decode_impl="flash_paged",
                       arch_overrides={arch: overrides})
    member = fleet.members[arch]
    log(f"{label}: built + warmed up in {time.perf_counter() - t0:.1f} s "
        f"(warmup {member.warmup_ms:.0f} ms), device {fleet.device}, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")
    counts, toks, ids = served_batch(label, fleet, arch, kernels, card)
    launches.update(counts)
    sched = fleet.schedulers[arch]
    check(all(v > 0 for v in counts.values()),
          f"{label}: a kernel was not launched on the main path: {counts}")
    if per_step is not None:
        check(all(v == per_step * sched.decode_steps for v in counts.values()),
              f"{label}: launches {counts} != {per_step} x "
              f"{sched.decode_steps} decode steps")
    profile_fleet(fleet, prompts_of(arch)[:BATCH], arch)
    del fleet, member, sched
    gc.collect()
    torch.cuda.empty_cache()
    reduced_card_vs_cpu(label, arch, small_overrides)
    return toks, ids


def phase_fleet(launches, card, ctx):
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_decode.ops import paged_flash_decode
    ctx["fleet tokens"] = serve_fleet(
        "fleet", ARCH, {"attn_impl": "pallas"}, {"attn_impl": "pallas"},
        {"flash_attention": flash_attention,
         "paged_flash_decode": paged_flash_decode}, launches, card)


def near_tie(label, params, cfg, ids, common, tok_a, tok_b, err):
    """Show a token divergence to be a near-tie: recompute the logits that
    chose between ``tok_a`` and ``tok_b`` (a fresh prefill of the prompt
    plus the common generated prefix, kernel path) and require both tokens
    within twice the measured logit error of the top logit — each path's
    logits may sit ``err`` from this recompute's."""
    import torch
    from repro_torch.models import model as MD
    seq = list(ids) + list(common)
    nblk = -(-len(seq) // BLOCK)
    cache = MD.init_paged_cache(cfg, 1, MAX_SEQ, 1 + nblk, BLOCK,
                                device="cuda")
    tbl = torch.zeros((1, MAX_SEQ // BLOCK), dtype=torch.int32, device="cuda")
    tbl[0, :nblk] = torch.arange(1, nblk + 1, dtype=torch.int32)
    logits, _ = MD.prefill(cfg, params,
                           torch.tensor([seq], dtype=torch.int32,
                                        device="cuda"),
                           cache, moe_impl="ep", tbl=tbl, paged_fresh=True)
    lg = logits[0].float()
    top = lg.max().item()
    off_a, off_b = top - lg[tok_a].item(), top - lg[tok_b].item()
    ok = max(off_a, off_b) <= 2 * err
    log(f"  {label}: divergence at token {len(common)}: {tok_a} vs {tok_b}, "
        f"below the top logit by {off_a:.4e} / {off_b:.4e} (near-tie limit "
        f"2 x {err:.4e}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{label}: divergence at token {len(common)} is not a near-tie")


def phase_spec_fleet(launches, card, ctx):
    """The speculative served path at full width: smollm-360m with an
    aligned smollm-360m draft (k = 4), the same 12 requests."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_decode.ops import (
        paged_flash_decode, paged_flash_verify, paged_flash_verify_mla)
    from repro_torch.serving.fleet import LocalFleet
    from repro_torch.serving.scheduler import SpecConfig
    label = "spec_fleet"
    t0 = time.perf_counter()
    fleet = LocalFleet([ARCH], reduced=False, batch=BATCH, max_seq=MAX_SEQ,
                       gen_tokens=GEN, decode_impl="flash_paged",
                       arch_overrides={ARCH: {"attn_impl": "pallas"}},
                       speculative=SpecConfig(ARCH, k=W_SPEC - 1))
    member = fleet.members[ARCH]
    sched = fleet.schedulers[ARCH]
    log(f"{label}: target {ARCH} + draft {sched.drafter.rt.cfg.name} "
        f"({sched.drafter.rt.cfg.dtype}, decode_impl "
        f"{sched.drafter.rt.cfg.decode_impl}), k = {W_SPEC - 1}, built + "
        f"warmed up in {time.perf_counter() - t0:.1f} s (warmup "
        f"{member.warmup_ms:.0f} ms), max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    kernels = {"flash_attention": flash_attention,
               "paged_flash_decode": paged_flash_decode,
               "paged_flash_verify": paged_flash_verify}
    counts, toks, ids = served_batch(label, fleet, ARCH, kernels, card)
    launches["paged_flash_verify"] = counts["paged_flash_verify"]
    layers = len(member.params.blocks)
    plain_steps = sched.decode_steps - sched.spec_rounds
    acc = sched.spec_accepted / max(1, sched.spec_offered)
    log(f"{label}: spec rounds {sched.spec_rounds}, plain steps "
        f"{plain_steps}, offered {sched.spec_offered}, accepted "
        f"{sched.spec_accepted} (acceptance {acc:.3f}), emitted "
        f"{sched.spec_emitted}, spec_tokens_per_round "
        f"{sched.spec_tokens_per_round:.2f} (over {BATCH} slots), draft "
        f"catch-up prefills {sched.drafter.catchup_prefills}")
    check(counts["flash_attention"] > 0 and sched.spec_rounds > 0,
          f"{label}: prefill kernel or speculation did not run: {counts}")
    check(counts["paged_flash_verify"] == layers * sched.spec_rounds,
          f"{label}: verify launches {counts['paged_flash_verify']} != "
          f"{layers} x {sched.spec_rounds} speculative rounds")
    check(counts["paged_flash_decode"] == layers * plain_steps,
          f"{label}: decode launches {counts['paged_flash_decode']} != "
          f"{layers} x {plain_steps} plain steps")
    # speculative == plain: compare with the fleet phase's tokens
    if "fleet tokens" in ctx:
        plain_toks, plain_ids = ctx["fleet tokens"]
        check([list(i) for i in ids] == [list(i) for i in plain_ids],
              f"{label}: prompts differ from the fleet phase's")
        same = sum(a == b for a, b in zip(toks, plain_toks))
        log(f"{label}: tokens identical to the plain fleet's for {same}/"
            f"{len(toks)} requests")
        err = ctx.get(f"{ARCH} bfloat16 verify err", MODEL_TOL["bfloat16"])
        for i, (a, b) in enumerate(zip(plain_toks, toks)):
            if a != b:
                j = next(n for n, (x, y) in enumerate(zip(a, b)) if x != y)
                near_tie(f"{label} request {i}", member.params, member.cfg,
                         ids[i], a[:j], a[j], b[j], err)
        ctx["spec divergences"] = len(toks) - same
    profile_fleet(fleet, prompts_of(ARCH)[:BATCH], ARCH)
    del fleet, member, sched
    gc.collect()
    torch.cuda.empty_cache()
    reduced_card_vs_cpu(label, ARCH, {"attn_impl": "pallas"},
                        {"paged_flash_verify": paged_flash_verify},
                        speculative=SpecConfig(ARCH, k=W_SPEC - 1),
                        per_round=2)
    launches["paged_flash_verify_mla"] = reduced_card_vs_cpu(
        label, MLA_ARCH, {}, {"paged_flash_verify_mla": paged_flash_verify_mla},
        speculative=SpecConfig(MLA_ARCH, k=W_SPEC - 1),
        per_round=3)["paged_flash_verify_mla"]


# ---------------------------------------------------------------------------
# phase 6: the learned-signal path (encoder + decision gate)
# ---------------------------------------------------------------------------

# one signal of each learned type (``tests/test_signal_plan.py``'s
# ENGINE_CFG plus user_feedback, keyword and embedding)
SIGNALS_CFG = {
    "domain": {"d": {"mmlu_categories": ["math"]}},
    "fact_check": {"f": {"threshold": 0.5}},
    "modality": {"m": {"modalities": ["diffusion"]}},
    "jailbreak": {"j": {"method": "classifier", "threshold": 0.5}},
    "pii": {"p": {"pii_types_allowed": []}},
    "user_feedback": {"u": {"categories": ["dissatisfied"]}},
    "keyword": {"k": {"keywords": ["incident", "risks", "urgent"]}},
    "embedding": {"e": {"reference_texts": ["explain how attention works",
                                            "write a short poem"],
                        "threshold": 0.3}},
}
# fused (kernel 6) vs one forward per task: float32 with TF32 off, so the
# probabilities differ by summation order only
SIG_TOL = 1e-4
GATE_TOL = 1e-6


def signal_requests():
    """16 requests over 12 distinct latest-user texts: the fleet phases'
    12 prompts, then 4 of them again."""
    from repro_torch.core.types import Message, Request
    texts = prompts_of(ARCH)
    texts = texts + [texts[i] for i in (0, 3, 6, 9)]
    return [Request(messages=[Message("user", t)]) for t in texts]


def signal_decisions():
    """A small hand-written decision set over SIGNALS_CFG's signals."""
    from repro_torch.core.decision import and_, leaf, not_, or_
    from repro_torch.core.types import Decision, ModelRef
    return [
        Decision("guard", or_(leaf("jailbreak", "j"), leaf("pii", "p")),
                 [ModelRef("guard")], priority=100),
        Decision("math", and_(leaf("domain", "d"), not_(leaf("modality",
                                                              "m"))),
                 [ModelRef("big")], priority=10),
        Decision("image", and_(leaf("modality", "m"),
                               not_(leaf("user_feedback", "u"))),
                 [ModelRef("sd")], priority=10),
        Decision("facts", or_(leaf("fact_check", "f"), leaf("keyword", "k"),
                              leaf("embedding", "e")),
                 [ModelRef("small")], priority=5),
        Decision("default", not_(leaf("jailbreak", "j")),
                 [ModelRef("small")], priority=0),
    ]


def encoder_weights(cfg, device, seed):
    """Random float32 encoder weights and adapters for every task from a
    seeded generator on ``device``, with B drawn N(0, 0.02): the init's
    zeros would make the LoRA delta, and kernel 6's output, vanish."""
    import torch
    from repro_torch.classifiers.encoder import init_adapters, init_encoder
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_encoder(cfg, gen, device)
    adapters = init_adapters(cfg, gen, device)
    for ad in adapters.values():
        for k in ("b_q", "b_v"):
            ad[k].normal_(0.0, 0.02, generator=gen)
    return params, adapters


def _signal_key(m):
    return (m.matched, m.confidence, repr(m.detail))


def check_gate(results):
    """The decision gate on the card over the batch's (match, conf)
    matrices (``SignalResult.as_vector`` in the gate's key order) against
    ``DecisionEngine.evaluate`` per request, crisp/priority and
    fuzzy/confidence."""
    from repro_torch.core.decision import DecisionEngine, build_decision_gate
    from repro_torch.core.types import SignalKey
    decs = signal_decisions()
    names = [d.name for d in decs]
    for fuzzy, strategy in ((False, "priority"), (True, "confidence")):
        gate, keys = build_decision_gate(decs, strategy, fuzzy,
                                         device="cuda")
        skeys = [SignalKey(*k.split(":")) for k in keys]
        vecs = [r.as_vector(skeys) for r in results]
        idx, conf, _, _ = gate([v[0] for v in vecs], [v[1] for v in vecs])
        idx, conf = idx.tolist(), conf.tolist()
        eng = DecisionEngine(decs, strategy, fuzzy)
        want = [eng.evaluate(r) for r in results]
        widx = [-1 if e.decision is None else names.index(e.decision.name)
                for e in want]
        cerr = max(abs(c - e.confidence) for c, e in zip(conf, want))
        ok = idx == widx and cerr <= GATE_TOL
        log(f"signals: decision gate on the card ({len(keys)} keys, "
            f"{len(decs)} decisions, fuzzy={fuzzy}, {strategy}) vs "
            f"DecisionEngine per request: decisions "
            f"{[names[i] if i >= 0 else None for i in idx]}, max |conf "
            f"diff| {cerr:.3e} (limit {GATE_TOL}) {'ok' if ok else 'FAIL'}")
        check(ok, f"signals: gate {idx} != engine {widx} or conf {cerr}")


def check_fused_vs_single(encoder, texts):
    """classify_all with batched=True (kernel 6) vs batched=False (one
    single-task forward per task, no kernel): probabilities within
    SIG_TOL, labels equal except at a near-tie (top-2 probability gap
    below the measured error).  Returns the max error."""
    import numpy as np
    import torch
    fused = encoder.classify_all(SEQ_TASKS, texts)
    encoder.batched = False
    try:
        single = encoder.classify_all(SEQ_TASKS, texts)
    finally:
        encoder.batched = True
    torch.cuda.synchronize()
    err = max(float(np.abs(fused[t][1] - single[t][1]).max())
              for t in SEQ_TASKS)
    ties = 0
    for t in SEQ_TASKS:
        for i, (a, b) in enumerate(zip(fused[t][0], single[t][0])):
            if a != b:
                top2 = np.sort(single[t][1][i])[-2:]
                gap = float(top2[1] - top2[0])
                log(f"  {t} text {i}: fused {a} vs single {b}, top-2 "
                    f"probability gap {gap:.3e} vs error {err:.3e}")
                check(gap < err, f"signals: {t} text {i} label differs "
                      f"and is not a near-tie")
                ties += 1
    log(f"signals: fused classify_all (kernel 6) vs one forward per task: "
        f"max |prob diff| {err:.3e} (limit {SIG_TOL}), labels differ at "
        f"{ties} near-ties of {len(SEQ_TASKS) * len(texts)}")
    check(err <= SIG_TOL, f"signals: fused vs single prob diff {err}")
    return err


def reduced_encoder_card_vs_cpu(texts):
    """A reduced float32 encoder (``EncoderBackend.small``'s widths,
    nonzero B, weights drawn on the CPU) on the card (kernel 6) and on the
    CPU (its plain version): labels identical, probabilities within 1e-5."""
    import numpy as np
    from repro_torch.classifiers.encoder import SMALL
    from repro_torch.kernels.multi_lora.ops import multi_lora
    params, adapters = encoder_weights(SMALL, "cpu", 5)
    out = {}
    for dev in ("cuda", "cpu"):
        be = encoder_on(SMALL, params, adapters, dev, SEQ_TASKS)
        before = multi_lora.launches
        out[dev] = be.classify_all(SEQ_TASKS, texts)
        if dev == "cuda":
            launched = multi_lora.launches - before
    same = all(out["cuda"][t][0] == out["cpu"][t][0] for t in SEQ_TASKS)
    err = max(float(np.abs(out["cuda"][t][1] - out["cpu"][t][1]).max())
              for t in SEQ_TASKS)
    ok = same and err <= 1e-5 and launched == 2 * SMALL.n_layers
    log(f"signals: reduced float32 encoder ({SMALL.n_layers} layers, d "
        f"{SMALL.d_model}) card (kernel 6, {launched} launches) vs CPU plain "
        f"path: labels identical {same}, max |prob diff| {err:.3e} (limit "
        f"1e-5) {'ok' if ok else 'FAIL'}")
    check(ok, f"signals: reduced encoder card vs CPU: same={same} err={err} "
          f"launches={launched}")


def phase_signals(launches, card, ctx):
    """The learned-signal path at full width: SignalEngine -> SignalPlan
    -> EncoderBackend (kernel 6 on q and v of every layer) -> the decision
    gate on the card."""
    import dataclasses
    import torch
    from repro_torch.classifiers.backend import HashBackend
    from repro_torch.classifiers.encoder import (MODERNBERT_BASE_32K,
                                                 EncoderBackend)
    from repro_torch.core.signals import SignalEngine, SignalPlan
    from repro_torch.kernels.multi_lora.ops import multi_lora
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(MODERNBERT_BASE_32K, max_len=ENC_MAX_LEN)
    t0 = time.perf_counter()
    params, adapters = encoder_weights(cfg, "cuda", 0)
    encoder = EncoderBackend(cfg, params, adapters,
                             trained=set(SEQ_TASKS) | {"pii"})
    n_base = sum(v.numel() for k, v in params.items() if k != "layers") + \
        sum(v.numel() for lp in params["layers"] for v in lp.values())
    n_ad = sum(v.numel() for a in adapters.values() for v in a.values())
    log(f"signals: encoder at ModernBERT-base widths ({cfg.n_layers} layers, "
        f"d {cfg.d_model}, {cfg.n_heads} heads, d_ff {cfg.d_ff}, LoRA rank "
        f"{cfg.lora_rank}, vocab {cfg.vocab}, max_len {cfg.max_len} of "
        f"32768), float32, {n_base} base + {n_ad} adapter params, built in "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = signal_requests()
    texts = [r.latest_user_text for r in reqs]
    distinct = list(dict.fromkeys(texts))
    check(len(reqs) == 16 and len(distinct) == N_TEXTS,
          f"signals: {len(reqs)} requests over {len(distinct)} texts")
    engine = SignalEngine(SIGNALS_CFG, backend=HashBackend(),
                          classifier=encoder)
    try:
        engine.extract_many(reqs)                       # warm-up
        torch.cuda.synchronize()
        # the main path: counts zeroed just before, read just after
        wrappers = kernel_wrappers()
        for fn in wrappers.values():
            fn.launches = 0
        plan = SignalPlan(encoder)
        t0 = time.perf_counter()
        results = engine.extract_many(reqs, plan=plan)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = {n: fn.launches for n, fn in wrappers.items()}
        n_lora = counts["multi_lora"]
        launches["multi_lora"] = n_lora
        ctx["signals requests"] = len(reqs)
        log(f"signals: extract_many over {len(reqs)} requests "
            f"({len(distinct)} distinct texts): {wall:.1f} ms, classify_all "
            f"calls {plan.classify_calls}, token_classify calls "
            f"{plan.token_calls}, launches {json.dumps(counts)} [{card}]")
        check(plan.classify_calls == 1 and plan.token_calls == 1,
              f"signals: {plan.classify_calls} classify_all and "
              f"{plan.token_calls} token_classify calls, expected 1 and 1")
        check(n_lora == 2 * cfg.n_layers * plan.classify_calls,
              f"signals: kernel 6 launched {n_lora} times, expected 2 x "
              f"{cfg.n_layers} x {plan.classify_calls}")
        check(all(len(r.matches) == len(SIGNALS_CFG) for r in results),
              "signals: a request is missing signals")
        for i, t in enumerate(texts):
            j = texts.index(t)
            if j != i:
                same = {k: _signal_key(m) for k, m in
                        results[i].matches.items()} == \
                    {k: _signal_key(m) for k, m in results[j].matches.items()}
                check(same, f"signals: requests {j} and {i} share a text "
                      f"but not their signals")
        log("signals: repeated texts give identical SignalResults: True; "
            "matched per request: " + " ".join(
                str(sum(m.matched for m in r.matches.values()))
                for r in results))
        for r in results:
            for m in r.matches.values():
                check(math.isfinite(m.confidence),
                      f"signals: non-finite confidence {m.key}")
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            engine.extract_many(reqs)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(walls)
        log(f"signals: extract_many wall ms per batch median of 5 "
            f"{med:.2f} (runs {' '.join(f'{w:.2f}' for w in walls)}), per "
            f"request {med / len(reqs):.3f} [{card}]")
        ctx["signals wall ms"] = med
        profile_run(f"signals profile: extract_many over {len(reqs)} "
                    f"requests", lambda: engine.extract_many(reqs))
        check_fused_vs_single(encoder, distinct)
        check_gate(results)
    finally:
        engine.close()
    del engine, encoder, params, adapters
    gc.collect()
    torch.cuda.empty_cache()
    reduced_encoder_card_vs_cpu(distinct)
    # the comparison launches above are not main-path launches
    multi_lora.launches = n_lora


def kernel_wrappers():
    """name -> wrapper of every kernel of the port (each counts its
    ``launches``)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_decode.ops import (
        paged_flash_decode, paged_flash_decode_mla, paged_flash_verify,
        paged_flash_verify_mla)
    from repro_torch.kernels.multi_lora.ops import multi_lora
    return {"flash_attention": flash_attention,
            "paged_flash_decode": paged_flash_decode,
            "paged_flash_verify": paged_flash_verify,
            "paged_flash_decode_mla": paged_flash_decode_mla,
            "paged_flash_verify_mla": paged_flash_verify_mla,
            "multi_lora": multi_lora}


def phase_mla_fleet(launches, card):
    import torch
    from repro_torch.kernels.flash_decode.ops import paged_flash_decode_mla
    torch.cuda.reset_peak_memory_stats()
    serve_fleet("mla_fleet", MLA_ARCH, {"groups": mla_cut_groups()}, {},
                {"paged_flash_decode_mla": paged_flash_decode_mla}, launches,
                card, per_step=MLA_LAYERS)


# ---------------------------------------------------------------------------
# phase 9: contig — the contiguous cache and the SSM members
# ---------------------------------------------------------------------------

JAMBA = "jamba-v0.1-52b"
XLSTM = "xlstm-350m"
# payloads() indices whose prompt opens with the shared system prompt: a
# paged fleet prefills their suffix over the gathered view, a contiguous
# one the whole prompt, so only these may differ (by a near-tie)
SHARED_PAYLOADS = (0, 2, 4, 6, 9)


def cut_groups(arch, layers):
    """``arch``'s layer groups cut to its first ``layers`` layers in whole
    periods, every width kept (``launch.train.cut_depth``): jamba-v0.1-52b
    to one period of its four (8 of 32 layers: attention at index 4,
    mamba elsewhere, the 16-expert MoE FFN on the odd indices; ~13.3 B
    parameters), xlstm-350m to one mLSTM + sLSTM period (2 of 24),
    llama-3.2-vision-90b to one period of its 20 (5 of 100: 4
    self-attention + 1 cross-attention over 1600 patches; ~6.4 B)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import cut_depth
    return cut_depth(get_config(arch), layers).groups


def unsharded_tokens(m, toks, ids, n, crosses=None):
    """What ``shard_mixers`` holds a sharded member's tokens against: the
    unsharded member ``m``'s tokens and prompt ids of its first ``n``
    requests, its own bf16 logit error over them (``bf16_logit_error``,
    ``crosses`` the requests' cross-attention contexts), and the
    teacher-forced sequences (prompt and tokens but the last) with their
    float32 logits from the prompt's last position on.  Converts
    ``m.params`` to float32 in place."""
    seqs = [list(i) + list(w[:-1]) for i, w in zip(ids[:n], toks[:n])]
    starts, high = [len(i) - 1 for i in ids[:n]], []
    e32 = bf16_logit_error(m.cfg, m.params, seqs, starts, crosses, high)
    return {"tokens": toks[:n], "ids": ids[:n], "e32": e32, "seqs": seqs,
            "starts": starts, "logits32": high}


def contig_fleet(label, arch, overrides, kernels, card, profile=(BATCH, 8),
                 **kw):
    """One full-width fleet of ``arch`` (``kw`` to ``LocalFleet``): the 12
    requests through ``served_batch``, then the profiler batch
    (``profile`` = (requests, tokens); None skips it: the profiler's
    processing grows with the events, ~100 s for xlstm's 8 x 8) and the
    peak memory since the build.  Returns (launch counts, tokens, prompt
    ids, member)."""
    import torch
    from repro_torch.serving.fleet import LocalFleet
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fleet = LocalFleet([arch], reduced=False, batch=BATCH, max_seq=MAX_SEQ,
                       gen_tokens=GEN, arch_overrides={arch: overrides}, **kw)
    m = fleet.members[arch]
    n_params = sum(p.numel() for p in m.params.parameters())
    log(f"{label}: {len(m.params.blocks)} layers, {n_params / 1e9:.3f} B "
        f"parameters, {'paged' if m.paged else 'contiguous'} cache, "
        f"decode_impl {m.cfg.decode_impl}, attn_impl {m.cfg.attn_impl}, "
        f"exact prefill {m.exact_prefill}; built + warmed up in "
        f"{time.perf_counter() - t0:.1f} s (warmup {m.warmup_ms:.0f} ms)")
    counts, toks, ids = served_batch(label, fleet, arch, kernels, card)
    if profile is not None:
        n, new = profile
        profile_run(f"{label}: profile: {n} requests x {new} tokens",
                    lambda: fleet.generate(arch, prompts_of(arch)[:n],
                                           max_new=new))
    log(f"{label}: max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    return counts, toks, ids, m


def phase_contig(card, ctx):
    """The contiguous cache at full width: smollm-360m on ``paged=False``
    against ``paged=True`` (``xla`` and ``flash_paged`` decode) on the same
    12 requests; xlstm-350m at full width cut to one period (2 of 24
    layers); jamba cut to one period; then reduced float32 contiguous
    smollm, jamba and xlstm fleets on the card against the CPU.  The
    xlstm and jamba tokens of the requests ``shard_mixers`` serves, with
    their bf16 logit error, go to ``ctx["mixers"]``."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_decode.ops import paged_flash_decode
    label = "contig"
    t_phase = time.perf_counter()
    kernels = {"flash_attention": flash_attention,
               "paged_flash_decode": paged_flash_decode}
    runs, base = {}, None
    for name, kw in (("contiguous", dict(paged=False)),
                     ("paged xla", dict(paged=True, decode_impl="xla")),
                     ("paged flash_paged",
                      dict(paged=True, decode_impl="flash_paged"))):
        # the paged fleets were profiled in the fleet phase
        counts, toks, ids, m = contig_fleet(
            f"{label} {ARCH} {name}", ARCH, {"attn_impl": "pallas"},
            kernels, card, profile=(BATCH, 8) if name == "contiguous"
            else None, **kw)
        runs[name] = (toks, ids)
        layers = len(m.params.blocks)
        if name == "contiguous":
            base = m            # its weights recompute any divergence
            check(counts["flash_attention"] == layers * 12 and
                  counts["paged_flash_decode"] == 0,
                  f"{label}: contiguous launches {counts} != {layers} "
                  f"layers x 12 prefills of kernel 1 and no kernel 2")
            ctx["contig launches"] = counts
        check((counts["paged_flash_decode"] > 0) ==
              (name == "paged flash_paged"),
              f"{label} {name}: kernel 2 launches {counts}")
        del m
        gc.collect()
        torch.cuda.empty_cache()
    base_toks, base_ids = runs["contiguous"]
    err = ctx.get(f"{ARCH} bfloat16 verify err", MODEL_TOL["bfloat16"])
    for name in ("paged xla", "paged flash_paged"):
        toks, ids = runs[name]
        check([list(i) for i in ids] == [list(i) for i in base_ids],
              f"{label}: prompts differ between the fleets")
        same = [a == b for a, b in zip(base_toks, toks)]
        log(f"{label}: {ARCH} contiguous vs {name}: tokens identical for "
            f"{sum(same)}/{len(same)} requests (without a shared prefix: "
            f"{sum(s for i, s in enumerate(same) if i not in SHARED_PAYLOADS)}"
            f"/{len(same) - len(SHARED_PAYLOADS)})")
        for i, (a, b) in enumerate(zip(base_toks, toks)):
            if a == b:
                continue
            check(name != "paged xla" or i in SHARED_PAYLOADS,
                  f"{label}: request {i} has no shared prefix, yet its "
                  f"tokens differ between the contiguous and the paged xla "
                  f"fleet (paged == contiguous must hold bitwise there)")
            j = next(n for n, (x, y) in enumerate(zip(a, b)) if x != y)
            near_tie(f"{label} {name} request {i}", base.params, base.cfg,
                     ids[i], a[:j], a[j], b[j], err)
    del base
    gc.collect()
    torch.cuda.empty_cache()
    marks = {"smollm": time.perf_counter()}
    counts, toks, ids, m = contig_fleet(
        f"{label} {XLSTM}", XLSTM, {"groups": cut_groups(XLSTM, 2)}, kernels,
        card, profile=(2, 4))
    check(not any(counts.values()), f"{label}: xlstm launched {counts}")
    mixers = ctx.setdefault("mixers", {})
    mixers[XLSTM] = unsharded_tokens(m, toks, ids, MIX_REQUESTS[XLSTM])
    del m
    gc.collect()
    torch.cuda.empty_cache()
    marks["xlstm"] = time.perf_counter()
    counts, toks, ids, m = contig_fleet(
        f"{label} {JAMBA}", JAMBA,
        {"groups": cut_groups(JAMBA, 8), "attn_impl": "pallas"}, kernels,
        card)
    check(counts["flash_attention"] == 12 and
          counts["paged_flash_decode"] == 0,
          f"{label}: jamba launches {counts} != one attention layer x 12 "
          f"exact-width prefills of kernel 1")
    ctx["jamba launches"] = counts["flash_attention"]
    ctx["jamba widths"] = sorted({len(i) for i in ids})
    mixers[JAMBA] = unsharded_tokens(m, toks, ids, MIX_REQUESTS[JAMBA])
    del m
    gc.collect()
    torch.cuda.empty_cache()
    marks["jamba"] = time.perf_counter()
    reduced_card_vs_cpu(f"{label} {ARCH}", ARCH, {"attn_impl": "pallas"},
                        {"flash_attention": flash_attention}, paged=False)
    reduced_card_vs_cpu(f"{label} {JAMBA}", JAMBA, {"attn_impl": "pallas"},
                        {"flash_attention": flash_attention})
    reduced_card_vs_cpu(f"{label} {XLSTM}", XLSTM, {})
    marks["reduced"] = time.perf_counter()
    prev, secs = t_phase, {}
    for k, t in marks.items():
        secs[k] = round(t - prev, 1)
        prev = t
    log(f"{label}: phase {time.perf_counter() - t_phase:.1f} s, seconds per "
        f"part {json.dumps(secs)}")


# ---------------------------------------------------------------------------
# phase 10: the router — route_batch over four full-width members
# ---------------------------------------------------------------------------

ROUTER_TENANTS = ("cost", "privacy")
ROUTER_POLICIES = ("default",) + ROUTER_TENANTS
ROUTER_BATCHES = 3
ROUTER_ENCODER = "chip-smoke-encoder"
# the encoder serves the jailbreak signal: one fused classify_all per
# batch, kernel 6 on q and v of every layer; domain and PII stay on the
# hash tier.  Its weights are random (seed 0) and no adapter is trained, so
# its head is zero: the uniform prior, which calls every prompt benign.
# A random head (or random domain and PII heads) routes by noise, not by
# the prompt, and can starve a member of traffic.
ROUTER_TASKS = ("jailbreak",)
ROUTER_KERNELS = ("flash_attention", "paged_flash_decode",
                  "paged_flash_decode_mla", "multi_lora")


def router_requests(n, start=0):
    """``serve.py``'s demo requests cycled from ``start``: ``user{i % 3}``,
    ``metadata["policy"]`` cycling default / cost / privacy."""
    from repro_torch.core.types import Message, Request
    from repro_torch.launch.serve import DEMO_REQUESTS
    out = []
    for i in range(start, start + n):
        r = Request(messages=[Message("user", DEMO_REQUESTS[
            i % len(DEMO_REQUESTS)])], user=f"user{i % 3}")
        r.metadata["policy"] = ROUTER_POLICIES[i % len(ROUTER_POLICIES)]
        out.append(r)
    return out


def encoder_on(cfg, params, adapters, dev, trained):
    """An EncoderBackend over ``params`` and ``adapters`` moved to
    ``dev``."""
    from repro_torch.classifiers.encoder import EncoderBackend
    move = {"layers": [{k: v.to(dev) for k, v in lp.items()}
                       for lp in params["layers"]]}
    move.update({k: v.to(dev) for k, v in params.items() if k != "layers"})
    ad = {t: {k: v.to(dev) for k, v in a.items()}
          for t, a in adapters.items()}
    return EncoderBackend(cfg, move, ad, trained=set(trained))


def router_encoder_weights(cfg, device, seed):
    """``encoder_weights`` with the heads of ROUTER_TASKS zeroed."""
    params, adapters = encoder_weights(cfg, device, seed)
    for task in ROUTER_TASKS:
        adapters[task]["head"].zero_()
    return params, adapters


def build_demo_router(name, encoder, **kw):
    """``serve.build_router`` with ``encoder`` registered as its
    classifier backend, the default policy held to ``lint="strict"`` as
    ``serve.py`` does, and the cost and privacy tenants added."""
    from repro_torch.analysis import verify_config
    from repro_torch.classifiers.backend import register_backend
    from repro_torch.launch import serve
    register_backend(name, encoder)
    router, fleet = serve.build_router(classifier_backend=name, **kw)
    router.policies.lint = "strict"
    fatal = [d for d in verify_config(router.policies.get().config)
             if d.fatal]
    check(not fatal, f"router: default policy fails L4: {fatal}")
    for pol in ROUTER_TENANTS:
        with open(os.path.join(ROOT, "examples", "policies",
                               f"{pol}.vsr")) as f:
            router.add_policy(pol, f.read())
    return router, fleet


def stage_ms(pairs):
    """Milliseconds per pipeline stage of one route_batch: the
    ``stage:*`` spans of each policy sub-batch (every request of a
    sub-batch carries its sub-batch's spans), summed over sub-batches."""
    seen, out = set(), {}
    for req_policy, (_, o) in pairs:
        if req_policy in seen:
            continue
        seen.add(req_policy)
        for s in o.trace:
            if s["span"].startswith("stage:"):
                name = s["span"][len("stage:"):]
                out[name] = out.get(name, 0.0) + s["ms"]
    return out


def subbatch_states(router, reqs, pairs, snapshot):
    """policy -> (latency observations, cache entries) as that policy's
    sub-batch of a ``route_batch`` found them.  ``route_batch`` runs its
    sub-batches one after another, in the order their policies first
    appear; each starts from ``snapshot`` (the batch's starting state)
    plus what the sub-batches before it recorded: the service time of
    every answer it dispatched (``stage_wrap``'s ``observe_latency``) and
    the cache entries its requests' texts began."""
    import copy
    lat, entries = copy.deepcopy(snapshot[0]), list(snapshot[1])
    added = router.cache.entries[len(entries):]
    states = {}
    for pol in dict.fromkeys(r.metadata["policy"] for r in reqs):
        states[pol] = (copy.deepcopy(lat), list(entries))
        texts = set()
        for r, (resp, o) in zip(reqs, pairs):
            if r.metadata["policy"] != pol:
                continue
            texts.add(r.latest_user_text)
            if o.fast_response is None:
                lat.setdefault(o.model, []).append(
                    float(resp.usage["vsr_service_ms"]))
        entries += [e for e in added if e.key_text in texts]
    return states


def oracle_replay(router, fresh, pairs, states):
    """Each request of a batch through ``router.route()`` (a batch of one:
    the sequential engine, no gate) from the state its policy's sub-batch
    started from (``states``: the selector's latency observations and the
    semantic cache, from ``subbatch_states``), on the echo transport: the
    decision and model are fixed before dispatch.  ``fresh`` are unrouted
    copies of the batch's requests.  Returns the mismatches."""
    import copy
    sel, cache = router.selection_ctx, router.cache
    after = (sel.latency, cache.entries, cache.hits, cache.lookups)
    call_fn = router.call_fn
    router.call_fn = router._echo_call
    bad = []
    try:
        for r, (_, o) in zip(fresh, pairs):
            lat, entries = states[r.metadata["policy"]]
            sel.latency = copy.deepcopy(lat)
            cache.entries = list(entries)
            _, o2 = router.route(r)
            if (o2.decision, o2.model) != (o.decision, o.model):
                bad.append((r.latest_user_text[:30], r.metadata["policy"],
                            (o.decision, o.model), (o2.decision, o2.model)))
    finally:
        router.call_fn = call_fn
        sel.latency, cache.entries, cache.hits, cache.lookups = after
    return bad


def check_routed_batch(label, router, fleet, reqs, pairs, before):
    """The checks of one routed batch: non-error responses, the gate ==
    each program's engine per request, one gate call per policy
    sub-batch, fast responses never reaching the fleet (members' calls,
    prompts and tokens), ``live_refs() == 0`` on every member.  Returns
    the served (not fast) outcomes' arch counts."""
    gate_before, members_before = before
    check(all(r.finish_reason != "error" for r, _ in pairs),
          f"{label}: error responses "
          f"{[r.content for r, _ in pairs if r.finish_reason == 'error']}")
    sizes = {}
    for r, (_, o) in zip(reqs, pairs):
        prog = router.policies.resolve(r)
        sizes[prog.name] = sizes.get(prog.name, 0) + 1
        res = prog.engine.evaluate(o.signals)
        want = res.decision.name if res.decision else None
        check(o.decision == want and abs(o.confidence - res.confidence)
              <= GATE_TOL, f"{label}: gate {o.decision} {o.confidence} != "
              f"engine {want} {res.confidence} ({prog.name})")
    for name, n in sizes.items():
        calls = router.policies.get(name).gate_calls - gate_before[name]
        check(calls == (1 if n > 1 else 0),
              f"{label}: policy {name} made {calls} gate calls for a "
              f"sub-batch of {n}")
    m2a = {m: p.arch for pol in ROUTER_POLICIES
           for m, p in router.policies.get(pol).config.model_profiles.items()}
    served = {}
    for r, o in pairs:
        if o.fast_response is None:
            served[m2a[o.model]] = served.get(m2a[o.model], 0) + 1
            check(r.usage.get("completion_tokens") == GEN,
                  f"{label}: {o.model} answered {r.usage}")
    for arch, m in fleet.members.items():
        calls0, prompts0, tokens0 = members_before[arch]
        n = served.get(arch, 0)
        check(m.prompts_in - prompts0 == n and m.tokens_out - tokens0 ==
              GEN * n and (m.calls > calls0) == (n > 0),
              f"{label}: {arch} took {m.prompts_in - prompts0} prompts, "
              f"{m.tokens_out - tokens0} tokens, {m.calls - calls0} calls "
              f"for {n} served requests")
        refs = fleet.schedulers[arch].pool.live_refs()
        check(refs == 0, f"{label}: {arch} holds {refs} block refs")
    return served


def route_and_check(label, router, fleet, start):
    """One ``route_batch`` of the 8 requests ``router_requests`` makes
    from ``start``, timed (synchronised), checked by
    ``check_routed_batch`` and replayed through ``route()``.  Returns
    (pairs, wall ms, stage ms, served arch counts)."""
    import copy

    import torch
    reqs = router_requests(BATCH, start)
    gate_before = {n: router.policies.get(n).gate_calls
                   for n in ROUTER_POLICIES}
    members_before = {a: (m.calls, m.prompts_in, m.tokens_out)
                      for a, m in fleet.members.items()}
    snapshot = (copy.deepcopy(router.selection_ctx.latency),
                list(router.cache.entries))
    sync = torch.cuda.synchronize if fleet.device.type == "cuda" else \
        (lambda: None)
    sync()
    t0 = time.perf_counter()
    pairs = router.route_batch(reqs)
    sync()
    wall = (time.perf_counter() - t0) * 1e3
    served = check_routed_batch(label, router, fleet, reqs, pairs,
                                (gate_before, members_before))
    wrappers = kernel_wrappers()
    saved = {n: fn.launches for n, fn in wrappers.items()}
    bad = oracle_replay(router, router_requests(BATCH, start), pairs,
                        subbatch_states(router, reqs, pairs, snapshot))
    for n, fn in wrappers.items():           # replays are not main path
        fn.launches = saved[n]
    check(not bad, f"{label}: route_batch != route(): {bad}")
    stages = stage_ms([(r.metadata["policy"], p)
                       for r, p in zip(reqs, pairs)])
    return pairs, wall, stages, served


def reduced_router_card_vs_cpu(label):
    """The demo router over the four reduced members at float32, with a
    reduced encoder (``SMALL`` widths, weights drawn on the CPU, the same
    tasks) as classifier, on the card and on the CPU: the 24 requests in
    batches of 8 give equal decisions, models and contents (every token of
    the 8 a request generates).  Card launches of the path's kernels are
    not main-path launches and are restored."""
    from repro_torch.classifiers.encoder import SMALL
    wrappers = kernel_wrappers()
    saved = {n: fn.launches for n, fn in wrappers.items()}
    params, adapters = router_encoder_weights(SMALL, "cpu", 5)
    outs, counts = {}, {}
    for dev in ("cuda", "cpu"):
        for fn in wrappers.values():
            fn.launches = 0
        router, fleet = build_demo_router(
            f"{ROUTER_ENCODER}-small-{dev}",
            encoder_on(SMALL, params, adapters, dev, ROUTER_TASKS),
            reduced=True, dtype="float32", gen_tokens=8, batch=4,
            device=dev, warmup=False)
        # the latency selector would read each device's measured service
        # times: neither router records them, so both select from the
        # profiles alone
        router.selection_ctx.observe_latency = lambda model, ms: None
        try:
            reqs = router_requests(len(ROUTER_POLICIES) * 8)
            pairs = []
            for s in range(0, len(reqs), 8):
                pairs += router.route_batch(reqs[s:s + 8])
        finally:
            router.close()
        outs[dev] = [(o.decision, o.model, r.content, r.finish_reason)
                     for r, o in pairs]
        check(all(s.pool.live_refs() == 0
                  for s in fleet.schedulers.values()),
              f"{label}: reduced {dev} fleet leaked blocks")
        if dev == "cuda":
            counts = {n: wrappers[n].launches for n in ROUTER_KERNELS}
        del router, fleet
    for n, fn in wrappers.items():
        fn.launches = saved[n]
    same = outs["cuda"] == outs["cpu"]
    log(f"{label}: reduced float32 router + fleet (4 members, SMALL "
        f"encoder), card kernels vs CPU plain path over "
        f"{len(outs['cpu'])} requests: decisions, models and tokens "
        f"identical: {same}; card launches {json.dumps(counts)}")
    if not same:
        for i, (a, b) in enumerate(zip(outs["cuda"], outs["cpu"])):
            if a != b:
                log(f"  request {i}: card {a} vs CPU {b}")
    check(same, f"{label}: reduced router differs between card and CPU")
    check(all(v > 0 for v in counts.values()),
          f"{label}: a kernel did not launch on the reduced card router: "
          f"{counts}")


def phase_router(launches, card, ctx):
    """``SemanticRouter.route_batch`` end to end on the card: serve.py's
    demo router (its DSL as the default policy, lint strict; the cost and
    privacy tenants) over one fleet of four full-width bf16 members
    (smollm-360m, qwen3-1.7b, glm4-9b, deepseek-v2 cut to 1 dense + 3 MoE
    layers), the full-width encoder as classifier; a warm-up batch of 8
    and three timed batches of 8 of the demo requests."""
    import dataclasses
    import statistics as st

    import torch
    from repro_torch.classifiers.encoder import (MODERNBERT_BASE_32K,
                                                 EncoderBackend)
    from repro_torch.launch import serve
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = dataclasses.replace(MODERNBERT_BASE_32K, max_len=ENC_MAX_LEN)
    encoder = EncoderBackend(cfg, *router_encoder_weights(cfg, "cuda", 0),
                             trained=set(ROUTER_TASKS))
    router, fleet = build_demo_router(
        ROUTER_ENCODER, encoder, reduced=False, gen_tokens=GEN,
        device="cuda", batch=BATCH, max_seq=MAX_SEQ)
    try:
        torch.cuda.synchronize()
        sizes = {a: sum(p.numel() for p in m.params.parameters())
                 for a, m in fleet.members.items()}
        log(f"router: fleet of {len(sizes)} full-width bf16 members built "
            f"and warmed up in {time.perf_counter() - t0:.1f} s, params "
            f"{json.dumps(sizes)} (total {sum(sizes.values())}; "
            f"deepseek-v2 1 dense + {serve.ONE_CARD_MOE_LAYERS} MoE layers), "
            f"encoder {cfg.n_layers} layers d {cfg.d_model} max_len "
            f"{cfg.max_len} serving {ROUTER_TASKS}, policies "
            f"{router.policies.names()}, max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
        for a, m in fleet.members.items():
            c = m.cfg
            log(f"  {a}: {sum(g.repeats * len(g.period) for g in c.groups)} "
                f"layers, "
                f"{c.n_heads}/{c.n_kv_heads} heads hd {c.head_dim}, vocab "
                f"{c.vocab_size}, attn_impl {c.attn_impl}, decode_impl "
                f"{c.decode_impl}")
        wrappers = kernel_wrappers()
        # the main path: counts zeroed just before, read just after
        for fn in wrappers.values():
            fn.launches = 0
        route_and_check("router warm-up", router, fleet, 0)
        # the timed batches start from a cold semantic cache, as a fresh
        # router would: the warm-up's entries would answer every repeat
        router.cache.entries = []
        walls, stages, overheads, pairs_all = [], {}, [], []
        served_all = {}
        for b in range(ROUTER_BATCHES):
            pairs, wall, st_ms, served = route_and_check(
                f"router batch {b}", router, fleet, b * BATCH)
            walls.append(wall)
            overheads.append((wall - st_ms.get("dispatch", 0.0)) / BATCH)
            for k, v in st_ms.items():
                stages.setdefault(k, []).append(v)
            for a, n in served.items():
                served_all[a] = served_all.get(a, 0) + n
            pairs_all += pairs
            log(f"router batch {b}: route_batch wall {wall:.2f} ms, "
                f"decisions {[o.decision for _, o in pairs]}, models "
                f"{[o.model for _, o in pairs]}, fast "
                f"{sum(o.fast_response is not None for _, o in pairs)}, "
                f"cache hits {sum(o.cache_hit for _, o in pairs)}, stage ms "
                f"{json.dumps({k: round(v, 2) for k, v in st_ms.items()})}, "
                f"router overhead {overheads[-1]:.3f} ms/request [{card}]")
        counts = {n: wrappers[n].launches for n in ROUTER_KERNELS}
        launches.update(counts)
        ctx["signals requests"] = BATCH * (ROUTER_BATCHES + 1)
        log(f"router: launches over the warm-up and {ROUTER_BATCHES} timed "
            f"batches {json.dumps(counts)}; served per member "
            f"{json.dumps(served_all)}")
        check(all(v > 0 for v in counts.values()),
              f"router: a kernel of the path did not launch: {counts}")
        check(set(served_all) == set(fleet.members),
              f"router: not every member served: {served_all}")
        seen = {o.decision for _, o in pairs_all}
        check(any(o.cache_hit for _, o in pairs_all) and
              {"safety_block", "block_unsafe", "hard_math"} <= seen,
              f"router: the mix missed a fast response or a cache hit: "
              f"{seen}")
        log(f"router: route_batch wall ms per batch of {BATCH} "
            f"{' '.join(f'{w:.2f}' for w in walls)} (median "
            f"{st.median(walls):.2f}); router overhead per request "
            f"(wall - dispatch stage) / {BATCH}: "
            f"{' '.join(f'{x:.3f}' for x in overheads)} ms (median "
            f"{st.median(overheads):.3f}) [{card}]")
        log("router: stage ms per batch (median of "
            f"{ROUTER_BATCHES}): " + json.dumps(
                {k: round(st.median(v), 3) for k, v in stages.items()}))
        ctx["router overhead ms"] = st.median(overheads)
        by_model = {}
        for r, o in pairs_all:
            if o.fast_response is None:
                u = r.usage
                by_model.setdefault(o.model, []).append(
                    (u["vsr_ttft_ms"], (u["vsr_service_ms"] - u["vsr_ttft_ms"])
                     / max(1, u["completion_tokens"] - 1)))
        for m, v in sorted(by_model.items()):
            log(f"router: {m} served {len(v)}: TTFT ms p50 "
                f"{st.median(x for x, _ in v):.2f}, TPOT ms p50 "
                f"{st.median(y for _, y in v):.2f} [{card}]")
        # the card's busy share: a whole batch, then the non-dispatch
        # stages alone (the same batch on the echo transport)
        nxt = router_requests(BATCH, start=ROUTER_BATCHES * BATCH)
        profile_run("router profile: route_batch of 8",
                    lambda: router.route_batch(nxt))
        call_fn = router.call_fn
        router.call_fn = router._echo_call
        try:
            nxt = router_requests(BATCH, start=(ROUTER_BATCHES + 1) * BATCH)
            profile_run("router profile: non-dispatch stages (the batch on "
                        "the echo transport)",
                        lambda: router.route_batch(nxt))
        finally:
            router.call_fn = call_fn
        log(f"router: max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    except BaseException:
        router.close()
        raise
    if ctx.pop("keep router", False):
        # the qos phase serves on this router and fleet, and frees them
        ctx["router"] = (router, fleet, encoder)
    else:
        router.close()
    del router, fleet, encoder
    gc.collect()
    torch.cuda.empty_cache()
    reduced_router_card_vs_cpu("router")


# ---------------------------------------------------------------------------
# phase 11: QoS — SLO admission, shedding, degradation and preemption
# ---------------------------------------------------------------------------

# the QoS tenant, on the reference's benchmarks/t_slo_burst.py policy with
# the router's own model names (@FAST@ premium / degrade target, @BIG@ the
# batch and best-effort pick); its jailbreak signal runs the encoder
# (kernel 6) on every admitted row
QOS_TENANT = "qos"
QOS_DSL = '''
SIGNAL keyword urgent { keywords: ["urgent"] }
SIGNAL keyword bulk { keywords: ["bulk"] }
SIGNAL jailbreak jb { method: "classifier", threshold: 0.5 }

ROUTE safety_block (description = "jailbreaks get the canned refusal") {
  PRIORITY 1001
  WHEN jailbreak("jb")
  MODEL "@FAST@"
  PLUGIN fr fast_response { message: "Request blocked by safety policy." }
}

ROUTE premium (description = "interactive latency tier") {
  PRIORITY 10
  WHEN keyword("urgent")
  MODEL "@FAST@"
  SLO { class: "premium", priority: 100, ttft_ms: 2000.0 }
}

ROUTE bulk_batch (description = "degrade-to-cheap throughput tier") {
  PRIORITY 1
  WHEN keyword("bulk")
  MODEL "@BIG@"
  SLO { class: "batch", degrade_to: "@FAST@" }
}

ROUTE scavenger (description = "shed-under-overload tier") {
  PRIORITY 1
  WHEN NOT keyword("urgent")
  MODEL "@BIG@"
  SLO { class: "best_effort" }
}

GLOBAL { default_model: "@BIG@",
         overload: { queue_depth: 8, shed_below: 100,
                     retry_after_s: 0.25,
                     default_class: "best_effort" } }
'''
# flood requests of each class: 12 + 12 keep the profiled burst's event
# processing (~2 s a request) inside the phase's time
QOS_FLOOD = 12
QOS_PREMIUM = 8                # premium requests, unloaded and in the burst
QOS_KERNELS = ("flash_attention", "paged_flash_decode", "multi_lora")
PREEMPT_NEW = 16               # the round trip's victim tokens


def qos_dsl(fast="qwen3", big="glm4"):
    return QOS_DSL.replace("@FAST@", fast).replace("@BIG@", big)


def qos_request(kind, i):
    """The burst's requests (``t_slo_burst.py``'s texts): premium ones say
    "urgent", batch ones "bulk"; each names the qos tenant and its class."""
    from repro_torch.core.types import Message, Request
    if kind == "premium":
        text = f"urgent interactive question number {i} needs an answer"
    else:
        word = "bulk" if kind == "batch" else "background"
        text = f"{word} offline summarization job number {i} over document {i}"
    return Request(messages=[Message("user", text)],
                   metadata={"policy": QOS_TENANT, "slo": kind})


def metric_sum(prefix, **labels):
    from repro_torch.core.observability import METRICS
    want = [f'{k}="{v}"' for k, v in labels.items()]
    return sum(v for k, v in METRICS.counters.items()
               if k.split("{")[0] == prefix and all(w in k for w in want))


def pct(vals, p):
    """The p-th percentile as ``t_slo_burst.py`` takes it (nearest rank
    below)."""
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(p / 100 * len(vals)))] if vals \
        else float("nan")


def add_qos_tenant(router, fast="qwen3", big="glm4"):
    """The QoS tenant into the router's registry, held to lint strict."""
    from repro_torch.analysis import verify_config
    prog = router.add_policy(QOS_TENANT, qos_dsl(fast, big))
    fatal = [d for d in verify_config(prog.config) if d.fatal]
    check(not fatal, f"qos: the tenant fails L4: {fatal}")
    check(prog.overload is not None and prog.overload.queue_depth == 8,
          "qos: the tenant's GLOBAL overload block did not compile")
    return prog


def qos_burst(router, label="qos"):
    """The open-loop burst through ``AsyncFrontend`` (window 5 ms, batches
    of at most 8, depth bound 200, the router's detector sampling at
    every admission and watching the frontend's queue): one warm-up
    premium request, the unloaded baseline (8 premium submitted
    together), then the burst (12 batch-class and 12 best-effort flood
    requests back to back, then 8 premium).  Every future's result is
    read, so a failure on the frontend's thread fails here.  The profiler
    covers the burst's submission and the frontend's first
    ``route_batch`` of it; the rest of the burst runs without it.
    Returns the report, the burst's wall ms, and the profiled window's
    (wall ms, busy ms)."""
    import torch
    from repro_torch.core.types import RouterOverloadError
    from repro_torch.serving.frontend import AsyncFrontend
    det = router.overload
    det.interval_s = 0.0
    fe = AsyncFrontend(router, window_ms=5.0, max_batch=8, max_depth=200)
    det.attach_frontend(fe)
    samples = []                 # (state, load) at every admission sample
    sample = det.sample

    def recorded(policy=None, *, force=False):
        state = sample(policy, force=force)
        samples.append((state, det.load))
        return state

    det.sample = recorded
    done_at = {}

    def submit(req):
        t0 = time.perf_counter()
        fut = fe.submit(req)
        fut.add_done_callback(
            lambda f: done_at.__setitem__(id(f), time.perf_counter()))
        return t0, fut

    def waits(pairs):
        out = []
        for t0, fut in pairs:
            fut.result()
            out.append((done_at[id(fut)] - t0) * 1e3)
        return out

    rep = {}
    try:
        fe.submit(qos_request("premium", 999)).result()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = [submit(qos_request("premium", 1000 + i))
                for i in range(QOS_PREMIUM)]
        base_resp = [fut.result() for _, fut in base]
        rep["base_wait"] = waits(base)
        torch.cuda.synchronize()
        rep["peak_base"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        n_samples = len(samples)
        c0 = {m: metric_sum(m) for m in (
            "admission_rejected_total", "admission_degraded_total",
            "preemptions_total")}
        s0 = {s: metric_sum("overload_state_changes_total", state=s)
              for s in ("ok", "busy", "overload")}
        batches0 = fe.stats.batches
        futs, bounced = [], 0

        def burst_head():
            # the whole burst is submitted, then the first request's
            # future is read: it completes with the frontend's first
            # route_batch of the burst
            nonlocal bounced
            for i in range(2 * QOS_FLOOD):
                try:
                    futs.append(("flood", submit(qos_request(
                        "batch" if i % 2 == 0 else "best_effort", i))))
                except RouterOverloadError:
                    bounced += 1
            for i in range(QOS_PREMIUM):
                futs.append(("premium", submit(qos_request("premium", i))))
            futs[0][1][1].result()

        # the profiler runs on this thread (kineto refuses to start on the
        # frontend's) over the burst's first route_batch; its device trace
        # covers the frontend thread's kernels.  The trace is parsed after
        # the whole burst: parsing it while the frontend thread serves the
        # rest would take the GIL from it
        t0 = time.perf_counter()
        prof = {"n": fe.stats.batches}
        trace = profiled(burst_head)
        prof["n"] = fe.stats.batches - prof["n"]
        for _, (_, fut) in futs:
            fut.result()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        t1 = time.perf_counter()
        prof["ms"] = profile_report(f"{label} profile: the burst's first "
                                    f"route_batch", *trace)
        rep["burst_s"] = wall / 1e3
        rep["parse_s"] = time.perf_counter() - t1
        rep["profiled_batch"] = prof
        rep["peak_burst"] = torch.cuda.max_memory_allocated()
    finally:
        fe.close()
        det.sample = sample
    rep["batches"] = fe.stats.batches - batches0
    rep["burst_requests"] = fe.stats.requests - QOS_PREMIUM - 1
    rep["bounced"] = bounced
    rep["deltas"] = {m: metric_sum(m) - v for m, v in c0.items()}
    rep["state_changes"] = {
        s: metric_sum("overload_state_changes_total", state=s) - v
        for s, v in s0.items()}
    rep["samples"] = samples[n_samples:]
    rep["base"] = base_resp
    rep["burst"] = [(kind, fut.result()) for kind, (_, fut) in futs]
    rep["prem_wait"] = waits([p for k, p in futs if k == "premium"])
    rep["fe"] = fe
    return rep, wall, prof["ms"]


def check_qos_burst(label, router, fleet, rep, card):
    """The burst's checks and numbers: no premium shed, every shed
    carrying the overload header and retry-after 0.25, the counts equal
    to the admission metrics' deltas, at least one shed and one degrade,
    the detector at ``overload``, no error response but the sheds, every
    member's pool clean."""
    sheds = degrades = 0
    prem_ttft = []
    for kind, (resp, out) in rep["burst"]:
        if resp.headers.get("x-vsr-error") == "overload":
            sheds += 1
            check(kind != "premium", f"{label}: a premium request was shed")
            check(resp.headers.get("retry-after") == "0.25",
                  f"{label}: shed without retry-after 0.25: {resp.headers}")
            continue
        check(resp.finish_reason != "error",
              f"{label}: error response {resp.content!r}")
        if "x-vsr-degraded" in resp.headers:
            degrades += 1
            check(out.model == "qwen3" and
                  resp.usage.get("completion_tokens") == GEN,
                  f"{label}: degraded row served by {out.model}: "
                  f"{resp.usage}")
        if kind == "premium":
            check(out.decision == "premium" and out.model == "qwen3",
                  f"{label}: premium routed {out.decision} -> {out.model}")
            prem_ttft.append(float(resp.usage["vsr_ttft_ms"]))
    base_ttft = [float(r.usage["vsr_ttft_ms"]) for r, _ in rep["base"]]
    check(all(o.decision == "premium" and r.finish_reason != "error"
              for r, o in rep["base"]),
          f"{label}: the unloaded premium baseline was not served")
    d = rep["deltas"]
    preempted = d["preemptions_total"]
    check(len(prem_ttft) == QOS_PREMIUM,
          f"{label}: {QOS_PREMIUM - len(prem_ttft)} premium requests not "
          f"served")
    check(sheds == d["admission_rejected_total"] - rep["bounced"]
          and rep["bounced"] == 0,
          f"{label}: {sheds} sheds + {rep['bounced']} bounced vs "
          f"admission_rejected_total +{d['admission_rejected_total']}")
    check(degrades == d["admission_degraded_total"],
          f"{label}: {degrades} degrades vs admission_degraded_total "
          f"+{d['admission_degraded_total']}")
    check(sheds >= 1 and degrades >= 1,
          f"{label}: the burst shed {sheds} and degraded {degrades}")
    states = [s for s, _ in rep["samples"]]
    check("overload" in states,
          f"{label}: the detector never reached overload: {states}")
    for arch, sched in fleet.schedulers.items():
        check(sched.pool.live_refs() == 0,
              f"{label}: {arch} holds {sched.pool.live_refs()} block refs")
    trip = [ld for s, ld in rep["samples"] if s == "overload"]
    by_queue = sum(ld.queue_depth >= 8 for ld in trip)
    fe = rep["fe"]
    log(f"{label}: burst of {rep['burst_requests']} requests "
        f"({2 * QOS_FLOOD} flood + {QOS_PREMIUM} premium; "
        f"{rep['burst_s']:.1f} s with one batch under the profiler, its "
        f"trace parsed after it in {rep['parse_s']:.1f} s) in "
        f"{rep['batches']} frontend batches (all frontend batches "
        f"{fe.stats.batches}, mean size {fe.stats.mean_batch:.2f}, recent "
        f"sizes {list(fe.stats.batch_sizes)})")
    log(f"{label}: shed {sheds}, degraded {degrades}, bounced "
        f"{rep['bounced']}, preemptions {preempted} (metric deltas "
        f"{json.dumps(d)}); no premium shed")
    log(f"{label}: detector state changes over the burst "
        f"{json.dumps(rep['state_changes'])}; samples {len(states)}: "
        f"{' '.join(states)}; "
        f"{by_queue} of {len(trip)} overload samples had queue depth >= 8; "
        f"max queue depth {max((ld.queue_depth for _, ld in rep['samples']), default=0)}, "
        f"max probed TTFT {max((ld.ttft_ewma_ms for _, ld in rep['samples']), default=0.0):.1f} ms; "
        f"last EngineLoad {json.dumps(vars(rep['samples'][-1][1]))}")
    log(f"{label}: premium TTFT ms (scheduler, vsr_ttft_ms) unloaded p50 "
        f"{pct(base_ttft, 50):.2f} p99 {pct(base_ttft, 99):.2f}, under the "
        f"burst p50 {pct(prem_ttft, 50):.2f} p99 {pct(prem_ttft, 99):.2f}; "
        f"premium submit-to-answer ms unloaded p50 "
        f"{pct(rep['base_wait'], 50):.2f} p99 {pct(rep['base_wait'], 99):.2f}"
        f", under the burst p50 {pct(rep['prem_wait'], 50):.2f} p99 "
        f"{pct(rep['prem_wait'], 99):.2f} [{card}]")
    grow = (rep["peak_burst"] - rep["peak_base"]) / 2**20
    log(f"{label}: max_memory_allocated over the baseline "
        f"{rep['peak_base'] / 2**30:.3f} GiB, over the burst "
        f"{rep['peak_burst'] / 2**30:.3f} GiB ({grow:+.1f} MiB)")
    check(grow <= 256, f"{label}: the burst's peak memory grew {grow:.1f} "
          f"MiB over the baseline's (an autograd graph on the frontend's "
          f"thread?)")
    return {"sheds": sheds, "degrades": degrades, "preemptions": preempted,
            "base_p50": pct(base_ttft, 50), "burst_p50": pct(prem_ttft, 50)}


def preempt_roundtrip(label, fleet, arch, err, card, max_new=PREEMPT_NEW):
    """``tests/test_qos.py``'s round trip and ``t_slo_burst.py``'s
    contention, scheduler-direct on one lane of the fleet: every slot
    filled with a priority-0 victim, three steps, then a VIP.  With the
    VIP at priority 0 (FIFO) it waits for a slot; at priority 100 it parks
    a victim, which resumes through a prefix-matched admission.  The
    victims' tokens must equal an uninterrupted run's in both, any
    divergence shown to be a near-tie (bf16 GEMMs may round differently
    over another batch's rows).  Returns (FIFO, preempt) VIP TTFT ms."""
    from repro_torch.serving.fleet import hash_tokens
    lane, sched = fleet.lanes[arch], fleet.schedulers[arch]
    m = fleet.members[arch]
    victims = [f"long running background analysis over corpus {i} with "
               f"many follow up clauses {i}" for i in range(sched.slots)]
    ref = [o["tokens"] for o in fleet.generate(arch, victims,
                                               max_new=max_new)]

    def contested(prio):
        rids = [lane.submit(p, max_new=max_new, priority=0, slo="batch")
                for p in victims]
        for _ in range(3):
            lane.step()
        t0 = time.perf_counter()
        hi = lane.submit("urgent premium question demanding an immediate "
                         "first token", max_new=4, priority=prio,
                         slo="premium")
        done = {}
        while sched.pending:
            for seq in lane.step():
                done[seq.rid] = seq
        vip = done[hi]
        check(len(vip.out) == 4, f"{label}: the VIP got {vip.out}")
        return (vip.t_first - t0) * 1e3, [list(done[r].out) for r in rids], \
            [done[r].parks for r in rids]

    pre0 = sched.preempted
    fifo_ttft, fifo_outs, _ = contested(0)
    check(sched.preempted == pre0, f"{label}: a priority-0 VIP preempted")
    pre_ttft, pre_outs, parks = contested(100)
    check(sched.preempted == pre0 + 1 and sum(parks) == 1,
          f"{label}: preempted {sched.preempted - pre0}, parks {parks}")
    check(sched.pool.live_refs() == 0,
          f"{label}: {sched.pool.live_refs()} block refs after the drain")
    same = 0
    for i, (want, a, b) in enumerate(zip(ref, fifo_outs, pre_outs)):
        for run, got in (("fifo", a), ("preempt", b)):
            if got == want:
                same += 1
                continue
            j = next(n for n, (x, y) in enumerate(zip(want, got)) if x != y)
            near_tie(f"{label} {run} run, victim {i}"
                     + (" (parked)" if run == "preempt" and parks[i] else ""),
                     m.params, m.cfg,
                     hash_tokens(victims[i], m.cfg.vocab_size, m.prompt_cap),
                     want[:j], want[j], got[j], err)
    log(f"{label} preempt: {arch} {sched.slots} victims x {max_new} tokens, parked "
        f"victim {parks.index(1)}; victims' tokens equal to the "
        f"uninterrupted run's in {same} of {2 * len(ref)}; preempted "
        f"+1; live_refs 0; VIP TTFT ms under preemption {pre_ttft:.2f} vs "
        f"FIFO {fifo_ttft:.2f} [{card}]")
    return fifo_ttft, pre_ttft


def qos_image_lane(label, router, fleet, card):
    """``sd-tiny`` joins the fleet (``add_member``); serve.py's image demo
    requests through ``route_batch`` of a router on
    ``build_dsl(("text", "image"))`` over that fleet: requests the
    modality signal routes to ``sd`` come back from the image lane with an
    hw x hw uint8 payload whose ``sig`` equals the CPU lane's."""
    import hashlib

    import numpy as np
    from repro_torch.core.dsl import compile_source
    from repro_torch.core.router import SemanticRouter
    from repro_torch.core.types import Message, Request
    from repro_torch.launch import serve
    from repro_torch.serving.fleet import DIFFUSION_ARCHS, LocalFleet
    t0 = time.perf_counter()
    check(fleet.add_member("sd-tiny"), f"{label}: sd-tiny was already there")
    hw = DIFFUSION_ARCHS["sd-tiny"]["hw"]
    cfg, _ = compile_source(serve.build_dsl(("text", "image")))
    cfg.classifier_backend = router.policies.get().config.classifier_backend
    m2a = {m: p.arch for m, p in cfg.model_profiles.items() if p.arch}
    call = fleet.call_fn(m2a)
    raw = []

    def batch_call(ep, payloads, headers):
        out = call.batch_call(ep, payloads, headers)
        raw.extend(out)
        return out

    def single(ep, payload, headers):
        return batch_call(ep, [payload], [headers])[0]

    single.batch_call = batch_call
    img = SemanticRouter(cfg, call_fn=single, device=fleet.device)
    texts = serve.LANE_DEMO_REQUESTS["image"]
    try:
        pairs = img.route_batch([Request(messages=[Message("user", t)])
                                 for t in texts])
    finally:
        img.close()
    sigs = {}
    for text, (resp, out) in zip(texts, pairs):
        if out.model != "sd":
            continue
        check(resp.usage.get("vsr_lane") == "image",
              f"{label}: {text!r} came back from lane "
              f"{resp.usage.get('vsr_lane')}")
        payload = next(p["choices"][0]["message"]["image"] for p in raw
                       if p["usage"]["vsr_lane"] == "image"
                       and p["choices"][0]["message"]["content"]
                       == resp.content)
        data = np.asarray(payload["data"])
        check(data.size == hw * hw and data.min() >= 0 and data.max() <= 255,
              f"{label}: image payload of {data.size} values "
              f"[{data.min()}, {data.max()}]")
        sig = hashlib.blake2s(data.astype(np.uint8).tobytes(),
                              digest_size=4).hexdigest()
        check(sig == payload["sig"], f"{label}: sig {payload['sig']} is not "
              f"the payload's {sig}")
        sigs[text] = sig
    check(sigs, f"{label}: the modality signal routed no image request to "
          f"sd: {[(o.decision, o.model) for _, o in pairs]}")
    cpu = LocalFleet(["sd-tiny"], batch=BATCH, device="cpu")
    want = {t: o["image"]["sig"]
            for t, o in zip(sigs, cpu.generate("sd-tiny", list(sigs)))}
    check(want == sigs, f"{label}: image sigs on the card {sigs} != the "
          f"CPU's {want}")
    log(f"{label}: sd-tiny added in {time.perf_counter() - t0:.2f} s; "
        f"{len(sigs)} of {len(texts)} image requests routed to sd came back "
        f"from the image lane, {hw}x{hw} uint8, sigs {json.dumps(sigs)} == "
        f"the CPU lane's; decisions "
        f"{[(o.decision, o.model) for _, o in pairs]} [{card}]")


class ForcedDetector:
    """A detector pinned to one state (``tests/test_qos.py``'s)."""

    def __init__(self, state):
        self.state = state

    def sample(self, policy=None, force=False):
        return self.state


def reduced_qos_card_vs_cpu(label):
    """The reduced float32 QoS router and fleet (smollm-360m as the premium
    and degrade model, deepseek-v2 as the big one) on the card and on the
    CPU, with the detector forced to ok, busy and overload: equal
    decisions, models, sheds, degrades and tokens.  Card launches are not
    main-path launches and are restored."""
    from repro_torch.core.dsl import compile_source
    from repro_torch.core.router import SemanticRouter
    from repro_torch.serving.fleet import LocalFleet
    wrappers = kernel_wrappers()
    saved = {n: fn.launches for n, fn in wrappers.items()}
    archs = {"smollm": ARCH, "deepseek-v2": MLA_ARCH}
    ov = {ARCH: {"dtype": "float32", "attn_impl": "pallas"},
          MLA_ARCH: {"dtype": "float32"}}
    reqs = [(kind, i) for i in range(3)
            for kind in ("premium", "batch", "best_effort")]
    outs, counts = {}, {}
    for dev in ("cuda", "cpu"):
        for fn in wrappers.values():
            fn.launches = 0
        fleet = LocalFleet(list(archs.values()), batch=4, gen_tokens=8,
                           warmup=False, decode_impl="flash_paged",
                           arch_overrides=ov, device=dev)
        cfg, _ = compile_source(qos_dsl("smollm", "deepseek-v2"))
        router = SemanticRouter(cfg, call_fn=fleet.call_fn(archs),
                                device=dev)
        rows = []
        try:
            for state in ("ok", "busy", "overload"):
                router.overload = ForcedDetector(state)
                pairs = router.route_batch([qos_request(k, i)
                                            for k, i in reqs])
                rows += [(state, o.decision, o.model,
                          r.headers.get("x-vsr-error"),
                          r.headers.get("x-vsr-degraded"), r.content)
                         for r, o in pairs]
        finally:
            router.close()
        outs[dev] = rows
        check(all(s.pool.live_refs() == 0 for s in fleet.schedulers.values()),
              f"{label}: reduced {dev} QoS fleet leaked blocks")
        if dev == "cuda":
            counts = {n: wrappers[n].launches for n in (
                "flash_attention", "paged_flash_decode",
                "paged_flash_decode_mla")}
        del router, fleet
    for n, fn in wrappers.items():
        fn.launches = saved[n]
    card_rows, cpu_rows = outs["cuda"], outs["cpu"]
    same = card_rows == cpu_rows
    kinds = {(r[0], r[3] is not None, r[4] is not None) for r in cpu_rows}
    log(f"{label}: reduced float32 QoS router + fleet (smollm-360m, "
        f"deepseek-v2), detector forced ok / busy / overload, card kernels "
        f"vs CPU plain path over {len(cpu_rows)} requests: decisions, "
        f"models, sheds, degrades and tokens identical: {same}; "
        f"(state, shed, degraded) seen {sorted(kinds)}; card launches "
        f"{json.dumps(counts)}")
    if not same:
        for i, (a, b) in enumerate(zip(card_rows, cpu_rows)):
            if a != b:
                log(f"  request {i}: card {a} vs CPU {b}")
    check(same, f"{label}: the reduced QoS router differs between card and "
          f"CPU")
    check(("overload", True, False) in kinds and
          ("busy", False, True) in kinds,
          f"{label}: the forced states shed or degraded nothing: {kinds}")
    check(all(v > 0 for v in counts.values()),
          f"{label}: a kernel did not launch on the reduced card router: "
          f"{counts}")


def phase_qos(card, ctx):
    """SLO admission, shedding, degradation and preemption on the card:
    the router phase's full-width router and fleet (handed over in
    ``ctx``, or built here as that phase builds them when it did not
    run) gain the QoS tenant; the burst through ``AsyncFrontend``; the
    preemption round trips on the smollm-360m and deepseek-v2 lanes; the
    image lane; the reduced float32 QoS router card vs CPU."""
    import dataclasses

    import torch
    from repro_torch.classifiers.encoder import (MODERNBERT_BASE_32K,
                                                 EncoderBackend)
    from repro_torch.kernels.flash_decode.ops import (paged_flash_decode,
                                                      paged_flash_decode_mla)
    label = "qos"
    t_phase = time.perf_counter()
    marks = {}
    if "router" in ctx:
        router, fleet, encoder = ctx.pop("router")
        log(f"{label}: the router phase's full-width router and fleet")
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        cfg = dataclasses.replace(MODERNBERT_BASE_32K, max_len=ENC_MAX_LEN)
        encoder = EncoderBackend(cfg, *router_encoder_weights(cfg, "cuda", 0),
                                 trained=set(ROUTER_TASKS))
        router, fleet = build_demo_router(
            ROUTER_ENCODER, encoder, reduced=False, gen_tokens=GEN,
            device="cuda", batch=BATCH, max_seq=MAX_SEQ)
        log(f"{label}: full-width router and fleet built and warmed up in "
            f"{time.perf_counter() - t0:.1f} s")
    marks["fleet"] = time.perf_counter()
    try:
        add_qos_tenant(router)
        log(f"{label}: tenant {QOS_TENANT!r} loaded (lint strict), policies "
            f"{router.policies.names()}, detector "
            f"{type(router.overload).__name__} over the fleet's "
            f"{len(fleet.schedulers)} lanes")
        wrappers = kernel_wrappers()
        torch.cuda.synchronize()
        # the main path: counts zeroed just before, read just after
        for fn in wrappers.values():
            fn.launches = 0
        marks["tenant"] = time.perf_counter()
        rep, wall, (pwall, busy) = qos_burst(router, label)
        burst = {n: wrappers[n].launches for n in QOS_KERNELS}
        nums = check_qos_burst(label, router, fleet, rep, card)
        log(f"{label}: burst wall {wall:.1f} ms; under the profiler its "
            f"submission and first route_batch ({rep['profiled_batch']['n']}"
            f" frontend batches completed): wall {pwall:.1f} ms, card busy "
            f"{busy:.1f} ms "
            f"({100 * busy / pwall:.1f}%); launches over the warm-up, "
            f"baseline and burst {json.dumps(burst)} [{card}]")
        check(all(v > 0 for v in burst.values()),
              f"{label}: a kernel of the burst's path did not launch: {burst}")
        # scheduler-direct preemption, after the frontend's thread
        # has stopped: one thread steps the lanes while counts are read
        for fn in wrappers.values():
            fn.launches = 0
        err = ctx.get(f"{ARCH} bfloat16 verify err", MODEL_TOL["bfloat16"])
        marks["burst"] = time.perf_counter()
        ttft = {ARCH: preempt_roundtrip(label, fleet, ARCH, err, card)}
        smollm = paged_flash_decode.launches
        err = ctx.get(f"{MLA_ARCH} bfloat16 verify err",
                      MLA_MODEL_TOL["bfloat16"])
        ttft[MLA_ARCH] = preempt_roundtrip(label, fleet, MLA_ARCH, err, card)
        marks["round trips"] = time.perf_counter()
        mla = paged_flash_decode_mla.launches
        log(f"{label}: round trip launches: paged_flash_decode {smollm} "
            f"(smollm-360m lane), paged_flash_decode_mla {mla} (deepseek-v2 "
            f"lane)")
        check(smollm > 0 and mla > 0,
              f"{label}: the round trips did not launch kernels 2 and 4")
        counts = dict(burst, paged_flash_decode=burst["paged_flash_decode"]
                      + smollm, paged_flash_decode_mla=mla)
        qos_image_lane(label, router, fleet, card)
        marks["image lane"] = time.perf_counter()
        ctx["qos launches"] = counts
        log(f"{label}: launches of the phase {json.dumps(counts)}; premium "
            f"TTFT p50 ms unloaded {nums['base_p50']:.2f} vs burst "
            f"{nums['burst_p50']:.2f}; sheds {nums['sheds']}, degrades "
            f"{nums['degrades']}, burst preemptions {nums['preemptions']}; "
            f"VIP TTFT ms preempt / FIFO "
            f"{json.dumps({a: [round(p, 2), round(f, 2)] for a, (f, p) in ttft.items()})}"
            f" [{card}]")
    except BaseException:
        router.close()
        raise
    if ctx.pop("keep router after qos", False):
        # the audio phase adds whisper-tiny to this fleet
        ctx["router"] = (router, fleet, encoder)
    else:
        router.close()
    del router, fleet, encoder
    gc.collect()
    torch.cuda.empty_cache()
    reduced_qos_card_vs_cpu(label)
    marks["reduced"] = time.perf_counter()
    prev, secs = t_phase, {}
    for k, t in marks.items():
        secs[k] = round(t - prev, 1)
        prev = t
    log(f"{label}: phase {time.perf_counter() - t_phase:.1f} s, seconds per "
        f"part {json.dumps(secs)}")


# ---------------------------------------------------------------------------
# phase 12: audio — whisper-tiny joins the router's fleet
# ---------------------------------------------------------------------------

AUD = "whisper-tiny"
# the encoder's bidirectional attention: one batch-1 launch per encoder
# layer over the 1500 stub frames, 6/6 heads of 64
ENC_SHAPE = (1, 1500, 6, 64)


def audio_texts():
    """serve.py's two audio demo requests and two more audio payloads."""
    from repro_torch.launch import serve
    return list(serve.LANE_DEMO_REQUESTS["audio"]) + [
        "Transcribe the audio of the quarterly earnings call",
        "Please transcribe this speech from the keynote"]


def phase_audio(card, ctx):
    """The audio lane at full width inside the router's fleet: whisper-tiny
    (4 + 4 layers, d 384, 1500 frames, ``attn_impl="pallas"``) joins the
    router phase's fleet (``add_member``, with sd-tiny when the qos phase
    did not add it), and one ``route_batch`` of mixed text, image and
    audio requests runs through a router on ``build_dsl(("text",
    "image", "audio"))`` over that fleet (``t_multimodal_fleet.py``'s
    measurement 1); launch counts zeroed just before.  Every audio request
    comes back from the audio lane with a transcript, transcripts differ
    by payload, and kernel 1 ran at the encoder's shape once per encoder
    layer and audio request.  One more batch under the profiler; then a
    reduced float32 whisper fleet on the card against the CPU."""
    import dataclasses

    import torch
    from repro_torch.classifiers.encoder import (MODERNBERT_BASE_32K,
                                                 EncoderBackend)
    from repro_torch.core.dsl import compile_source
    from repro_torch.core.router import SemanticRouter
    from repro_torch.core.types import Message, Request
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch import serve
    from repro_torch.models import model as MD
    label = "audio"
    t_phase = time.perf_counter()
    if "router" in ctx:
        router, fleet, encoder = ctx.pop("router")
        log(f"{label}: the router phase's full-width router and fleet")
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        cfg = dataclasses.replace(MODERNBERT_BASE_32K, max_len=ENC_MAX_LEN)
        encoder = EncoderBackend(cfg, *router_encoder_weights(cfg, "cuda", 0),
                                 trained=set(ROUTER_TASKS))
        router, fleet = build_demo_router(
            ROUTER_ENCODER, encoder, reduced=False, gen_tokens=GEN,
            device="cuda", batch=BATCH, max_seq=MAX_SEQ)
        log(f"{label}: full-width router and fleet built and warmed up in "
            f"{time.perf_counter() - t0:.1f} s")
    real = MD.flash_attention
    shapes = []

    def spy(q, *args, **kw):
        # records the shape of every kernel 1 call the model makes; the
        # wrapper itself counts the launches
        shapes.append(tuple(q.shape))
        return real(q, *args, **kw)

    rt = None
    try:
        t0 = time.perf_counter()
        # the fleet's build options give the new member the CUDA prefill
        # kernel, as serve.fleet_overrides does for a router with audio
        fleet._build["arch_overrides"][AUD] = {"attn_impl": "pallas"}
        check(fleet.add_member(AUD), f"{label}: {AUD} was already there")
        if "sd-tiny" not in fleet.members:
            fleet.add_member("sd-tiny")
        m = fleet.members[AUD]
        log(f"{label}: {AUD} added in {time.perf_counter() - t0:.2f} s "
            f"(warmup {m.warmup_ms:.0f} ms): "
            f"{len(m.params.enc_blocks)} + {len(m.params.blocks) // 2} "
            f"layers, d {m.cfg.d_model}, {m.cfg.cross_ctx_len} frames, "
            f"{sum(p.numel() for p in m.params.parameters()) / 1e6:.2f} M "
            f"parameters, {'paged' if m.paged else 'contiguous'} cache, "
            f"attn_impl {m.cfg.attn_impl}; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        cfg, _ = compile_source(serve.build_dsl(("text", "image", "audio")))
        cfg.classifier_backend = \
            router.policies.get().config.classifier_backend
        m2a = {n: p.arch for n, p in cfg.model_profiles.items() if p.arch}
        call = fleet.call_fn(m2a)
        raw = []

        def batch_call(ep, payloads, headers):
            out = call.batch_call(ep, payloads, headers)
            raw.extend(out)
            return out

        def single(ep, payload, headers):
            return batch_call(ep, [payload], [headers])[0]

        single.batch_call = batch_call
        rt = SemanticRouter(cfg, call_fn=single, device=fleet.device)
        audio = audio_texts()
        texts = (serve.DEMO_REQUESTS[1:3] + serve.DEMO_REQUESTS[6:8] +
                 serve.LANE_DEMO_REQUESTS["image"] + audio)
        reqs = [Request(messages=[Message("user", t)]) for t in texts]
        wrappers = kernel_wrappers()
        # the audio lane's payloads as it receives them, for shard_mixers
        aud_lane, submitted = fleet.lanes[AUD], []

        def submit(prompt, **kw):
            rid = type(aud_lane).submit(aud_lane, prompt, **kw)
            submitted.append((prompt, rid))
            return rid

        aud_lane.submit = submit
        torch.cuda.synchronize()
        MD.flash_attention = spy
        # the main path: counts zeroed just before, read just after
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        pairs = rt.route_batch(reqs)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = {n: fn.launches for n, fn in wrappers.items()}
        MD.flash_attention = real
        del aud_lane.submit
        sched = fleet.schedulers[AUD]
        served = [(p, list(sched._finished[r].out)) for p, r in submitted]
        check(all(r.finish_reason != "error" for r, _ in pairs),
              f"{label}: an error response: {[r.content for r, _ in pairs]}")
        trans = {}
        for text, (resp, out) in zip(texts, pairs):
            lane = resp.usage.get("vsr_lane")
            if text in audio:
                check(out.model == "whisper" and lane == "audio",
                      f"{label}: {text!r} went to {out.model} / lane {lane}")
                check("transcript" in resp.content,
                      f"{label}: no transcript in {resp.content!r}")
                trans[text] = resp.content
            else:
                check(lane != "audio", f"{label}: {text!r} reached the "
                      f"audio lane")
        check(len(set(trans.values())) == len(audio),
              f"{label}: transcripts do not differ by payload: {trans}")
        n_enc = sum(sh == ENC_SHAPE for sh in shapes)
        enc_layers = len(m.params.enc_blocks)
        check(n_enc == enc_layers * len(audio),
              f"{label}: kernel 1 ran {n_enc} times at the encoder's shape "
              f"{ENC_SHAPE}, not {enc_layers} layers x {len(audio)} audio "
              f"requests")
        check(len(shapes) == counts["flash_attention"],
              f"{label}: {len(shapes)} kernel 1 calls, "
              f"{counts['flash_attention']} launches counted")
        ctx["audio launches"] = counts
        ctx["audio encoder launches"] = n_enc
        ttft = [p["usage"]["vsr_ttft_ms"] for p in raw
                if p["usage"]["vsr_lane"] == "audio"]
        service = [p["usage"]["vsr_service_ms"] for p in raw
                   if p["usage"]["vsr_lane"] == "audio"]
        log(f"{label}: route_batch of {len(reqs)} ({len(audio)} audio, "
            f"{len(serve.LANE_DEMO_REQUESTS['image'])} image) in "
            f"{wall:.1f} ms; decisions "
            f"{[(o.decision, o.model) for _, o in pairs]}; launches "
            f"{json.dumps(counts)}; kernel 1 at the encoder's shape "
            f"{n_enc} of {len(shapes)} (other shapes "
            f"{sorted(set(sh for sh in shapes if sh != ENC_SHAPE))}); audio "
            f"TTFT ms p50 {statistics.median(ttft):.2f}, service ms p50 "
            f"{statistics.median(service):.2f} [{card}]")
        for text in audio:
            log(f"  {text[:48]!r} -> {trans[text][:72]!r}")
        t_batch = time.perf_counter()
        # the profiler's processing grows with the events: one batch of
        # the audio requests alone
        areqs = [Request(messages=[Message("user", t)]) for t in audio]
        profile_run(f"{label}: profile: one route_batch of the {len(audio)} "
                    f"audio requests", lambda: rt.route_batch(areqs))
        log(f"{label}: the profiled batch took "
            f"{time.perf_counter() - t_batch:.1f} s with its processing")
        log(f"{label}: max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
        n = MIX_REQUESTS[AUD]
        check(len(served) == n, f"{label}: {len(served)} audio payloads "
              f"reached the lane, not {n}")
        prompts = [p for p, _ in served]
        ctx.setdefault("mixers", {})[AUD] = dict(unsharded_tokens(
            m, [t for _, t in served], [[4]] * n, n,
            [aud_lane._frames(p) for p in prompts]), prompts=prompts)
    finally:
        MD.flash_attention = real
        if rt is not None:
            rt.close()
        router.close()
    del router, fleet, encoder, m
    gc.collect()
    torch.cuda.empty_cache()
    reduced_card_vs_cpu(label, AUD, {"attn_impl": "pallas"},
                        {"flash_attention": flash_attention})
    log(f"{label}: phase {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 13: train — checkpoint and training
# ---------------------------------------------------------------------------

TRAIN_DEVICE = "cuda"
TRAIN_STEPS = 12
TRAIN_ARGS = ["--arch", ARCH, "--steps", str(TRAIN_STEPS), "--batch", "8",
              "--seq", "512", "--lr", "3e-4", "--log-every", "3",
              "--device", TRAIN_DEVICE]
TRAIN_REL = 1e-4          # the reference test's resume tolerance
ADAPTER_STEPS = 60        # train_or_load_adapters' default
ADAPTER_PER_CLASS = 24


def moe_100m():
    """``examples/train_moe.py``'s qwen3-moe-family model: d 512, 8 attention
    + MoE layers of 16 experts top-2, d_ff_expert 1024, vocab 8192."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import BlockSpec, LayerGroup
    return get_config("qwen3-moe-235b-a22b").replace(
        d_model=512, n_heads=8, n_kv_heads=4, head_dim=64, vocab_size=8192,
        groups=(LayerGroup((BlockSpec("attn", "moe"),), 8),),
        n_experts=16, moe_top_k=2, d_ff_expert=1024)


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def crash_drill(label, ck, full):
    """``--ckpt-every 6 --fail-at-step 9`` must end in SystemExit(17); the
    re-run resumes at step 6.  Returns (resumed losses, the two runs'
    stats, the step-6 checkpoint's bytes)."""
    from repro_torch.checkpoint import latest_step
    from repro_torch.launch import train as T
    st1, st2 = {}, {}
    try:
        T.main(TRAIN_ARGS + ["--ckpt-dir", ck, "--ckpt-every", "6",
                             "--fail-at-step", "9"], stats=st1)
    except SystemExit as e:
        check(e.code == 17, f"{label}: the injected failure exited "
              f"{e.code!r}, not 17")
    else:
        check(False, f"{label}: --fail-at-step 9 did not exit")
    check(latest_step(ck) == 6, f"{label}: latest checkpoint "
          f"{latest_step(ck)}, not 6")
    nbytes = dir_bytes(os.path.join(ck, "step_00000006"))
    resumed = T.main(TRAIN_ARGS + ["--ckpt-dir", ck, "--ckpt-every", "6"],
                     stats=st2)
    check(len(resumed) == TRAIN_STEPS - 6,
          f"{label}: resumed {len(resumed)} steps, not {TRAIN_STEPS - 6}")
    rel = abs(resumed[-1] - full[-1]) / abs(full[-1])
    log(f"{label}: resumed at 6, final loss {resumed[-1]!r} vs "
        f"uninterrupted {full[-1]!r} (rel {rel:.3e})")
    return resumed, rel, (st1, st2), nbytes


def train_smollm(card):
    """(a) smollm-360m at published widths and depth through
    ``launch/train.py``'s ``main``: 12 steps uninterrupted, then the crash
    drill; one more step under the profiler."""
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch import train as T
    from repro_torch.models import model as MD
    from repro_torch.models.config import model_flops
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_lib import make_step_fn
    label = "train smollm-360m"
    cfg = get_config(ARCH)
    n_params = sum(p.numel() for p in MD.Model(cfg, "cpu").parameters())
    tokens = 8 * 512
    wrappers = kernel_wrappers()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts zeroed just before, read just after
    for fn in wrappers.values():
        fn.launches = 0
    stats = {}
    full = T.main(TRAIN_ARGS, stats=stats)
    torch.cuda.synchronize()
    counts = {n: fn.launches for n, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    check(not any(counts.values()), f"{label}: the training path launched "
          f"a kernel: {counts}")
    check(len(full) == TRAIN_STEPS and all(map(math.isfinite, full)),
          f"{label}: losses {full}")
    check(full[-1] < full[0], f"{label}: the last loss {full[-1]} is not "
          f"below the first {full[0]}")
    steps_ms = [1e3 * t for t in stats["step_s"][1:]]
    p50 = statistics.median(steps_ms)
    flops = model_flops(cfg, tokens, "train")
    log(f"{label}: {n_params / 1e6:.2f} M parameters, {len(cfg.groups)} "
        f"group x {cfg.n_blocks} layers, d {cfg.d_model}, batch 8 x seq 512 "
        f"= {tokens} tokens a step, bf16, remat on, lr 3e-4 warmup 1; "
        f"losses {[round(x, 4) for x in full]}")
    log(f"{label}: step ms p50 {p50:.2f} (steps 1-{TRAIN_STEPS - 1}; step 0 "
        f"{1e3 * stats['step_s'][0]:.1f}), {tokens / p50 * 1e3:.0f} tokens/s,"
        f" model-FLOP share {100 * flops / (p50 / 1e3) / PEAK_OPS['bfloat16']:.2f}%"
        f" (model_flops: 6 N T = {flops / 1e12:.3f} TFLOP a step over 989 "
        f"TFLOP/s), "
        f"max_memory_allocated {peak / 2**30:.2f} GiB, launches "
        f"{json.dumps(counts)} [{card}]")
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        resumed, rel, (st1, st2), nbytes = crash_drill(
            label, os.path.join(tmp, "ck"), full)
        log(f"{label}: checkpoint {nbytes} bytes ({nbytes / 2**30:.3f} GiB: "
            f"parameters stored as float32, m, v), write s "
            f"{[round(x, 2) for x in st1['save_s'] + st2['save_s']]}, read "
            f"s {st2['restore_s']:.2f} [{card}]")
        if rel > TRAIN_REL:
            # the card's atomics (embedding and gather backward) reorder
            # bf16 sums: retry with deterministic algorithms, not a looser
            # tolerance, and print what determinism costs
            log(f"{label}: rel {rel:.3e} > {TRAIN_REL}: deterministic "
                f"algorithms on, uninterrupted run and drill again")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                dstats = {}
                full = T.main(TRAIN_ARGS, stats=dstats)
                d50 = statistics.median(1e3 * t for t in
                                        dstats["step_s"][1:])
                log(f"{label}: deterministic step ms p50 {d50:.2f} vs "
                    f"{p50:.2f} ({d50 - p50:+.2f} ms) [{card}]")
                resumed, rel, _, _ = crash_drill(
                    label + " (deterministic)", os.path.join(tmp, "ck2"),
                    full)
            finally:
                torch.use_deterministic_algorithms(False)
        check(rel <= TRAIN_REL, f"{label}: resumed final loss off by rel "
              f"{rel:.3e} > {TRAIN_REL}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(0)
    model = MD.init_params(cfg, gen, TRAIN_DEVICE)
    opt = init_opt_state(model)
    step = make_step_fn(cfg, AdamWConfig(warmup_steps=1))
    toks, labels = (torch.from_numpy(a) for a in
                    TokenStream(cfg.vocab_size, 8, 512).batch_at(0))
    step(model, opt, toks, labels)
    torch.cuda.synchronize()
    profile_run(f"{label}: profile: one train step",
                lambda: step(model, opt, toks, labels))
    del model, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return p50


def train_moe(card):
    """(b) ``moe_100m`` for a few steps under ``moe_impl`` "gshard" and
    "ep" (on one card the sort/gather path)."""
    import torch
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models import model as MD
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_lib import make_step_fn
    cfg = moe_100m()
    stream = TokenStream(cfg.vocab_size, 8, 256)
    for impl in ("gshard", "ep"):
        label = f"train moe_100m {impl}"
        gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(0)
        model = MD.init_params(cfg, gen, TRAIN_DEVICE)
        n = sum(p.numel() for p in model.parameters())
        opt = init_opt_state(model)
        step = make_step_fn(cfg, AdamWConfig(warmup_steps=1), moe_impl=impl)
        out, times = [], []
        for i in range(4):
            toks, labels = (torch.from_numpy(a) for a in stream.batch_at(i))
            t0 = time.perf_counter()
            model, opt, met = step(model, opt, toks, labels)
            out.append({k: float(met[k]) for k in
                        ("loss", "ce", "moe_lb", "moe_z")})
            times.append(1e3 * (time.perf_counter() - t0))
        check(all(math.isfinite(v) for m in out for v in m.values()),
              f"{label}: {out}")
        check(all(m["moe_lb"] > 0 and m["moe_z"] > 0 for m in out),
              f"{label}: aux losses vanish: {out}")
        log(f"{label}: {n / 1e6:.1f} M parameters, batch 8 x 256; per step "
            f"loss / ce / moe_lb / moe_z "
            f"{[tuple(round(m[k], 4) for k in m) for m in out]}; step ms "
            f"{[round(t, 1) for t in times]} [{card}]")
        del model, opt, step
        gc.collect()
        torch.cuda.empty_cache()


def train_adapters_phase(card):
    """(c) ``build_router(train_adapters=True)`` as ``serve.py
    --train-adapters`` runs it (the default encoder, three tasks x 60
    steps): "trained", then "loaded" from the same cache; then
    ``train_adapter`` for jailbreak on the full-width encoder."""
    import dataclasses
    import io
    import shutil
    import tempfile

    import torch
    from repro_torch.classifiers import adapters as A
    from repro_torch.classifiers import backend as BK
    from repro_torch.classifiers import tokenizer as TOK
    from repro_torch.classifiers.encoder import (MODERNBERT_BASE_32K,
                                                 EncoderBackend,
                                                 init_adapters, init_encoder,
                                                 train_adapter)
    from repro_torch.data.pipeline import router_corpus
    from repro_torch.launch import serve
    label = "train adapters"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_adapters_")
    saved = BK._BACKENDS.pop("encoder", None)
    try:
        reports, backends = [], []
        for want in ("trained", "loaded"):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                router, fleet = serve.build_router(
                    classifier_backend="encoder", device=TRAIN_DEVICE, batch=2,
                    warmup=False, train_adapters=True, adapter_cache=tmp)
            secs = time.perf_counter() - t0
            router.close()
            line = [ln for ln in buf.getvalue().splitlines()
                    if ln.startswith("signal adapters:")]
            backends.append(BK._BACKENDS.pop("encoder"))
            log(f"{label}: build_router(train_adapters=True) {line} in "
                f"{secs:.2f} s")
            check(line == ["signal adapters: " + ", ".join(
                f"{t}={want}" for t in sorted(A.TRAINABLE_TASKS))],
                f"{label}: report {line}, want every task {want}")
            reports.append(line)
            del router, fleet
        for t in A.TRAINABLE_TASKS:
            for k, v in backends[0].adapters[t].items():
                check(torch.equal(backends[1].adapters[t][k], v),
                      f"{label}: loaded {t}/{k} differs from the trained")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        BK._BACKENDS.pop("encoder", None)
        if saved is not None:
            BK._BACKENDS["encoder"] = saved
    del backends
    # the full-width encoder (ModernBERT-base widths, max_len 512, float32,
    # TF32 off) at the reference's 60 steps and 24 texts per class
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(MODERNBERT_BASE_32K, max_len=ENC_MAX_LEN)
    gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(0)
    params = init_encoder(cfg, gen, TRAIN_DEVICE)
    adapters = init_adapters(cfg, gen, TRAIN_DEVICE)
    texts, labels = A.make_dataset(
        "jailbreak", router_corpus(n_per_class=ADAPTER_PER_CLASS))
    ids, lens = TOK.encode_batch(texts, cfg.max_len)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sub, loss = train_adapter(cfg, params, adapters, "jailbreak",
                              torch.from_numpy(ids), torch.from_numpy(lens),
                              torch.from_numpy(labels),
                              steps=ADAPTER_STEPS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(math.isfinite(loss) and loss < math.log(3),
          f"{label}: full-width jailbreak loss {loss} not below ln 3")
    check(not any(t.requires_grad for t in sub.values()),
          f"{label}: train_adapter returned tensors that require grad")
    # the trained adapter serves through the fused path (kernel 6)
    adapters["jailbreak"] = sub
    enc = EncoderBackend(cfg, params, adapters, trained={"jailbreak",
                                                         "domain"})
    res = enc.classify_all(("jailbreak", "domain"), texts[:4])
    check(len(res["jailbreak"][0]) == 4, f"{label}: {res}")
    log(f"{label}: full-width encoder ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, max_len {cfg.max_len}, float32, TF32 off): "
        f"train_adapter jailbreak {ADAPTER_STEPS} steps on {len(texts)} "
        f"texts in {secs:.2f} s ({1e3 * secs / ADAPTER_STEPS:.1f} ms a step),"
        f" final loss {loss:.6f}, max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; fused classify_all labels "
        f"{res['jailbreak'][0]} [{card}]")
    del params, adapters, sub, enc
    gc.collect()
    torch.cuda.empty_cache()


def train_card_vs_cpu(label="train card vs cpu"):
    """(d) Reduced float32 training on the card against the CPU: llama3.2-1b
    and qwen3-moe (gshard), 8 steps from the same weights, losses within
    rel 1e-4; a checkpoint written on the card restores on the CPU bit for
    bit."""
    import shutil
    import tempfile

    import torch
    from repro_torch.bridge import (opt_state_from_jax, opt_state_to_jax,
                                    params_from_jax, ref_tree)
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models import model as MD
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_lib import make_step_fn
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in ("llama3.2-1b", "qwen3-moe-235b-a22b"):
        cfg = get_reduced(arch).replace(dtype="float32")
        cpu = MD.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        card = MD.Model(cfg, TRAIN_DEVICE)
        card.load_state_dict(cpu.state_dict())
        runs = {}
        for dev, model in (("cpu", cpu), ("cuda", card)):
            opt = init_opt_state(model)
            step = make_step_fn(cfg, AdamWConfig(warmup_steps=1),
                                moe_impl="gshard")
            stream = TokenStream(cfg.vocab_size, 2, 32)
            losses = []
            for i in range(8):
                toks, labels = (torch.from_numpy(a)
                                for a in stream.batch_at(i))
                model, opt, met = step(model, opt, toks, labels)
                losses.append(float(met["loss"]))
            runs[dev] = (losses, opt)
        rel = max(abs(a - b) / abs(b) for a, b in
                  zip(runs["cuda"][0], runs["cpu"][0]))
        check(rel <= 1e-4, f"{label} {arch}: losses card "
              f"{runs['cuda'][0]} vs cpu {runs['cpu'][0]} (rel {rel:.3e})")
        tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        try:
            save_checkpoint(tmp, 8, (ref_tree(card, cfg), opt_state_to_jax(
                runs["cuda"][1], cfg, numpy=False)), {"next_step": 8})
            target = (ref_tree(cpu, cfg),
                      opt_state_to_jax(runs["cpu"][1], cfg, numpy=False))
            (ptree, otree), meta = restore_checkpoint(tmp, 8, target)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        back = MD.Model(cfg, "cpu")
        back.load_state_dict(params_from_jax(ptree))
        opt = opt_state_from_jax(otree, "cpu")
        for name, t in card.state_dict().items():
            check(torch.equal(back.state_dict()[name], t.cpu()),
                  f"{label} {arch}: restored {name} differs")
        copt = runs["cuda"][1]
        for name in copt.m:
            check(torch.equal(opt.m[name], copt.m[name].cpu()) and
                  torch.equal(opt.v[name], copt.v[name].cpu()),
                  f"{label} {arch}: restored moments of {name} differ")
        check(int(opt.step) == 8 and meta == {"next_step": 8},
              f"{label} {arch}: step {int(opt.step)}, meta {meta}")
        log(f"{label}: {arch} float32 8 steps, losses card == cpu within rel "
            f"{rel:.3e} (last {runs['cuda'][0][-1]!r} vs "
            f"{runs['cpu'][0][-1]!r}); the card's checkpoint restores on "
            f"the CPU bit for bit")


def phase_train(card, ctx):
    """Checkpoint and training on the card: (a) smollm-360m at full width
    through ``launch/train.py`` with the crash drill, (b) MoE training,
    (c) adapter training, (d) reduced float32 training card == CPU."""
    import torch
    t_phase = time.perf_counter()
    # what the earlier phases left unreachable (router and fleet cycles)
    # still holds card memory until collected: free it so the peaks
    # below are training's own
    gc.collect()
    torch.cuda.empty_cache()
    log(f"train: memory_allocated at the start "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    prev, secs = t_phase, {}
    for part, fn in (("smollm", train_smollm), ("moe", train_moe),
                     ("adapters", train_adapters_phase),
                     ("card vs cpu", lambda card: train_card_vs_cpu())):
        out = fn(card)
        if part == "smollm":
            ctx["train step ms p50"] = out
        now = time.perf_counter()
        secs[part] = round(now - prev, 1)
        prev = now
    log(f"train: phase {time.perf_counter() - t_phase:.1f} s, seconds per "
        f"part {json.dumps(secs)}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")


# ---------------------------------------------------------------------------
# phase 14: shard — the model axis on one card
# ---------------------------------------------------------------------------

SHARD_ARCH = "qwen3-moe-235b-a22b"
SHARD_LAYERS = 4                # of the 94: 4 x 2.488 B + 2 x 0.622 B params
SHARD_RANKS = 2                 # mesh data 1 x model 2 on the one card
SHARD_KERNELS = ("flash_attention", "paged_flash_decode")
SMDEC_ROWS, SMDEC_PROMPT = 8, 64
# part (e): build_serve_steps on the reduced member, rows x prompt, steps
SMDEC_SMALL = (4, 12, 8)
# smollm-360m's parameter count: the gradient tree of the compression check
SMOLLM_PARAMS = 361_821_120


def shard_overrides(reduced=False):
    from repro_torch.models.config import BlockSpec, LayerGroup
    ov = {"attn_impl": "pallas"}
    if reduced:
        ov["dtype"] = "float32"
    else:
        ov["groups"] = (LayerGroup((BlockSpec("attn", "moe"),),
                                   SHARD_LAYERS),)
    return {SHARD_ARCH: ov}


def shard_fleet(model_axis, reduced=False, device="cuda", **kw):
    from repro_torch.serving.fleet import LocalFleet
    if reduced:
        kw = dict(dict(batch=4, gen_tokens=8, warmup=False), **kw)
    else:
        kw = dict(dict(batch=BATCH, max_seq=MAX_SEQ, gen_tokens=GEN), **kw)
    return LocalFleet([SHARD_ARCH], reduced=reduced, moe_impl="ep",
                      decode_impl="flash_paged", model_axis=model_axis,
                      arch_overrides=shard_overrides(reduced), device=device,
                      **kw)


def last_logits(cfg, params, mesh, ids, moe_impl="ep"):
    """Whole-vocabulary float32 logits of the last position of ``ids``
    (a fresh paged prefill into a scratch pool; a sharded member gathers
    its vocab shards)."""
    import torch
    from repro_torch.models import model as MD
    from repro_torch.serving.serve_lib import on_mesh
    nblk = -(-len(ids) // BLOCK)
    cache = MD.init_paged_cache(cfg, 1, MAX_SEQ, 1 + nblk, BLOCK,
                                device="cuda", mesh=mesh)
    tbl = torch.zeros((1, MAX_SEQ // BLOCK), dtype=torch.int32, device="cuda")
    tbl[0, :nblk] = torch.arange(1, nblk + 1, dtype=torch.int32)
    with on_mesh(mesh):
        logits, _ = MD.prefill(cfg, params, torch.tensor(
            [list(ids)], dtype=torch.int32, device="cuda"), cache,
            moe_impl=moe_impl, tbl=tbl, paged_fresh=True)
        logits = logits.float()
        if logits.shape[-1] != cfg.vocab_size:
            logits = mesh.all_gather(logits, "model", dim=-1)
    return logits[0].cpu()


def shard_last_logits(shard, ids):
    return last_logits(shard.cfg, shard.params, shard.mesh, ids,
                       shard.moe_impl)


def shard_param_bytes(shard):
    return sum(p.numel() * p.element_size() for p in shard.params.parameters())


def shard_serve(label, fleet, card, arch=SHARD_ARCH, kernels=SHARD_KERNELS,
                n=12, reqs=None):
    """The first ``n`` of the 12 requests (or ``reqs``) through
    ``batch_call`` on ``fleet`` (sharded or not), launch counts of every
    rank zeroed just before and read just after; on a sharded fleet the
    decode steps' host-staged collective time is read off rank 0's mesh.
    A speculative lane's verify rounds (the draft's proposal, then the
    wide verify) count as its decode steps.  Returns (tokens, prompt ids,
    report)."""
    import torch
    m = fleet.members[arch]
    sched = fleet.schedulers[arch]
    steps, prefills = [], []
    mesh = fleet.mesh
    names = ("decode_rows", "prefill_row", "prefill_paged_fresh",
             "prefill_paged_suffix")
    saved = {name: getattr(m, name) for name in names}
    spec_saved = {}
    if m.spec is not None:
        spec_saved = {name: getattr(m.spec, name)
                      for name in ("draft_propose", "verify")}

    def timed(fn, into):
        def step(*a, **kw):
            c0 = mesh.stats.seconds if mesh is not None else 0.0
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            into.append((time.perf_counter() - t0,
                         (mesh.stats.seconds - c0) if mesh is not None
                         else 0.0))
            return out
        return step

    m.decode_rows = timed(saved["decode_rows"], steps)
    for name in names[1:]:
        setattr(m, name, timed(saved[name], prefills))
    rounds = []
    for name, fn in spec_saved.items():
        # a round: the draft's proposal, then the verify
        setattr(m.spec, name, timed(fn, rounds))
    call = fleet.call_fn({arch: arch})
    reqs = payloads(arch)[:n] if reqs is None else reqs
    torch.cuda.synchronize()
    fleet.rank_stats(reset=True)
    t0 = time.perf_counter()
    answers = call.batch_call(None, reqs, [{}] * len(reqs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = fleet.rank_stats()
    for name, fn in saved.items():
        setattr(m, name, fn)
    for name, fn in spec_saved.items():
        setattr(m.spec, name, fn)
    if rounds:
        # (proposal, verify) pairs -> one step each
        steps.extend((a[0] + b[0], a[1] + b[1])
                     for a, b in zip(rounds[0::2], rounds[1::2]))
    seqs = [sched._finished[r] for r in sorted(sched._finished)][-len(reqs):]
    ntok = [a["usage"]["completion_tokens"] for a in answers]
    ttft = [a["usage"]["vsr_ttft_ms"] for a in answers]
    tpot = [(a["usage"]["vsr_service_ms"] - a["usage"]["vsr_ttft_ms"])
            / max(1, nt - 1) for a, nt in zip(answers, ntok)]
    check(len(answers) == n and all(nt == GEN for nt in ntok),
          f"{label}: expected {n} answers of {GEN} tokens, got {ntok}")
    if sched.paged:
        check(sched.pool.live_refs() == 0,
              f"{label}: blocks leaked after drain")
    else:     # a contiguous lane has no pool: every slot free again
        check(not sched.pending and all(a is None for a in sched.active),
              f"{label}: a slot is still held after the drain")
    launches = [{k: s["launches"][k] for k in kernels} for s in stats]
    step_ms = statistics.median(s for s, _ in steps) * 1e3
    coll_ms = statistics.median(c for _, c in steps) * 1e3
    pre_ms = statistics.median(s for s, _ in prefills) * 1e3
    pre_coll = statistics.median(c for _, c in prefills) * 1e3
    rep = {"ttft_p50": statistics.median(ttft), "prefill_ms": pre_ms,
           "prefill_coll_ms": pre_coll,
           "tpot_p50": statistics.median(tpot), "wall_ms": wall * 1e3,
           "launches": launches, "decode_steps": len(steps),
           "step_ms": step_ms, "coll_ms": coll_ms,
           "peaks": [s["max_memory_allocated"] for s in stats],
           "coll": [s["collectives"] for s in stats]}
    log(f"{label}: {n} answers of {GEN} tokens in {wall * 1e3:.1f} ms, TTFT "
        f"ms p50 {rep['ttft_p50']:.1f} max {max(ttft):.1f}, TPOT ms p50 "
        f"{rep['tpot_p50']:.2f} max {max(tpot):.2f}; {len(steps)} decode "
        f"steps, step ms p50 {step_ms:.2f}, of which host-staged "
        f"collectives (gloo) p50 {coll_ms:.2f} ms; {len(prefills)} prefill "
        f"calls, ms p50 {pre_ms:.2f}, of which collectives {pre_coll:.2f} "
        f"ms; launches per rank "
        f"{json.dumps(launches)}; prefill calls {sched.prefill.prefills} "
        f"[{card}]")
    return [list(s.out) for s in seqs], [s.ids for s in seqs], rep


def smdec_steps(shard, prompts):
    """One rank: ``build_serve_steps`` on the member's blocks and mesh,
    8 rows at one depth (scalar ``pos``) through a prefill and 31 decode
    steps, once with the head-sharded contiguous cache (``xla``) and once
    with the sequence-sharded one (``shardmap``, ``smdec``).  Returns per
    impl the greedy tokens, each step's whole-vocabulary top-2 gap and
    logits, and the decode wall ms."""
    import torch
    from repro_torch.models import model as MD
    from repro_torch.serving import serve_lib
    out = {}
    for impl in ("xla", "shardmap"):
        cfg = shard.cfg.replace(decode_impl=impl)
        _, _, sh = serve_lib.build_serve_steps(cfg, shard.mesh, SMDEC_ROWS,
                                               MAX_SEQ)
        cache = MD.init_cache(cfg, SMDEC_ROWS, MAX_SEQ, "cuda",
                              mesh=shard.mesh)
        split = any(getattr(t, "_seq_split", False)
                    for t in cache["g0"]["b0"].values())
        toks = torch.tensor(prompts, dtype=torch.int32, device="cuda")
        rows, gaps, logit_rows, step_s = [], [], [], []
        with serve_lib.on_mesh(shard.mesh):
            for i in range(GEN):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if i == 0:
                    logits, cache = MD.prefill(cfg, shard.params, toks, cache,
                                               moe_impl=shard.moe_impl)
                else:
                    logits, cache = MD.decode_step(cfg, shard.params,
                                                   nxt[:, None], cache,
                                                   moe_impl=shard.moe_impl)
                nxt = serve_lib.greedy(logits, cfg)
                rows.append(nxt.tolist())       # synchronises
                if i:
                    step_s.append(time.perf_counter() - t0)
                # the whole vocabulary, for the near-tie rule (untimed)
                whole = shard.mesh.all_gather(logits.float(), "model", dim=-1)
                top = torch.topk(whole, 2, dim=-1).values
                gaps.append((top[:, 0] - top[:, 1]).tolist())
                logit_rows.append(whole.cpu() if shard.mesh.rank == 0
                                  else None)
        out[impl] = {"tokens": rows, "gaps": gaps, "logits": logit_rows,
                     "seq_split": split,
                     "step_ms": statistics.median(step_s) * 1e3,
                     "wq": str(sh["param_specs"]["blocks.0.attn.wq"])}
    return out


def compress_check(mesh_model):
    """One rank: ``compressed_psum_mean`` over the ``"data"`` axis of a
    (ranks x 1) mesh, of a gradient tree with smollm-360m's parameter
    shapes (float32, the same on every rank: pure data parallelism).
    Returns the max error in quanta, the ratio and the seconds."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.compression import (compressed_psum_mean,
                                                     compression_ratio)
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as MD
    mesh = LM.make_host_mesh(mesh_model)
    shapes = MD.param_shapes(get_config("smollm-360m"))
    gen = torch.Generator(device="cuda").manual_seed(5)
    grads = {k: torch.randn(s, generator=gen, device="cuda") * 0.01
             for k, s in shapes.items()}
    n = sum(g.numel() for g in grads.values())
    torch.cuda.synchronize()
    c0 = mesh.stats.seconds
    t0 = time.perf_counter()
    out = compressed_psum_mean(grads, mesh, axis="data", seed=1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    worst = 0.0
    for k, g in grads.items():
        flat = g.reshape(-1)
        pad = (-flat.numel()) % 256
        blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, 256)
        quantum = (blocks.abs().amax(1, keepdim=True) / 127.0).clamp_min(
            1e-12)
        err = torch.nn.functional.pad((out[k] - g).reshape(-1).abs(),
                                      (0, pad)).reshape(-1, 256)
        worst = max(worst, float((err / quantum).max()))
    return {"params": n, "worst_quanta": worst,
            "ratio": compression_ratio(grads), "seconds": secs,
            "collective_s": mesh.stats.seconds - c0,
            "peak": torch.cuda.max_memory_allocated()}


def bf16_logit_error(cfg, params, seqs, starts, crosses=None, keep=None):
    """The unsharded member's own bf16 rounding error, an error bound that
    the sharded paths do not set: the max abs difference between its bf16
    logits (the served config) and those of the same weights in float32
    (``attn_impl="einsum"``), over positions ``starts[i]:`` of each sequence
    of ``seqs`` (teacher-forced, one ``forward`` each; ``crosses``: each
    sequence's cross-attention context; ``keep``: a list that the float32
    logits join, on the host).  Converts ``params`` to float32 in
    place."""
    import torch
    from repro_torch.models import model as MD

    def run(c):
        out = []
        for i, (seq, st) in enumerate(zip(seqs, starts)):
            toks = torch.tensor([list(seq)], dtype=torch.int32,
                                device=params.embed.device)
            cross = None if crosses is None else \
                crosses[i].to(params.embed.dtype)
            with torch.no_grad():
                out.append(MD.forward(c, params, toks, cross,
                                      moe_impl="ep")[0][0, st:].float())
        return out

    low = run(cfg)
    params.float()
    high = run(cfg.replace(dtype="float32", attn_impl="einsum"))
    if keep is not None:
        keep.extend(h.cpu() for h in high)
    return max(float((a - b).abs().max()) for a, b in zip(low, high))


def smdec_tokens(shard, prompts, steps, max_seq):
    """One rank: the greedy tokens of ``build_serve_steps``' own prefill
    and decode (scalar ``pos``) for ``prompts`` (rows at one depth) under
    ``decode_impl`` "xla" and "shardmap"; ``shard`` a ``MemberShard`` or
    an unsharded member (``mesh`` None)."""
    import torch
    from repro_torch.models import model as MD
    from repro_torch.serving import serve_lib
    out = {}
    for impl in ("xla", "shardmap"):
        cfg = shard.cfg.replace(decode_impl=impl)
        prefill, decode, _ = serve_lib.build_serve_steps(
            cfg, shard.mesh, len(prompts), max_seq, moe_impl=shard.moe_impl)
        cache = MD.init_cache(cfg, len(prompts), max_seq, shard.device,
                              mesh=shard.mesh)
        nxt, cache = prefill(shard.params, torch.tensor(
            prompts, dtype=torch.int32, device=shard.device), cache)
        rows = [nxt.tolist()]
        for _ in range(steps - 1):
            nxt, cache = decode(shard.params, nxt[:, None], cache)
            rows.append(nxt.tolist())
        out[impl] = rows
    return out


def shard_near_tie(label, got, want, ids, logits_of, limit, contexts=None):
    """Tokens equal, or the first divergence of each request a near-tie of
    the sharded member's logits (``logits_of(ids)``, or ``logits_of(ids,
    contexts[i])`` for request i's cross-attention context): both tokens
    within ``limit`` of the top logit (twice the unsharded member's bf16
    logit error, ``bf16_logit_error``)."""
    same = sum(a == b for a, b in zip(got, want))
    log(f"{label}: tokens identical for {same}/{len(want)} requests")
    for i, (a, b) in enumerate(zip(want, got)):
        if a == b:
            continue
        j = next(n for n, (x, y) in enumerate(zip(a, b)) if x != y)
        seq = list(ids[i]) + list(a[:j])
        lg = logits_of(seq) if contexts is None else \
            logits_of(seq, contexts[i])
        top, second = (float(x) for x in lg.float().topk(2).values)
        off_a, off_b = top - float(lg[a[j]]), top - float(lg[b[j]])
        ok = max(off_a, off_b) <= limit
        log(f"  {label} request {i}: divergence at token {j}: {a[j]} vs "
            f"{b[j]}, below the top logit by {off_a:.4e} / {off_b:.4e}, "
            f"top-2 gap {top - second:.4e} (near-tie limit {limit:.4e}) "
            f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{label}: request {i} diverges at token {j}, not at a "
              f"near-tie")
    return same


def phase_shard(card, ctx):
    """The model axis on one card: (b) qwen3-moe-235b-a22b at published
    widths (4 of 94 layers) served alone on this process, freed; (a) the
    same member and seeds over 2 ranks (``launch.mesh.host_ranks``, both on
    the card, ``gloo``), the 12 requests; (c) ``build_serve_steps`` on the
    ranks, ``shardmap`` (``smdec``) vs ``xla``; (d) ``compressed_psum_mean``
    over the 2 ranks; (e) the reduced float32 sharded fleet, and
    ``build_serve_steps`` under ``shardmap`` and ``xla``, on the card ==
    on CPU ranks == unsharded.  The full-width comparisons (a, c) are held
    to twice the unsharded member's own bf16 logit error (``tie``), read in
    (b) against its float32 weights: two bf16 paths each within that of
    the exact logits differ by at most twice it."""
    import torch
    from repro_torch.launch import mesh as LM
    label = "shard"
    t_phase = time.perf_counter()
    marks = {}
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{label}: memory_allocated at the start "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    # (b) the unsharded member, first
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fleet = shard_fleet(1)
    m = fleet.members[SHARD_ARCH]
    nparams = sum(p.numel() for p in m.params.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in m.params.parameters())
    log(f"{label}: unsharded {SHARD_ARCH} ({SHARD_LAYERS} of 94 layers, "
        f"{nparams / 1e9:.3f} B params, {nbytes / 1e9:.2f} GB) built + "
        f"warmed up in {time.perf_counter() - t0:.1f} s")
    want, ids, rep_b = shard_serve(f"{label} unsharded", fleet, card)
    probe = list(ids[0])
    ref_logits = last_logits(m.cfg, m.params, None, probe)
    peak_b = torch.cuda.max_memory_allocated()
    log(f"{label}: unsharded max_memory_allocated {peak_b / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    e32 = bf16_logit_error(m.cfg, m.params,
                           [list(i) + list(w[:-1]) for i, w in zip(ids, want)],
                           [len(i) - 1 for i in ids])
    tie = 2 * e32
    log(f"{label}: unsharded bf16 vs float32 logits over the 12 served "
        f"sequences' {12 * GEN} decision positions: max abs diff {e32:.4e}; "
        f"near-tie limit of the sharded checks 2 x that = {tie:.4e} "
        f"({time.perf_counter() - t0:.1f} s)")
    del fleet, m
    gc.collect()
    torch.cuda.empty_cache()
    marks["unsharded"] = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with LM.host_ranks(SHARD_RANKS, device="cuda") as ctl:
        t0 = time.perf_counter()
        fleet = shard_fleet(SHARD_RANKS)
        m = fleet.members[SHARD_ARCH]
        shard = m.shard
        build_s = time.perf_counter() - t0
        specs = {n: p._spec for n, p in m.params.named_parameters()}
        held = ctl.run(shard, "apply", shard_param_bytes, gather=True)
        check(any("model" in str(s) for s in specs.values()),
              f"{label}: no parameter spec holds 'model'")
        log(f"{label}: intra-op threads per rank "
            f"{ctl.gather(torch.get_num_threads)} (os.cpu_count "
            f"{os.cpu_count()}, affinity {len(os.sched_getaffinity(0))})")
        log(f"{label}: {SHARD_ARCH} over mesh {fleet.mesh.shape} built + "
            f"warmed up in {build_s:.1f} s; SHARDED_OK: specs "
            f"{sorted({str(s) for s in specs.values()})}; bytes held per "
            f"rank {[round(b / 1e9, 3) for b in held]} GB of "
            f"{nparams * 2 / 1e9:.2f} GB")
        # bf16: a half of the parameters is nparams bytes (the router and
        # the norms, replicated, are 0.1% of them)
        check(all(abs(b - nparams) < 0.01 * nparams for b in held),
              f"{label}: a rank does not hold about half the member: {held}")
        got, ids_a, rep_a = shard_serve(f"{label} sharded", fleet, card)
        check([list(i) for i in ids_a] == [list(i) for i in ids],
              f"{label}: prompts differ between the runs")
        la = rep_a["launches"]
        check(all(v > 0 for r in la for v in r.values()) and la[0] == la[1],
              f"{label}: launches per rank {la} (expected equal and "
              f"non-zero)")
        shard_logits = ctl.run(shard, "apply", shard_last_logits, probe)
        err = float((shard_logits - ref_logits).abs().max())
        log(f"{label}: last-position logits sharded vs unsharded, max abs "
            f"diff {err:.4e} (limit {tie:.4e})")
        check(err <= tie, f"{label}: sharded logits off the unsharded by "
              f"{err:.4e}, above {tie:.4e}")
        shard_near_tie(f"{label} sharded vs unsharded", got, want, ids,
                       lambda seq: ctl.run(shard, "apply",
                                           shard_last_logits, seq),
                       tie)
        stats = fleet.rank_stats()
        peaks = [s["max_memory_allocated"] for s in stats]
        log(f"{label}: max_memory_allocated per rank "
            f"{[round(p / 2**30, 2) for p in peaks]} GiB vs unsharded "
            f"{peak_b / 2**30:.2f} GiB; TTFT p50 ms sharded "
            f"{rep_a['ttft_p50']:.1f} vs unsharded {rep_b['ttft_p50']:.1f}; "
            f"TPOT p50 ms {rep_a['tpot_p50']:.2f} vs {rep_b['tpot_p50']:.2f};"
            f" decode step p50 {rep_a['step_ms']:.2f} ms, host-staged "
            f"collectives {rep_a['coll_ms']:.2f} ms "
            f"({100 * rep_a['coll_ms'] / rep_a['step_ms']:.1f}%) [{card}]")
        ctx["shard launches"] = {k: sum(r[k] for r in la)
                                 for k in SHARD_KERNELS}
        marks["sharded"] = time.perf_counter()
        # (c) smdec on the same ranks and blocks
        rng = __import__("numpy").random.default_rng(3)
        prompts = rng.integers(4, m.cfg.vocab_size,
                               (SMDEC_ROWS, SMDEC_PROMPT)).tolist()
        res = ctl.run(shard, "apply", smdec_steps, prompts, gather=True)
        x, s = res[0]["xla"], res[0]["shardmap"]
        check(all(r["xla"]["tokens"] == x["tokens"] and
                  r["shardmap"]["tokens"] == s["tokens"] for r in res),
              f"{label}: smdec: ranks disagree on the greedy tokens")
        check(s["seq_split"] and not x["seq_split"],
              f"{label}: smdec: cache layouts not as asked")
        # per row: the steps before its first divergence carry the same
        # inputs on both paths, so their logit difference is the error of
        # the split-KV combine; a divergence must be a near-tie of xla's
        err, same_rows, first = 0.0, 0, []
        for r in range(SMDEC_ROWS):
            t = next((t for t in range(GEN) if x["tokens"][t][r] !=
                      s["tokens"][t][r]), GEN)
            for u in range(min(t + 1, GEN)):
                err = max(err, float((x["logits"][u][r] -
                                      s["logits"][u][r]).abs().max()))
            if t == GEN:
                same_rows += 1
            else:
                first.append((r, t, x["gaps"][t][r]))
        check(err <= tie, f"{label}: smdec logits off xla's by {err:.4e}, "
              f"above {tie:.4e}")
        for r, t, gap in first:
            ok = gap <= tie
            log(f"  {label} smdec row {r}: first divergence at step {t}, "
                f"xla's top-2 gap {gap:.4e} (near-tie limit {tie:.4e}) "
                f"{'ok' if ok else 'FAIL'}")
            check(ok, f"{label}: smdec row {r} diverges from xla at step "
                  f"{t}, not at a near-tie")
        log(f"{label}: smdec (build_serve_steps, {SMDEC_ROWS} rows x "
            f"{GEN} tokens from {SMDEC_PROMPT}-token prompts): shardmap "
            f"tokens == xla for {same_rows}/{SMDEC_ROWS} rows, logits max "
            f"abs diff before each row's divergence {err:.4e} (limit "
            f"{tie:.4e}); decode step "
            f"ms p50 xla "
            f"{x['step_ms']:.2f} vs shardmap {s['step_ms']:.2f} "
            f"(sequence-sharded cache, split-KV combine over gloo) [{card}]")
        del fleet, m, shard
        gc.collect()
        torch.cuda.empty_cache()
        marks["smdec"] = time.perf_counter()
        # (d) compression of a smollm-360m-sized gradient tree
        cres = ctl.gather(compress_check, 1)
        c = cres[0]
        check(c["params"] == SMOLLM_PARAMS,
              f"{label}: gradient tree of {c['params']} params")
        check(all(r["worst_quanta"] <= 1.0 + 1e-4 for r in cres),
              f"{label}: compressed mean off by more than one quantum: "
              f"{[r['worst_quanta'] for r in cres]}")
        check(c["ratio"] < 0.27, f"{label}: compression ratio {c['ratio']}")
        log(f"{label}: compressed_psum_mean over {SHARD_RANKS} ranks of "
            f"{c['params'] / 1e6:.1f} M float32 (smollm-360m's tree): max "
            f"error {max(r['worst_quanta'] for r in cres):.4f} quanta, "
            f"ratio {c['ratio']:.4f}, {c['seconds']:.2f} s of which "
            f"host-staged gloo collectives {c['collective_s']:.2f} s "
            f"[{card}]")
        marks["compression"] = time.perf_counter()
        # (e) the reduced float32 sharded fleet on the card
        small = shard_fleet(SHARD_RANKS, reduced=True)
        small.rank_stats(reset=True)
        card_toks = [o["tokens"] for o in small.generate(
            SHARD_ARCH, prompts_of(SHARD_ARCH))]
        small_launch = [{k: s["launches"][k] for k in SHARD_KERNELS}
                        for s in small.rank_stats()]
        rows, plen, steps = SMDEC_SMALL
        vocab = small.members[SHARD_ARCH].cfg.vocab_size
        sm_prompts = __import__("numpy").random.default_rng(4).integers(
            4, vocab, (rows, plen)).tolist()
        max_seq = small.members[SHARD_ARCH].shard.max_seq
        card_sm = ctl.run(small.members[SHARD_ARCH].shard, "apply",
                          smdec_tokens, sm_prompts, steps, max_seq,
                          gather=True)
        del small
    with LM.host_ranks(SHARD_RANKS, device="cpu") as ctl:
        cpu = shard_fleet(SHARD_RANKS, reduced=True, device="cpu")
        cpu_toks = [o["tokens"] for o in cpu.generate(
            SHARD_ARCH, prompts_of(SHARD_ARCH))]
        cpu_sm = ctl.run(cpu.members[SHARD_ARCH].shard, "apply",
                         smdec_tokens, sm_prompts, steps, max_seq,
                         gather=True)
        del cpu
    whole = shard_fleet(1, reduced=True, device="cpu")
    plain = [o["tokens"] for o in whole.generate(SHARD_ARCH,
                                                 prompts_of(SHARD_ARCH))]
    wm = whole.members[SHARD_ARCH]
    plain_sm = smdec_tokens(types.SimpleNamespace(
        cfg=wm.cfg, mesh=None, params=wm.params, device=torch.device("cpu"),
        moe_impl="ep"), sm_prompts, steps, max_seq)["xla"]
    log(f"{label}: reduced float32 sharded fleet, card ranks == CPU ranks: "
        f"{card_toks == cpu_toks}, == unsharded CPU: {card_toks == plain}; "
        f"card launches per rank {json.dumps(small_launch)}")
    check(card_toks == cpu_toks == plain,
          f"{label}: reduced sharded fleet tokens differ (card / CPU ranks / "
          f"unsharded)")
    sm = [r[impl] for r in card_sm + cpu_sm for impl in ("xla", "shardmap")]
    log(f"{label}: reduced float32 build_serve_steps ({rows} rows x {steps} "
        f"tokens from {plen}-token prompts), shardmap and xla on every card "
        f"and CPU rank == unsharded xla: "
        f"{all(t == plain_sm for t in sm)}")
    check(all(t == plain_sm for t in sm),
          f"{label}: reduced build_serve_steps tokens differ (shardmap / xla "
          f"on card or CPU ranks / unsharded)")
    check(all(v > 0 for r in small_launch for v in r.values()),
          f"{label}: a kernel did not launch on the reduced card ranks")
    marks["reduced"] = time.perf_counter()
    prev, secs = t_phase, {}
    for k, t in marks.items():
        secs[k] = round(t - prev, 1)
        prev = t
    log(f"{label}: phase {time.perf_counter() - t_phase:.1f} s, seconds per "
        f"part {json.dumps(secs)}")


# ---------------------------------------------------------------------------
# phase 15: shard_train — the model axis, training half, on one card
# ---------------------------------------------------------------------------

ST_LAYERS = 1                   # of the 94: 2.488 B + 2 x 0.622 B params
ST_BATCH, ST_SEQ, ST_STEPS = 8, 512, 3
ST_RANKS = 2
# smollm-360m cut to 4 of its 32 layers (every width kept): over data 2
# the whole model's gradient sum through host-staged gloo took 5.7 s a
# step, and the run's time limit has no room for it
ST_LAUNCH_LAYERS = 4
ST_LAUNCH = ["--arch", ARCH, "--batch", "8", "--seq", "512", "--lr", "3e-4",
             "--log-every", "1", "--device", "cuda", "--layers",
             str(ST_LAUNCH_LAYERS)]
ST_LAUNCH_STEPS = 5             # the drill: --ckpt-every 3 --fail-at-step 4
ST_SMALL = ("llama3.2-1b", "qwen3-moe-235b-a22b")
ST_SMALL_REL = 1e-5


def st_opt():
    """(a)'s optimizer for its 3 steps: the reference's ``AdamWConfig()``
    (``build_train_step``'s default, warmup over 100 steps).  At lr 3e-4
    from step 0, Adam's first update of +-lr on every weight throws the
    full-width model far off (loss 12.5 to 21.6), where any rounding
    difference grows step by step."""
    from repro_torch.training.optimizer import AdamWConfig
    return AdamWConfig()


def st_move_opt():
    """(a)'s one update held element by element: lr 3e-4 from step 0
    (warmup 1).  A weight of 0.016 has a bf16 step of 1.2e-4, so the +-lr
    of Adam's first update moves nearly every weight (at the default's
    warmup, lr 3e-6, almost every update rounds away)."""
    from repro_torch.training.optimizer import AdamWConfig
    return AdamWConfig(warmup_steps=1)


def st_config():
    """qwen3-moe-235b-a22b at published widths, 1 of its 94 layers, with
    the training attention (``"blocked"``: the kernel has no gradient)."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import BlockSpec, LayerGroup
    return get_config(SHARD_ARCH).replace(
        groups=(LayerGroup((BlockSpec("attn", "moe"),), ST_LAYERS),),
        attn_impl="blocked")


def st_free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def st_batch(cfg, i=0):
    """``TokenStream``'s global batch ``i`` of (a)'s shape, on the CPU."""
    import torch
    from repro_torch.data.pipeline import TokenStream
    return tuple(torch.from_numpy(a) for a in TokenStream(
        cfg.vocab_size, ST_BATCH, ST_SEQ).batch_at(i))


def st_steps(cfg, params, opt, step, shape, mesh=None):
    """``steps`` steps of ``step`` on ``TokenStream``'s batches (``shape``
    = batch, seq, steps): per step the loss, gradient norm, seconds and
    the rank mesh's host-staged collective seconds."""
    import torch
    from repro_torch.data.pipeline import TokenStream
    batch, seq, steps = shape
    stream = TokenStream(cfg.vocab_size, batch, seq)
    rows = []
    for i in range(steps):
        toks, labels = (torch.from_numpy(a) for a in stream.batch_at(i))
        c0 = mesh.stats.seconds if mesh is not None else 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, toks, labels)
        torch.cuda.synchronize()
        rows.append({**{k: float(met[k]) for k in
                        ("loss", "grad_norm", "ce", "moe_lb", "moe_z")},
                     "s": time.perf_counter() - t0,
                     "coll_s": (mesh.stats.seconds - c0) if mesh is not None
                     else 0.0})
    return rows


@contextlib.contextmanager
def st_first_grads():
    """Within the block, the gradient that a train step of ``train_lib``
    hands to its AdamW update first (the rank's blocks, after the data
    sums) is copied to the CPU into the dict it yields."""
    from repro_torch.training import train_lib
    update, first = train_lib.adamw_update, {}

    def spy(cfg, params, grads, state, **kw):
        if not first:
            first.update({k: g.detach().cpu() for k, g in grads.items()})
        return update(cfg, params, grads, state, **kw)
    train_lib.adamw_update = spy
    try:
        yield first
    finally:
        train_lib.adamw_update = update


def st_sharded_rank(cfg, shape, sink):
    """One rank of (a): ``cfg`` drawn as this rank's blocks of
    ``make_host_mesh(2)`` on the card (each leaf whole from one seeded
    stream, then cut), ``build_train_step``'s steps with every kernel's
    count zeroed just before and read just after; then the weights drawn
    again and one step of ``st_move_opt`` on the step-0 batch.  Rank 0
    (the caller's process) puts that step's gradient and the weights after
    it, whole (``bridge.whole_params``, on the CPU), into ``sink``."""
    import torch
    from repro_torch.bridge import whole_params
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as MD
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_lib import build_train_step
    mesh = LM.make_host_mesh(ST_RANKS)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()   # rank 0's process holds more
    params = MD.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
        mesh=mesh)
    opt = init_opt_state(params)
    held = sum(p.numel() * p.element_size() for p in params.parameters())
    held_opt = sum(t.numel() * t.element_size()
                   for d in (opt.m, opt.v) for t in d.values())
    step, _ = build_train_step(cfg, mesh, st_opt(), batch=shape[0],
                               moe_impl="ep", remat=True)
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    mesh.stats.reset()
    rows = st_steps(cfg, params, opt, step, shape, mesh)
    out = {"rows": rows, "held": held, "held_opt": held_opt,
           "launches": {n: fn.launches for n, fn in wrappers.items()},
           "calls": mesh.stats.calls, "bytes": mesh.stats.bytes,
           "peak": torch.cuda.max_memory_allocated() - base,
           "coords": mesh.coords}
    del params, opt, step
    st_free()
    t0 = time.perf_counter()
    params = MD.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
        mesh=mesh)
    step, _ = build_train_step(cfg, mesh, st_move_opt(), batch=shape[0],
                               moe_impl="ep", remat=True)
    with st_first_grads() as first:
        step(params, init_opt_state(params), *st_batch(cfg))
    grads = whole_params(first, params, mesh)
    del first
    moved = whole_params({k: p.detach().cpu()
                          for k, p in params.named_parameters()}, params, mesh)
    out["whole_s"] = time.perf_counter() - t0
    if mesh.rank == 0:
        sink.update(grads=grads, moved=moved)
    del params, step, grads, moved
    st_free()
    return out


def st_small_rank(arch, named, device):
    """One rank of (c): ``build_train_step`` on ``make_host_mesh(2)`` for
    the reduced float32 ``arch`` from the whole weights ``named`` on
    ``device`` (``None``: ``make_step_fn`` without a mesh on the CPU, the
    unsharded run); per step (loss, gradient norm)."""
    import torch
    from repro_torch.bridge import shard_params
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as MD
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_lib import build_train_step, make_step_fn
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced(arch).replace(dtype="float32")
    oc = AdamWConfig(warmup_steps=1)
    if device is None:
        params = MD.Model(cfg, "cpu")
        params.load_state_dict(named)
        step = make_step_fn(cfg, oc, moe_impl="ep")
    else:
        mesh = LM.make_host_mesh(ST_RANKS)
        params = MD.Model(cfg, device, mesh=mesh)
        params.load_state_dict(shard_params(named, cfg, mesh))
        step, _ = build_train_step(cfg, mesh, oc, batch=4, moe_impl="ep")
    opt = init_opt_state(params)
    stream = TokenStream(cfg.vocab_size, 4, 32)
    out = []
    for i in range(ST_STEPS):
        toks, labels = (torch.from_numpy(a) for a in stream.batch_at(i))
        params, opt, met = step(params, opt, toks, labels)
        out.append((float(met["loss"]), float(met["grad_norm"])))
    return out


def st_launch_rank(argv, stats=None):
    """One rank of (b): ``launch.train.main(argv)``, with this rank's
    host-staged collective seconds, calls and bytes over the run, its
    stats (into ``stats``: rank 0's reach the caller even when the run
    ends in the drill's ``SystemExit``, which passes) and its peak
    memory."""
    import torch
    from repro_torch.launch import mesh as LM
    from repro_torch.launch import train as T
    mesh = LM.make_host_mesh()
    mesh.stats.reset()
    torch.cuda.reset_peak_memory_stats()
    stats = {} if stats is None else stats
    losses = T.main(argv, stats=stats)
    out = {"losses": losses, "stats": stats, "coll_s": mesh.stats.seconds,
           "calls": mesh.stats.calls, "bytes": mesh.stats.bytes,
           "peak": torch.cuda.max_memory_allocated()}
    st_free()
    return out


def st_close(label, got, want, limit, what):
    err = abs(got - want)
    check(err <= limit, f"{label}: {what} {got!r} vs unsharded {want!r}: "
          f"|diff| {err:.4e} above the limit {limit:.4e}")
    return err


def st_bf16_ulp(x):
    """The spacing of bf16 values at ``|x|`` (8 significant bits)."""
    import torch
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), e - 8)


def st_check_update(label, cfg, grads, moved):
    """The sharded weights after one step of ``st_move_opt`` (``moved``)
    against the one-process update: ``optimizer.adamw_update`` without a
    mesh on the same draw and the sharded step's own gradient (``grads``,
    on the card, itself held against the unsharded one by ``st_check_grads``).  The
    inputs are the same, and only float32 roundings differ (the clip
    factor's norm is summed in another order: blocks, then ranks), so
    every element lies within one bf16 rounding at the larger of the
    weight before and after the step (where ``w0 - update`` cancels to
    near zero, the result's own bf16 step is finer than the float32
    rounding of its operands).  (AdamW's first update is
    ``lr g / (|g| + eps)``, not +-lr, where the clipped gradient is near
    ``eps`` — ``lm_head``'s at this width — so two bf16 gradients do not
    bound the weights by a sign-flip count there.)"""
    import torch
    from repro_torch.models import model as MD
    from repro_torch.training.optimizer import adamw_update, init_opt_state
    model = MD.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    w0 = {k: p.detach().clone() for k, p in model.named_parameters()}
    adamw_update(st_move_opt(), model, grads, init_opt_state(model))
    st_free()
    apart = changed = total = 0
    for k, p in model.named_parameters():
        a16 = moved[k].cuda()
        a = a16.float()
        b = p.detach().float()
        d = (a - b).abs()
        ulp = st_bf16_ulp(torch.maximum(torch.maximum(a.abs(), b.abs()),
                                        w0[k].float().abs()))
        over = int((d > ulp).sum())
        if over:
            i = int(torch.argmax(d / ulp))
            check(False, f"{label}: {k}: {over} elements of the sharded "
                  f"update beyond one bf16 rounding of the one-process "
                  f"update; the worst: sharded {float(a.view(-1)[i])!r}, "
                  f"one-process {float(b.view(-1)[i])!r}, before "
                  f"{float(w0[k].view(-1)[i])!r}, gradient "
                  f"{float(grads[k].view(-1)[i])!r}")
        apart += int((d > 0).sum())
        changed += int((a16 != w0[k]).sum())
        total += d.numel()
        del a16, a, b, d, ulp
    del model, w0
    st_free()
    return {"elements": total, "moved by the step": changed,
            "one rounding apart": apart}


def st_check_grads(label, got, want, e_leaf):
    """The sharded step-0 gradient against the unsharded one (both on the
    card), leaf by leaf: the norm of the difference within twice the unsharded member's
    own bf16-vs-float32 error norm of that leaf (``e_leaf``), so a partial
    gradient on one small leaf shows."""
    import torch
    worst_k, worst, diff2 = None, 0.0, 0.0
    for k, w in want.items():
        d = float(torch.linalg.vector_norm(got[k].float() - w.float()))
        check(d <= 2 * e_leaf[k], f"{label}: gradient of {k}: |sharded - "
              f"unsharded| {d:.4e} above twice its bf16 error "
              f"{2 * e_leaf[k]:.4e}")
        share = d / max(2 * e_leaf[k], 1e-30)
        if share >= worst:
            worst_k, worst = k, share
        diff2 += d * d
    return {"norm of the difference": math.sqrt(diff2), "worst leaf": worst_k,
            "worst share of limit": worst}


def phase_shard_train(card, ctx):
    """The model axis, training half, on one card: (a) the cut
    qwen3-moe unsharded here then over 2 ranks, (b) smollm-360m through
    the launcher on 2 data ranks with the crash drill, (c) reduced float32
    training on card ranks == CPU ranks == unsharded CPU."""
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint import latest_step
    from repro_torch.checkpoint.ckpt import read_manifest
    from repro_torch.configs import get_reduced
    from repro_torch.launch import mesh as LM
    from repro_torch.launch import train as T
    from repro_torch.models import model as MD
    from repro_torch.models.config import model_flops
    from repro_torch.training.optimizer import global_norm, init_opt_state
    from repro_torch.training.train_lib import make_step_fn, value_and_grad
    label = "shard_train"
    t_phase = time.perf_counter()
    marks = {}
    shape = (ST_BATCH, ST_SEQ, ST_STEPS)
    st_free()
    log(f"{label}: memory_allocated at the start "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    # (a) unsharded: the bf16 steps, then the float32 reading of step 0
    cfg = st_config()
    torch.cuda.reset_peak_memory_stats()
    model = MD.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    opt = init_opt_state(model)
    step = make_step_fn(cfg, st_opt(), moe_impl="ep", remat=True)
    un = st_steps(cfg, model, opt, step, shape)
    peak_un = torch.cuda.max_memory_allocated()
    del model, opt, step
    st_free()
    model = MD.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    # the reading, on the same draw: the unsharded member's bf16 error against the same
    # weights in float32 on the step-0 batch, as bounds (the triangle
    # inequality: two bf16 paths, each that far from float32, are at most
    # twice it apart): the mean absolute per-token cross-entropy error
    # (plus the aux terms' errors) bounds the loss' error, and each leaf's
    # gradient error norm bounds that leaf's sharded-vs-unsharded
    # difference
    cfg32 = cfg.replace(dtype="float32")
    m32 = MD.Model(cfg32, "cuda")
    m32.load_state_dict(model.state_dict())
    toks, labels = (t.cuda() for t in st_batch(cfg))
    reading = {}
    for tag, c, m in (("bf16", cfg, model), ("f32", cfg32, m32)):
        with torch.no_grad():
            logits = MD.forward(c, m, toks, moe_impl="ep")[0].float()
            tok_ce = torch.logsumexp(logits, -1) - torch.gather(
                logits, -1, labels.long().clamp(min=0)[..., None])[..., 0]
            del logits
        loss, met, g = value_and_grad(c, m, toks, labels, moe_impl="ep",
                                      remat=True)
        reading[tag] = {"ce_t": tok_ce[labels >= 0], "loss": float(loss),
                        "grad_norm": float(global_norm(g)), "grads": g,
                        **{k: float(v) for k, v in met.items()}}
        del g
    r16, r32 = reading["bf16"], reading["f32"]
    e_loss = float((r16["ce_t"] - r32["ce_t"]).abs().mean()) + \
        0.01 * abs(r16["moe_lb"] - r32["moe_lb"]) + \
        1e-3 * abs(r16["moe_z"] - r32["moe_z"])
    g16, g32 = r16.pop("grads"), r32.pop("grads")
    e_leaf = {k: float(torch.linalg.vector_norm(g16[k].float() - g32[k]))
              for k in g32}
    e_gn = math.sqrt(sum(e * e for e in e_leaf.values()))
    # g16 stays: the unsharded step-0 gradient (make_step_fn's step 0
    # runs this value_and_grad on these weights and this batch)
    for r in (r16, r32):
        del r["ce_t"]
    del model, m32, m, reading, g32
    st_free()
    lim_loss, lim_gn = 2 * e_loss, 2 * e_gn
    flops = model_flops(cfg, ST_BATCH * ST_SEQ, "train")
    active = flops / (6 * ST_BATCH * ST_SEQ)
    un_p50 = 1e3 * statistics.median(r["s"] for r in un[1:])
    log(f"{label}: unsharded {cfg.name} ({cfg.n_blocks} of 94 layers, "
        f"{n / 1e9:.3f} B params, {nbytes / 1e9:.2f} GB bf16, "
        f"{active / 1e9:.3f} B active), batch {ST_BATCH} x {ST_SEQ}, ep, "
        f"remat: losses {[r['loss'] for r in un]}, grad norms "
        f"{[r['grad_norm'] for r in un]}; step 0, bf16 vs float32: loss "
        f"{r16['loss']!r} vs {r32['loss']!r}, grad norm "
        f"{r16['grad_norm']!r} vs {r32['grad_norm']!r}, ce / moe_lb / "
        f"moe_z {[r16[k] for k in ('ce', 'moe_lb', 'moe_z')]} vs "
        f"{[r32[k] for k in ('ce', 'moe_lb', 'moe_z')]}; mean |per-token "
        f"ce error| + aux terms' {e_loss:.4e}, |gradient error| "
        f"{e_gn:.4e} over {len(e_leaf)} leaves (each leaf's limit twice "
        f"its own): limits twice those, loss {lim_loss:.4e}, grad norm "
        f"{lim_gn:.4e}")
    marks["unsharded"] = time.perf_counter()
    ck = tempfile.mkdtemp(prefix="chip_smoke_shard_train_")
    drill = ST_LAUNCH + ["--ckpt-dir", os.path.join(ck, "ck"),
                         "--ckpt-every", "3", "--steps",
                         str(ST_LAUNCH_STEPS)]
    small, drill_stats = {}, {}
    try:
        try:
            with LM.host_ranks(ST_RANKS) as ctl:
                whole = {}
                ranks = ctl.gather(st_sharded_rank, cfg, shape, whole)
                marks["sharded"] = time.perf_counter()
                st_check_sharded(label, ranks, un, n, nbytes, lim_loss,
                                 lim_gn)
                g_s = {k: v.cuda() for k, v in whole.pop("grads").items()}
                gq = st_check_grads(label, g_s, g16, e_leaf)
                del g16
                uq = st_check_update(label, cfg, g_s, whole.pop("moved"))
                del g_s
                marks["update"] = time.perf_counter()
                sh = ranks[0]["rows"]
                sh_p50 = 1e3 * statistics.median(r["s"] for r in sh[1:])
                coll = 1e3 * statistics.median(r["coll_s"] for r in sh[1:])
                share = 100 * flops / PEAK_OPS["bfloat16"] / 1e-3
                log(f"{label}: one step at lr {st_move_opt().lr} from step "
                    f"0: its gradient, sharded vs unsharded, leaf by leaf "
                    f"(whole_params): {json.dumps(gq)}; its update, "
                    f"sharded vs one-process adamw_update of that "
                    f"gradient: {json.dumps(uq)}, none beyond one bf16 "
                    f"rounding; the step and gathering both whole "
                    f"{ranks[0]['whole_s']:.1f} s [{card}]")
                log(f"{label}: {cfg.name} over mesh data 1 x model "
                    f"{ST_RANKS} ({ST_RANKS} ranks on the card, gloo): held "
                    f"per rank {[round(r['held'] / 1e9, 3) for r in ranks]} "
                    f"GB of {nbytes / 1e9:.2f} GB parameters, moments "
                    f"{[round(r['held_opt'] / 1e9, 3) for r in ranks]} GB "
                    f"of {8 * n / 1e9:.2f}; step ms p50 (steps "
                    f"1-{ST_STEPS - 1}) sharded {sh_p50:.2f} vs unsharded "
                    f"{un_p50:.2f}; host-staged collectives {coll:.2f} ms a "
                    f"step ({100 * coll / sh_p50:.1f}%), "
                    f"{ranks[0]['calls']} calls and "
                    f"{ranks[0]['bytes'] / 1e9:.2f} GB staged over "
                    f"{ST_STEPS} steps; max_memory_allocated per rank (above "
                    f"what its process held before) "
                    f"{[round(r['peak'] / 2**30, 2) for r in ranks]} GiB vs "
                    f"unsharded {peak_un / 2**30:.2f} GiB; model-FLOP share "
                    f"(6 x {active / 1e9:.3f} B active x "
                    f"{ST_BATCH * ST_SEQ} tokens = {flops / 1e12:.2f} TFLOP "
                    f"a step over 989 TFLOP/s) sharded "
                    f"{share / sh_p50:.2f}%, unsharded {share / un_p50:.2f}%"
                    f" [{card}]")
                # (c) reduced float32 on the card's ranks
                for arch in ST_SMALL:
                    cfg_s = get_reduced(arch).replace(dtype="float32")
                    named = MD.init_params(
                        cfg_s, torch.Generator().manual_seed(0),
                        "cpu").state_dict()
                    # the same ranks compute on the card, then on the CPU
                    small[arch] = {"named": named, "card": ctl.gather(
                        st_small_rank, arch, named, "cuda"),
                        "cpu": ctl.gather(st_small_rank, arch, named, "cpu")}
                marks["small"] = time.perf_counter()
                # (b) the launcher over 2 data ranks: uninterrupted, then
                # the drill, which ends this world
                full = ctl.gather(st_launch_rank, ST_LAUNCH + [
                    "--steps", str(ST_LAUNCH_STEPS)])
                marks["launch"] = time.perf_counter()
                ctl.run(None, st_launch_rank, drill + ["--fail-at-step",
                                                       "4"],
                        gather=True, stats=drill_stats)
                check(False, f"{label}: --fail-at-step 4 did not exit")
        except SystemExit as e:
            # host_ranks lets the SystemExit out only when every worker
            # rank exited with the same code
            check(e.code == 17, f"{label}: the drill's world ended with "
                  f"{e.code!r}, not 17")
        marks["drill"] = time.perf_counter()
        ckd = os.path.join(ck, "ck")
        check(latest_step(ckd) == 3, f"{label}: latest checkpoint "
              f"{latest_step(ckd)}, not 3")
        check(read_manifest(ckd, 3)["process_count"] == ST_RANKS,
              f"{label}: the drill's checkpoint is not {ST_RANKS} ranks'")
        ck_bytes = dir_bytes(os.path.join(ckd, "step_00000003"))
        shutil.copytree(ckd, os.path.join(ck, "one"))
        with LM.host_ranks(ST_RANKS) as ctl:
            resumed = ctl.gather(st_launch_rank, drill)
        marks["resume"] = time.perf_counter()
        # the 2 ranks' step-3 checkpoint in one process, no ranks
        one = {}
        alone = T.main(ST_LAUNCH + ["--ckpt-dir", os.path.join(ck, "one"),
                                    "--ckpt-every", "100", "--steps", "4"],
                       stats=one)
        marks["restore alone"] = time.perf_counter()
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    lf = full[0]["losses"]
    check(all(r["losses"] == lf for r in full),
          f"{label}: the launcher's ranks disagree: "
          f"{[r['losses'] for r in full]}")
    check(len(resumed[0]["losses"]) == ST_LAUNCH_STEPS - 3,
          f"{label}: resumed {len(resumed[0]['losses'])} steps")
    rel = abs(resumed[0]["losses"][-1] - lf[-1]) / abs(lf[-1])
    rel1 = abs(alone[0] - lf[3]) / abs(lf[3])
    st = full[0]["stats"]
    l_p50 = 1e3 * statistics.median(st["step_s"][1:])
    train_p50 = ctx.get("train step ms p50")
    log(f"{label}: launcher {ARCH} ({ST_LAUNCH_LAYERS} of 32 layers) over "
        f"mesh data {ST_RANKS} x model 1 (FSDP): losses {lf}; step ms p50 "
        f"{l_p50:.2f} vs the train phase's unsharded 32 layers "
        f"{'%.2f' % train_p50 if train_p50 else 'not measured in this run'}"
        f"; host-staged collectives "
        f"{1e3 * full[0]['coll_s'] / ST_LAUNCH_STEPS:.2f} ms a step on "
        f"average ({full[0]['calls']} calls, "
        f"{full[0]['bytes'] / 1e9:.2f} GB over {ST_LAUNCH_STEPS} steps); "
        f"max_memory_allocated per rank "
        f"{[round(r['peak'] / 2**30, 2) for r in full]} GiB [{card}]")
    log(f"{label}: drill: every rank exited 17 at step 4; resumed at 3 to "
        f"{resumed[0]['losses'][-1]!r} vs {lf[-1]!r} (rel {rel:.3e}); the "
        f"2-rank step-3 checkpoint in one process: {alone!r} vs the 2-rank "
        f"run's step 3 {lf[3]!r} (rel {rel1:.3e}); checkpoint {ck_bytes} "
        f"bytes ({ST_RANKS} shard files), write s (rank 0) "
        f"{[round(x, 2) for x in drill_stats['save_s']]}, read s "
        f"{resumed[0]['stats']['restore_s']:.2f} over {ST_RANKS} ranks, "
        f"{one['restore_s']:.2f} in one process [{card}]")
    check(rel <= TRAIN_REL, f"{label}: resumed final loss off by rel "
          f"{rel:.3e} > {TRAIN_REL}")
    check(len(alone) == 1 and rel1 <= TRAIN_REL, f"{label}: the 2-rank "
          f"checkpoint in one process off by rel {rel1:.3e} > {TRAIN_REL}")
    # (c) against the unsharded CPU run
    for arch in ST_SMALL:
        plain = st_small_rank(arch, small[arch]["named"], None)
        runs = small[arch]["card"] + small[arch]["cpu"]
        worst = max(abs(a - b) / abs(b) for run in runs
                    for got, want in zip(run, plain)
                    for a, b in zip(got, want))
        log(f"{label}: reduced float32 {arch}, {ST_STEPS} steps (loss, grad "
            f"norm): card ranks {runs[0]}, CPU ranks {runs[ST_RANKS]}, "
            f"unsharded CPU {plain}; worst rel {worst:.3e} [{card}]")
        check(worst <= ST_SMALL_REL, f"{label}: reduced {arch} off by rel "
              f"{worst:.3e} > {ST_SMALL_REL}")
    marks["small unsharded"] = time.perf_counter()
    prev, secs = t_phase, {}
    for k, t in marks.items():
        secs[k] = round(t - prev, 1)
        prev = t
    log(f"{label}: phase {time.perf_counter() - t_phase:.1f} s, seconds per "
        f"part {json.dumps(secs)}")


def st_check_sharded(label, ranks, un, n, nbytes, lim_loss, lim_gn):
    """(a)'s checks: no kernel launched; each rank holds about half the
    parameter and moment bytes; the ranks agree; every step's loss and
    gradient norm within the limits of the unsharded run's."""
    for r in ranks:
        check(not any(r["launches"].values()), f"{label}: the training "
              f"path launched a kernel: {r['launches']}")
        check(abs(r["held"] - nbytes / ST_RANKS) < 0.01 * nbytes,
              f"{label}: rank {r['coords']} holds {r['held']} parameter "
              f"bytes of {nbytes}")
        check(abs(r["held_opt"] - 8 * n / ST_RANKS) < 0.01 * 8 * n,
              f"{label}: rank {r['coords']} holds {r['held_opt']} moment "
              f"bytes of {8 * n}")
        check([(x["loss"], x["grad_norm"]) for x in r["rows"]] ==
              [(x["loss"], x["grad_norm"]) for x in ranks[0]["rows"]],
              f"{label}: the ranks' metrics differ")
    rows = list(zip(ranks[0]["rows"], un))
    for i, (a, b) in enumerate(rows):
        log(f"  {label} step {i}: loss sharded {a['loss']!r} vs unsharded "
            f"{b['loss']!r} (|diff| {abs(a['loss'] - b['loss']):.3e}, limit "
            f"{lim_loss:.3e}); grad norm {a['grad_norm']!r} vs "
            f"{b['grad_norm']!r} (|diff| "
            f"{abs(a['grad_norm'] - b['grad_norm']):.3e}, limit "
            f"{lim_gn:.3e}); ce / moe_lb / moe_z sharded "
            f"{[a[k] for k in ('ce', 'moe_lb', 'moe_z')]}, unsharded "
            f"{[b[k] for k in ('ce', 'moe_lb', 'moe_z')]}")
    for i, (a, b) in enumerate(rows):
        st_close(f"{label} step {i}", a["loss"], b["loss"], lim_loss, "loss")
        st_close(f"{label} step {i}", a["grad_norm"], b["grad_norm"], lim_gn,
                 "grad norm")

# ---------------------------------------------------------------------------
# phase 16: shard_gqa — query heads split over KV heads that do not, and
# speculation over ranks
# ---------------------------------------------------------------------------

GQA_ARCH = "glm4-9b"
GQA_LAYERS = 4                  # of the 40: 4 x 0.408 B + 2 x 0.621 B params
GQA_RANKS = 4                   # mesh data 1 x model 4 on the one card
GQA_REQUESTS = 8                # the first 8 of the 12: one batch of slots
# (b)'s requests: the first 2 (the 40-layer draft's catch-up prefills
# over 4 ranks cost seconds a row; the whole script keeps to its time)
GQA_SPEC_REQUESTS = 2
GQA_LOCAL = (8, 1, 128)         # a rank's query heads, KV heads, head_dim
GQA_KERNELS = ("flash_attention", "paged_flash_decode", "paged_flash_verify")


def gqa_fleet(model_axis, **kw):
    """glm4-9b at published widths cut to ``GQA_LAYERS`` layers, paged,
    kernels 1-3 on (``attn_impl="pallas"``, ``decode_impl="flash_paged"``),
    over ``model_axis`` ranks."""
    from repro_torch.models.config import BlockSpec, LayerGroup
    from repro_torch.serving.fleet import LocalFleet
    ov = {"attn_impl": "pallas",
          "groups": (LayerGroup((BlockSpec("attn", "dense"),), GQA_LAYERS),)}
    return LocalFleet([GQA_ARCH], reduced=False, batch=BATCH,
                      max_seq=MAX_SEQ, gen_tokens=GEN,
                      decode_impl="flash_paged", model_axis=model_axis,
                      arch_overrides={GQA_ARCH: ov}, **kw)


def kv_pool_bytes(cache):
    """One rank: the bytes of its KV block pools (every layer's k and v)."""
    return sum(t.numel() * t.element_size() for key, group in cache.items()
               if key.startswith("g") for leaves in group.values()
               for t in leaves.values())


def draft_param_bytes(shard):
    return sum(p.numel() * p.element_size()
               for p in shard.draft_params.parameters())


def free_card():
    """One rank: drop what it no longer references and return the
    allocator's cached blocks to the card (the ranks share it)."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def gqa_kernels(rows, launches, card):
    """(c) Kernels 1-3 at a rank's local shape (8 query heads over 1 KV
    head of 128): each against its plain version (bf16), kernel 3's
    positions against kernel 2 bitwise, then timed with its plain version
    and SDPA (``time_flash`` / ``time_paged``: CUDA events, L2 flushed);
    the timing launches are taken back out of the counts."""
    import torch
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    from repro_torch.kernels.flash_decode.ops import (
        paged_flash_decode, paged_flash_decode_plain, paged_flash_verify,
        paged_flash_verify_plain)
    wrappers = tuple(kernel_wrappers().values())
    saved = [fn.launches for fn in wrappers]
    dt, dname = torch.bfloat16, "bfloat16"
    gen = torch.Generator(device="cuda").manual_seed(9)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    Hq, Hkv, hd = GQA_LOCAL
    S = PROMPT_CAP
    q, k, v = (_rand((1, S, h, hd), dt, gen) for h in (Hq, Hkv, Hkv))
    err1, ok = _compare(flash_attention(q, k, v, causal=True),
                        flash_attention_plain(q, k, v, causal=True), TOL[dname])
    log(f"  shard_gqa flash_attention {dname} q {tuple(q.shape)} k "
        f"{tuple(k.shape)} causal: max_abs_err {err1:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"shard_gqa flash_attention at the rank's shape: {err1}")
    dec = decode_case(dt, gen, GQA_LOCAL)
    out = paged_flash_decode(*dec)
    err2, ok = _compare(out, paged_flash_decode_plain(*dec), TOL[dname])
    zeros = bool((out[dec[4] == 0] == 0).all().item())
    log(f"  shard_gqa paged_flash_decode {dname} q {tuple(dec[0].shape)} "
        f"pool {tuple(dec[1].shape)}: max_abs_err {err2:.3e}, kv_len==0 rows "
        f"exact zeros: {zeros} {'ok' if ok and zeros else 'FAIL'}")
    check(ok and zeros, f"shard_gqa paged_flash_decode: {err2} {zeros}")
    ver = verify_case(dt, gen, heads=GQA_LOCAL)
    err3 = hold_verify("shard_gqa paged_flash_verify", paged_flash_verify,
                       paged_flash_verify_plain, paged_flash_decode, *ver,
                       dname)
    res = {"flash_attention": (err1, time_flash(
        f"{GQA_ARCH} rank of {GQA_RANKS}", S, GQA_LOCAL, gen, flush, card)),
        "paged_flash_decode": (err2, time_paged(
            f"paged_flash_decode {GQA_ARCH} rank {Hq}/{Hkv} heads hd {hd}",
            *dec, flush, card)),
        "paged_flash_verify": (err3, time_paged(
            f"paged_flash_verify {GQA_ARCH} rank {Hq}/{Hkv} heads hd {hd}",
            *ver[0], *ver[1], ver[2], flush, card))}
    for fn, n in zip(wrappers, saved):
        fn.launches = n
    source = {"flash_attention": "flash_attention.cu",
              "paged_flash_decode": "paged_decode.cu",
              "paged_flash_verify": "paged_decode.cu"}
    replaces = {
        "flash_attention":
            "src/repro/kernels/flash_attention/flash_attention.py:144",
        "paged_flash_decode": "src/repro/kernels/flash_decode/ops.py:193",
        "paged_flash_verify": "src/repro/kernels/flash_decode/ops.py:306"}
    for name, (err, (ms, plain, lib, t_ops, t_bytes)) in res.items():
        rows.append({"name": name, "phase": "shard_gqa", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/" + source[name],
                     "replaces": replaces[name],
                     "launches": launches.get(name, 0), "max_abs_err": err,
                     "ms": ms, "plain_ms": plain,
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops > t_bytes
                     else "bytes", "library_ms": lib})


def phase_shard_gqa(rows, card, ctx):
    """GQA query heads split over the model axis while the KV heads do
    not, on one card: glm4-9b at published widths (32 query / 2 KV heads
    of 128) cut to ``GQA_LAYERS`` layers, paged, kernels 1-3 on.  (a) The
    first ``GQA_REQUESTS`` requests served alone in this process, then
    over 4 ranks (mesh data 1 x model 4: each rank 8 query heads and the
    one KV head they read, its pools holding that head): tokens equal or
    a near-tie (twice the unsharded member's bf16 logit error, as the
    ``shard`` phase), launches of kernels 1 and 2 on every rank, peak
    memory and KV-pool bytes per rank, the collectives' share of a step;
    one profiled request.  (b) The same sharded fleet with
    ``SpecConfig("glm4-9b", k=4)``: the draft is the registry config at
    all 40 layers, sharded over the same ranks; the first
    ``GQA_SPEC_REQUESTS`` requests, their tokens equal to (a)'s sharded
    ones or a near-tie of the sharded target's logits, kernel 3 launched
    on every rank, acceptance.  (c)
    Kernels 1-3 at the rank's local shape (``gqa_kernels``).  Returns the
    phase's launches (summed over its ranks)."""
    import torch
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as MD
    from repro_torch.serving.scheduler import SpecConfig
    label = "shard_gqa"
    t_phase = time.perf_counter()
    marks = {}
    free_card()
    # (a) unsharded, in this process
    t0 = time.perf_counter()
    fleet = gqa_fleet(1)
    m = fleet.members[GQA_ARCH]
    nparams = sum(p.numel() for p in m.params.parameters())
    log(f"{label}: unsharded {GQA_ARCH} ({GQA_LAYERS} of 40 layers, "
        f"{nparams / 1e9:.3f} B params) built + warmed up in "
        f"{time.perf_counter() - t0:.1f} s")
    want, ids, rep_u = shard_serve(f"{label} unsharded", fleet, card,
                                   GQA_ARCH, GQA_KERNELS[:2], GQA_REQUESTS)
    probe = list(ids[0])
    ref_logits = last_logits(m.cfg, m.params, None, probe)
    peak_u = torch.cuda.max_memory_allocated()
    e32 = bf16_logit_error(m.cfg, m.params,
                           [list(i) + list(w[:-1]) for i, w in zip(ids, want)],
                           [len(i) - 1 for i in ids])
    tie = 2 * e32
    log(f"{label}: unsharded bf16 vs float32 logits over the served "
        f"sequences' decision positions: max abs diff {e32:.4e}; near-tie "
        f"limit 2 x that = {tie:.4e}")
    del fleet, m
    free_card()
    marks["unsharded"] = time.perf_counter()
    counts = {k: 0 for k in GQA_KERNELS}
    with LM.host_ranks(GQA_RANKS, device="cuda") as ctl:
        t0 = time.perf_counter()
        fleet = gqa_fleet(GQA_RANKS)
        m = fleet.members[GQA_ARCH]
        shard = m.shard
        attn = m.params.blocks[0].attn
        cfg = m.cfg
        layout = MD.kv_layout(cfg, fleet.mesh, MAX_SEQ, paged=True)
        pool = fleet.schedulers[GQA_ARCH].cache["g0"]["b0"]["k"]
        log(f"{label}: {GQA_ARCH} over mesh {fleet.mesh.shape} built + warmed "
            f"up in {time.perf_counter() - t0:.1f} s; a rank's wq "
            f"{tuple(attn['wq'].shape)} {attn['wq']._spec}, wk "
            f"{tuple(attn['wk'].shape)} {attn['wk']._spec}, paged layout "
            f"{layout!r}, pool {tuple(pool.shape)}")
        check(fleet.mesh.shape == {"data": 1, "model": GQA_RANKS}
              and tuple(attn["wq"].shape) == (cfg.d_model,
                                               GQA_LOCAL[0] * cfg.head_dim)
              and tuple(attn["wk"].shape) == (cfg.d_model, cfg.n_kv_heads
                                               * cfg.head_dim)
              and layout == "group" and pool.shape[-2:] == GQA_LOCAL[1:],
              f"{label}: the rank's blocks are not the GQA group layout")
        ctl.gather(free_card)
        got, ids_a, rep_a = shard_serve(f"{label} sharded", fleet, card,
                                        GQA_ARCH, GQA_KERNELS[:2],
                                        GQA_REQUESTS)
        check([list(i) for i in ids_a] == [list(i) for i in ids],
              f"{label}: prompts differ between the runs")
        la = rep_a["launches"]
        check(all(v > 0 for r in la for v in r.values()) and
              all(r == la[0] for r in la),
              f"{label}: launches per rank {la} (expected equal, non-zero)")
        for r in la:
            for k_, v in r.items():
                counts[k_] += v
        pools = ctl.run(None, kv_pool_bytes, fleet.schedulers[GQA_ARCH].cache,
                        gather=True)
        shard_logits = ctl.run(shard, "apply", shard_last_logits, probe)
        err = float((shard_logits - ref_logits).abs().max())
        log(f"{label}: last-position logits sharded vs unsharded, max abs "
            f"diff {err:.4e} (limit {tie:.4e})")
        check(err <= tie, f"{label}: sharded logits off the unsharded by "
              f"{err:.4e}, above {tie:.4e}")
        shard_near_tie(f"{label} sharded vs unsharded", got, want, ids,
                       lambda seq: ctl.run(shard, "apply",
                                           shard_last_logits, seq), tie)
        log(f"{label}: per rank max_memory_allocated "
            f"{[round(p / 2**30, 3) for p in rep_a['peaks']]} GiB (unsharded "
            f"{peak_u / 2**30:.3f} GiB), KV-pool bytes {pools} (unsharded "
            f"{pools[0] * cfg.n_kv_heads}); TTFT p50 ms sharded "
            f"{rep_a['ttft_p50']:.1f} vs unsharded {rep_u['ttft_p50']:.1f}; "
            f"TPOT p50 ms {rep_a['tpot_p50']:.2f} vs {rep_u['tpot_p50']:.2f}; "
            f"decode step p50 {rep_a['step_ms']:.2f} ms, host-staged "
            f"collectives {rep_a['coll_ms']:.2f} ms "
            f"({100 * rep_a['coll_ms'] / rep_a['step_ms']:.1f}%) [{card}]")
        profile_run(f"{label} profile (rank 0): one sharded request, its "
                    f"prefill and one decode step",
                    lambda: fleet.generate(GQA_ARCH, prompts_of(GQA_ARCH)[:1],
                                           max_new=2))
        del fleet, m, shard, attn, pool
        ctl.gather(free_card)
        marks["sharded"] = time.perf_counter()
        # (b) speculative over the same ranks, the 40-layer draft sharded
        t0 = time.perf_counter()
        fleet = gqa_fleet(GQA_RANKS, warmup=False,
                          speculative=SpecConfig(GQA_ARCH, k=W_SPEC - 1))
        m = fleet.members[GQA_ARCH]
        sched = fleet.schedulers[GQA_ARCH]
        dcfg = m.spec.cfg
        held = ctl.run(m.shard, "apply", draft_param_bytes, gather=True)
        log(f"{label}: speculative fleet, draft {dcfg.name} "
            f"({len(m.spec.params.blocks)} layers, {dcfg.dtype}, "
            f"decode_impl {dcfg.decode_impl}) over the same ranks: draft "
            f"bytes per rank {[round(b / 1e9, 3) for b in held]} GB, built "
            f"+ warmed up in {time.perf_counter() - t0:.1f} s")
        ctl.gather(free_card)
        toks_b, _, rep_b = shard_serve(f"{label} speculative", fleet, card,
                                       GQA_ARCH, GQA_KERNELS,
                                       GQA_SPEC_REQUESTS)
        lb = rep_b["launches"]
        for r in lb:
            for k_, v in r.items():
                counts[k_] += v
        acc = sched.spec_accepted / max(1, sched.spec_offered)
        plain = got[:GQA_SPEC_REQUESTS]
        same = shard_near_tie(
            f"{label} speculative vs sharded plain", toks_b, plain, ids,
            lambda seq: ctl.run(m.shard, "apply", shard_last_logits, seq),
            tie)
        log(f"{label}: speculative k = {W_SPEC - 1}: {sched.spec_rounds} "
            f"rounds, offered {sched.spec_offered}, accepted "
            f"{sched.spec_accepted} (acceptance {acc:.3f}), "
            f"spec_tokens_per_round {sched.spec_tokens_per_round:.2f}; TPOT "
            f"p50 ms {rep_b['tpot_p50']:.2f} vs plain sharded "
            f"{rep_a['tpot_p50']:.2f}; kernel 3 launches per rank "
            f"{[r['paged_flash_verify'] for r in lb]}; tokens equal to the "
            f"sharded plain fleet's for {same}/{len(plain)} requests; "
            f"per rank max_memory_allocated "
            f"{[round(p / 2**30, 3) for p in rep_b['peaks']]} GiB [{card}]")
        check(sched.spec_rounds > 0 and
              all(r["paged_flash_verify"] > 0 for r in lb),
              f"{label}: kernel 3 did not launch on every rank: {lb}")
        del fleet, m, sched
        ctl.gather(free_card)
        marks["speculative"] = time.perf_counter()
    # (c) the kernels at a rank's local shape
    gqa_kernels(rows, counts, card)
    marks["kernels"] = time.perf_counter()
    prev, secs = t_phase, {}
    for k_, t in marks.items():
        secs[k_] = round(t - prev, 1)
        prev = t
    log(f"{label}: phase {time.perf_counter() - t_phase:.1f} s, seconds per "
        f"part {json.dumps(secs)}; launches over its ranks "
        f"{json.dumps(counts)}")
    ctx["shard_gqa launches"] = counts


# ---------------------------------------------------------------------------
# phase 17: shard_mixers — SSM and cross-attention members over the model axis
# ---------------------------------------------------------------------------

VISION = "llama-3.2-vision-90b"
MIX_RANKS = 2                   # mesh data 1 x model 2 on the one card
MIX_ARCHS = (JAMBA, XLSTM, AUD, VISION)
MIX_REQUESTS = {JAMBA: 8, XLSTM: 4, AUD: 4, VISION: 4}
# kernel 1 at a rank's shapes on this phase's path, one launch per layer
# of ``mixer`` in the config's ``stack`` and request: (arch, stack, mixer,
# S, (Hq, Hkv, hd), causal).  S None: the prompt's width (jamba's exact,
# vision's bucketed), held at each width the path gave and timed at
# PROMPT_CAP.  Whisper's decoder pads its one-token BOS prompt to the
# first prefill bucket, 16.
MIX_FLASH = ((JAMBA, "groups", "attn", None, (16, 4, 128), True),
             (AUD, "encoder_groups", "bidir_attn", 1500, (3, 3, 64), False),
             (AUD, "groups", "attn", 16, (3, 3, 64), True),
             (VISION, "groups", "attn", None, (32, 4, 128), True))
# the sharded member's teacher-forced logits against the unsharded
# member's float32 ones: this many times its own bf16 logit error
FORCED_TOL = 1.5
_FLASH_SPY = []                 # this rank's (wrapper, calls) while spied
# jamba cut to one period over 2 ranks, reckoned from the widths: 7 mamba
# layers x (h: 8 rows x 4096 channels x 16 states x 4 B + conv: 8 x 3 x
# 4096 x 2 B) and 1 attention layer x k, v (8 x 512 x 4 KV heads x 128 x
# 2 B) a rank
JAMBA_STATE_BYTES = 7 * (8 * 4096 * 16 * 4 + 8 * 3 * 4096 * 2)
JAMBA_KV_BYTES = 8 * 512 * 4 * 128 * 2 * 2


def mixer_fleet(archs, model_axis):
    """The full-width members ``archs`` of ``MIX_ARCHS`` (jamba, xlstm,
    vision cut by depth, whisper whole), kernel 1 on, in one fleet over
    ``model_axis`` ranks (1: this process alone)."""
    from repro_torch.serving.fleet import LocalFleet
    ov = {JAMBA: {"groups": cut_groups(JAMBA, 8), "attn_impl": "pallas"},
          XLSTM: {"groups": cut_groups(XLSTM, 2)},
          AUD: {"attn_impl": "pallas"},
          VISION: {"groups": cut_groups(VISION, 5), "attn_impl": "pallas"}}
    return LocalFleet(list(archs), reduced=False, batch=BATCH,
                      max_seq=MAX_SEQ, gen_tokens=GEN,
                      model_axis=model_axis,
                      arch_overrides={a: ov[a] for a in archs})


def mixer_requests(arch, ref):
    """The requests this phase serves to ``arch``: the first of
    ``payloads``, or the audio lane's payloads ``ref["prompts"]``."""
    if arch != AUD:
        return payloads(arch)[:MIX_REQUESTS[arch]]
    return [{"model": AUD, "messages": [{"role": "user", "content": p}]}
            for p in ref["prompts"]]


def mixer_contexts(fleet, arch, ref):
    """Each request's cross-attention context on the card: the audio
    lane's frames of its payload, a vision member's zero patches (a text
    prompt brings none: ``serve_lib.context_or_zeros``, as the row
    prefill), None for the others."""
    from repro_torch.serving.serve_lib import context_or_zeros
    if arch == AUD:
        return [fleet.lanes[AUD]._frames(p) for p in ref["prompts"]]
    cfg = fleet.members[arch].cfg
    if cfg.cross_ctx_len:
        return [context_or_zeros(cfg, None, 1, "cuda")] * MIX_REQUESTS[arch]
    return None


def mixer_unsharded(label, arch, card):
    """``arch`` alone in this process: its requests served, then the
    tokens, ids and bf16 logit error they are held against
    (``unsharded_tokens``); freed."""
    ref = {"prompts": audio_texts()[:MIX_REQUESTS[AUD]]} if arch == AUD \
        else {}
    t0 = time.perf_counter()
    fleet = mixer_fleet([arch], 1)
    m = fleet.members[arch]
    toks, ids, _ = shard_serve(f"{label} {arch} unsharded", fleet, card,
                               arch, ("flash_attention",),
                               MIX_REQUESTS[arch], mixer_requests(arch, ref))
    ref.update(unsharded_tokens(m, toks, ids, MIX_REQUESTS[arch],
                                mixer_contexts(fleet, arch, ref)))
    log(f"{label}: unsharded {arch} served in this process in "
        f"{time.perf_counter() - t0:.1f} s")
    del fleet, m
    free_card()
    return ref


def contig_last_logits(shard, ids, cross=None):
    """One rank: whole-vocabulary float32 logits of the last position of
    ``ids``, a contiguous prefill of the member's blocks into a scratch
    cache (``cross``: the request's context, ``mixer_contexts``); the
    vocab shards gathered."""
    import torch
    from repro_torch.models import model as MD
    from repro_torch.serving.serve_lib import on_mesh
    cfg = shard.cfg
    cache = MD.init_cache(cfg, 1, MAX_SEQ, shard.device, mesh=shard.mesh)
    with on_mesh(shard.mesh):
        logits, _ = MD.prefill(cfg, shard.params, torch.tensor(
            [list(ids)], dtype=torch.int32, device=shard.device), cache,
            cross, moe_impl=shard.moe_impl)
        logits = logits.float()
        if logits.shape[-1] != cfg.vocab_size:
            logits = shard.mesh.all_gather(logits, "model", dim=-1)
    return logits[0].cpu()


def mixer_state_bytes(cache):
    """One rank: the bytes of the mamba states (``h``, ``conv``) and of the
    attention KV cache (``k``, ``v``) of a member's contiguous cache."""
    out = {"mamba": 0, "kv": 0}
    for key, group in cache.items():
        if not key.startswith("g"):
            continue
        for leaves in group.values():
            for leaf, t in leaves.items():
                kind = {"h": "mamba", "conv": "mamba", "k": "kv",
                        "v": "kv"}.get(leaf)
                if kind:
                    out[kind] += t.numel() * t.element_size()
    return out


def rule_param_bytes(cfg, model):
    """The bytes of one rank's blocks of every parameter of ``cfg`` under
    ``sharding.rules`` over ``data 1 x model``."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as MD
    from repro_torch.sharding import rules as R
    mesh = Mesh({"data": 1, "model": model})
    total = 0
    for name, p in MD.Model(cfg, "meta").named_parameters():
        spec = R.param_spec(cfg, name, tuple(p.shape), mesh)
        total += math.prod(R.block_shape(tuple(p.shape), spec, mesh)) * \
            p.element_size()
    return total


def check_jamba_rank_bytes(label, ctl, fleet, card):
    """Jamba's per-rank state, KV and parameter bytes equal to the
    reckoned figures, exactly."""
    from repro_torch.models import ssm as S
    m = fleet.members[JAMBA]
    cfg = m.cfg
    di, _, N = S.mamba_dims(cfg)
    blocks = [s.mixer for g in cfg.groups for _ in range(g.repeats)
              for s in g.period]
    di_r, K = di // MIX_RANKS, cfg.mamba_d_conv
    want_state = blocks.count("mamba") * (BATCH * di_r * N * 4 +
                                          BATCH * (K - 1) * di_r * 2)
    want_kv = blocks.count("attn") * 2 * BATCH * MAX_SEQ * (
        cfg.n_kv_heads // MIX_RANKS) * cfg.head_dim * 2
    state = ctl.run(None, mixer_state_bytes, fleet.schedulers[JAMBA].cache,
                    gather=True)
    held = ctl.run(m.shard, "apply", shard_param_bytes, gather=True)
    want_params = rule_param_bytes(cfg, MIX_RANKS)
    whole = rule_param_bytes(cfg, 1)
    log(f"{label}: {JAMBA} per rank: mamba h + conv "
        f"{[r['mamba'] for r in state]} B (reckoned {want_state}, "
        f"unsharded {want_state * MIX_RANKS}), "
        f"attention k + v {[r['kv'] for r in state]} B (reckoned "
        f"{want_kv}), parameters {held} B (the rules' blocks "
        f"{want_params}, of {whole} B whole) [{card}]")
    check(want_state == JAMBA_STATE_BYTES and want_kv == JAMBA_KV_BYTES,
          f"{label}: the reckoning from the widths ({want_state}, "
          f"{want_kv}) is not {JAMBA_STATE_BYTES}, {JAMBA_KV_BYTES}")
    check(all(r == {"mamba": want_state, "kv": want_kv} for r in state),
          f"{label}: per-rank state bytes {state}")
    check(all(h == want_params for h in held),
          f"{label}: per-rank parameter bytes {held} != {want_params}")


def mixer_layers(cfg, stack, mixer):
    """The layers of ``mixer`` in ``cfg``'s ``stack`` of groups."""
    return sum(g.repeats * sum(s.mixer == mixer for s in g.period)
               for g in getattr(cfg, stack) or ())


def rank_flash_spy(on):
    """One rank: with ``on``, records (S, Hq, Hkv, hd, causal) of every
    kernel 1 call the model makes (the wrapper still counts the
    launches); without, takes the spy off and returns the calls."""
    from repro_torch.models import model as MD
    if not on:
        real, calls = _FLASH_SPY
        MD.flash_attention = real
        _FLASH_SPY.clear()
        return calls
    real, calls = MD.flash_attention, []

    def spy(q, k, *args, **kw):
        calls.append((q.shape[1], q.shape[2], k.shape[2], q.shape[3],
                      bool(kw["causal"])))
        return real(q, k, *args, **kw)

    _FLASH_SPY[:] = [real, calls]
    MD.flash_attention = spy
    return None


def mixer_launches(label, arch, cfg, calls, launched):
    """Each rank's kernel 1 calls (``rank_flash_spy``) sorted to ``arch``'s
    rows of ``MIX_FLASH``: on every rank each row has one launch per layer
    and request, every call falls in a row, and the calls are as many as
    the wrapper counted.  Returns {row index: [launches over the ranks,
    widths seen]}."""
    rows = [i for i, r in enumerate(MIX_FLASH) if r[0] == arch]
    out = {i: [0, set()] for i in rows}
    n = MIX_REQUESTS[arch]
    for rank, (rc, nl) in enumerate(zip(calls, launched)):
        check(len(rc) == nl, f"{label}: rank {rank}: {len(rc)} kernel 1 "
              f"calls, {nl} launches counted")
        matched = 0
        for i in rows:
            _, stack, mixer, S, heads, causal = MIX_FLASH[i]
            mine = [c for c in rc if c[1:] == (*heads, causal) and
                    (c[0] == S if S else c[0] <= PROMPT_CAP)]
            layers = mixer_layers(cfg, stack, mixer)
            check(len(mine) == layers * n,
                  f"{label}: rank {rank}: {len(mine)} kernel 1 launches at "
                  f"{arch}'s {stack} {mixer} shape, not {layers} layers x "
                  f"{n} requests")
            out[i][0] += len(mine)
            out[i][1].update(c[0] for c in mine)
            matched += len(mine)
        check(matched == len(rc), f"{label}: rank {rank}: {arch} called "
              f"kernel 1 at shapes outside its rows: {sorted(set(rc))}")
    return out


def forward_logits(shard, seqs, starts, crosses=None):
    """One rank: the member's teacher-forced whole-vocabulary float32
    logits over positions ``starts[i]:`` of each sequence of ``seqs`` (one
    ``forward`` each on the rank's blocks, ``crosses[i]`` its context; the
    vocab shards gathered), on the host."""
    import torch
    from repro_torch.models import model as MD
    from repro_torch.serving.serve_lib import on_mesh
    cfg, out = shard.cfg, []
    with on_mesh(shard.mesh), torch.no_grad():
        for i, (seq, st) in enumerate(zip(seqs, starts)):
            toks = torch.tensor([list(seq)], dtype=torch.int32,
                                device=shard.device)
            lg = MD.forward(cfg, shard.params, toks,
                            None if crosses is None else crosses[i],
                            moe_impl=shard.moe_impl)[0][0, st:].float()
            if lg.shape[-1] != cfg.vocab_size:
                lg = shard.mesh.all_gather(lg, "model", dim=-1)
            out.append(lg.cpu())
    return out


def check_forced_logits(label, ctl, m, ref, contexts, card):
    """The sharded member's teacher-forced logits over the unsharded
    member's served sequences against that member's float32 logits
    (``unsharded_tokens``), within ``FORCED_TOL`` times its own bf16
    logit error: a fault in a split that greedy tokens hide behind a
    near-tie shows here.  Returns the error."""
    low = ctl.run(m.shard, "apply", forward_logits, ref["seqs"],
                  ref["starts"], contexts)
    err = max(float((a - b).abs().max())
              for a, b in zip(low, ref["logits32"]))
    limit = FORCED_TOL * ref["e32"]
    log(f"{label}: teacher-forced logits over {len(low)} sequences, "
        f"sharded bf16 vs unsharded float32: max abs {err:.4e} "
        f"({err / ref['e32']:.3f} x the unsharded bf16 error "
        f"{ref['e32']:.4e}; limit {limit:.4e}) "
        f"{'ok' if err <= limit else 'FAIL'} [{card}]")
    check(err <= limit, f"{label}: sharded teacher-forced logits {err} "
          f"off the float32 ones, limit {limit}")
    return err


def mixer_kernels(rows, seen, card):
    """Kernel 1 at a rank's local shapes of this phase (``MIX_FLASH``),
    each against its plain version (bf16) at the row's width and at every
    width the path gave it, then timed with its plain version and SDPA
    (``time_flash``); the timing launches are taken back out of the
    counts.  ``seen``: per row, the phase's launches over its ranks and
    the widths seen (``mixer_launches``)."""
    import torch
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    wrappers = tuple(kernel_wrappers().values())
    saved = [fn.launches for fn in wrappers]
    dt, dname = torch.bfloat16, "bfloat16"
    gen = torch.Generator(device="cuda").manual_seed(13)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for i, (arch, stack, mixer, S, heads, causal) in enumerate(MIX_FLASH):
        Hq, Hkv, hd = heads
        S = S or PROMPT_CAP
        launches, widths = seen[i]
        kind = "causal" if causal else "bidirectional"
        errs = []
        for w in sorted(widths | {S}):
            q, k, v = (_rand((1, w, h, hd), dt, gen) for h in (Hq, Hkv, Hkv))
            err, ok = _compare(flash_attention(q, k, v, causal=causal),
                               flash_attention_plain(q, k, v, causal=causal),
                               TOL[dname])
            errs.append(err)
            check(ok, f"shard_mixers flash_attention at {arch}'s {stack} "
                  f"{mixer} rank shape, S {w}: {err}")
        log(f"  shard_mixers flash_attention {dname} {arch} {stack} {mixer} "
            f"rank q (1, S, {Hq}, {hd}) k (1, S, {Hkv}, {hd}) {kind} at S "
            f"{sorted(widths | {S})}: max_abs_err {max(errs):.3e} ok")
        ms, plain, lib, t_ops, t_bytes = time_flash(
            f"{arch} {stack} {mixer} rank of {MIX_RANKS}", S, heads, gen,
            flush, card, causal=causal, note=f", launches {launches} over "
            f"the ranks in shard_mixers at S {sorted(widths)}")
        rows.append({"name": "flash_attention", "phase": "shard_mixers",
                     "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/"
                               "flash_attention.cu",
                     "replaces": "src/repro/kernels/flash_attention/"
                                 "flash_attention.py:144",
                     "launches": launches, "max_abs_err": max(errs),
                     "ms": ms, "plain_ms": plain,
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops > t_bytes
                     else "bytes", "library_ms": lib})
    for fn, n in zip(wrappers, saved):
        fn.launches = n


def phase_shard_mixers(rows, card, ctx):
    """SSM, cross-attention and encoder members over the model axis on
    one card, at published widths: jamba-v0.1-52b cut to one period (8 of
    32 layers), xlstm-350m cut to one period (2 of 24), whisper-tiny
    whole (4 + 4 layers, 1500 frames) and llama-3.2-vision-90b cut to one
    period (5 of 100 layers).  (a) Each member's unsharded tokens: the
    contig phase's (jamba, xlstm) and the audio phase's (whisper) from
    ``ctx``, else served here alone (vision always).  (b) One
    ``LocalFleet(model_axis=2)`` holding all four over 2 ranks (data 1 x
    model 2): each member's requests (jamba 8, the others 4; whisper's
    through its audio lane) with launch counts zeroed just before and
    read just after; tokens equal to the unsharded ones or a near-tie
    (twice the unsharded member's bf16 logit error, the ``shard``
    phase's rule); the sharded member's teacher-forced logits within
    ``FORCED_TOL`` x that error of the unsharded float32 ones; kernel 1
    at each of ``MIX_FLASH``'s rank shapes once per layer and request on
    every rank (whisper: encoder and decoder self-attention); TTFT / TPOT
    p50, the collectives' share of a decode step, per-rank peak memory;
    jamba's per-rank state, KV and parameter bytes exactly as reckoned.
    (c) Kernel 1 at the rank's shapes (``mixer_kernels``).  Returns
    nothing; ``ctx["shard_mixers launches"]`` holds the phase's launches
    over its ranks."""
    from repro_torch.launch import mesh as LM
    label = "shard_mixers"
    t_phase = time.perf_counter()
    marks = {}
    free_card()
    refs = dict(ctx.get("mixers", {}))
    for arch in MIX_ARCHS:
        if arch in refs:
            log(f"{label}: unsharded {arch} tokens of the "
                f"{'audio' if arch == AUD else 'contig'} phase; its bf16 "
                f"logit error {refs[arch]['e32']:.4e}")
        else:
            refs[arch] = mixer_unsharded(label, arch, card)
    marks["unsharded"] = time.perf_counter()
    counts, seen, forced = {}, {}, {}
    with LM.host_ranks(MIX_RANKS, device="cuda") as ctl:
        t0 = time.perf_counter()
        fleet = mixer_fleet(MIX_ARCHS, MIX_RANKS)
        check(fleet.mesh.shape == {"data": 1, "model": MIX_RANKS},
              f"{label}: mesh {fleet.mesh.shape}")
        sizes = {a: sum(p.numel() for p in fleet.members[a].params
                        .parameters()) for a in MIX_ARCHS}
        log(f"{label}: {', '.join(MIX_ARCHS)} over mesh {fleet.mesh.shape} "
            f"built + warmed up in {time.perf_counter() - t0:.1f} s; rank "
            f"0's parameters (B) "
            f"{json.dumps({a: round(n / 1e9, 3) for a, n in sizes.items()})}")
        marks["build"] = time.perf_counter()
        ctl.gather(free_card)
        for arch in MIX_ARCHS:
            ref, m = refs[arch], fleet.members[arch]
            check(not m.paged, f"{label}: {arch} is not on the contiguous "
                  f"cache")
            ctl.gather(rank_flash_spy, True)
            got, ids, rep = shard_serve(
                f"{label} {arch} sharded", fleet, card, arch,
                ("flash_attention",), MIX_REQUESTS[arch],
                mixer_requests(arch, ref))
            calls = ctl.gather(rank_flash_spy, False)
            check([list(i) for i in ids] == [list(i) for i in ref["ids"]],
                  f"{label}: {arch}'s prompts differ between the runs")
            la = rep["launches"]
            launched = [r["flash_attention"] for r in la]
            check(all(x == launched[0] for x in launched) and
                  all((x > 0) == (arch != XLSTM) for x in launched),
                  f"{label}: {arch}'s kernel 1 launches per rank "
                  f"{launched}")
            counts[arch] = sum(launched)
            seen.update(mixer_launches(label, arch, m.cfg, calls, launched))
            tie = 2 * ref["e32"]
            contexts = mixer_contexts(fleet, arch, ref)
            shard_near_tie(
                f"{label} {arch} sharded vs unsharded", got, ref["tokens"],
                ids, lambda seq, c=None, sh=m.shard: ctl.run(
                    sh, "apply", contig_last_logits, seq, c), tie,
                contexts=contexts)
            forced[arch] = check_forced_logits(
                f"{label} {arch}", ctl, m, ref, contexts, card)
            log(f"{label}: {arch}: TTFT p50 ms {rep['ttft_p50']:.1f}, TPOT "
                f"p50 ms {rep['tpot_p50']:.2f}; decode step p50 "
                f"{rep['step_ms']:.2f} ms, host-staged collectives "
                f"{rep['coll_ms']:.2f} ms "
                f"({100 * rep['coll_ms'] / rep['step_ms']:.1f}%); prefill "
                f"p50 {rep['prefill_ms']:.2f} ms ({rep['prefill_coll_ms']:.2f}"
                f" in collectives); per rank max_memory_allocated "
                f"{[round(p / 2**30, 3) for p in rep['peaks']]} GiB; kernel 1 "
                f"launches per rank {launched}; near-tie limit {tie:.4e} "
                f"[{card}]")
            if arch == JAMBA:
                check_jamba_rank_bytes(label, ctl, fleet, card)
            marks[arch] = time.perf_counter()
        del fleet, m
        ctl.gather(free_card)
    marks["ranks down"] = time.perf_counter()
    mixer_kernels(rows, seen, card)
    marks["kernels"] = time.perf_counter()
    prev, secs = t_phase, {}
    for k_, t in marks.items():
        secs[k_] = round(t - prev, 1)
        prev = t
    log(f"{label}: phase {time.perf_counter() - t_phase:.1f} s, seconds per "
        f"part {json.dumps(secs)}; kernel 1 launches over its ranks "
        f"{json.dumps(counts)}; teacher-forced max abs logit error "
        f"{json.dumps(forced)}")
    ctx["shard_mixers launches"] = {"flash_attention": sum(counts.values())}


# ---------------------------------------------------------------------------
# phase 18: times
# ---------------------------------------------------------------------------

def time_ms(fn, flush, reps=25, warm=3):
    """Median ms of ``fn`` over ``reps`` CUDA-event timed runs, each after
    overwriting a 128 MB buffer (the serving path finds KV cold in L2).
    A ~1 ms spin kernel queued before the start event keeps the card busy
    while the host enqueues ``fn``, so the events time the device's work
    and not the host's launch overhead."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def ptxas_lines(name):
    """One line per kernel of ``csrc/<name>.cu`` from its build log: the
    (mangled) function, ``ptxas``'s stack and spill line, and its register
    and shared-memory line."""
    from repro_torch.kernels import _build
    logf = _build.BUILD_DIR / f"{name}.log"
    if not logf.exists():
        return []
    out, fn, spill = [], "?", ""
    for line in logf.read_text(errors="replace").splitlines():
        line = line.strip()
        if "Function properties for" in line:
            fn, spill = line.split("Function properties for", 1)[1].strip(), ""
        elif "spill" in line:
            spill = line
        elif "registers" in line:
            out.append(f"{fn}: {spill}; {line.split(':', 1)[-1].strip()}")
    return out


def time_flash(arch, S, heads, gen, flush, card, causal=True, note=""):
    """Kernel 1 (bf16, B = 1) at ``arch``'s (Hq, Hkv, hd) and S tokens,
    causal or bidirectional: kernel, plain version and SDPA over the
    repeated KV heads, and the bound from the kernel's cost function (q,
    k, v and out once; QK^T and PV over the causal half, or every pair).
    Returns (ms, plain, lib, t_ops, t_bytes)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_cost, flash_attention_plain)
    Hq, Hkv, hd = heads
    dt = torch.bfloat16
    q = _rand((1, S, Hq, hd), dt, gen)
    k = _rand((1, S, Hkv, hd), dt, gen)
    v = _rand((1, S, Hkv, hd), dt, gen)
    ms = time_ms(lambda: flash_attention(q, k, v, causal=causal), flush)
    plain = time_ms(lambda: flash_attention_plain(q, k, v, causal=causal),
                    flush)
    G = Hq // Hkv
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal), flush)
    flops, nbytes, dname = flash_attention_cost(q, k, v, causal=causal)
    t_ops = flops / PEAK_OPS[dname] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"times flash_attention bf16 {arch} {Hq}/{Hkv} heads hd {hd} S={S} "
        f"{'causal' if causal else 'bidirectional'}: kernel {ms:.4f} ms, "
        f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound "
        f"{max(t_ops, t_bytes):.6f} ms "
        f"({'operations' if t_ops > t_bytes else 'bytes'}: {flops:.4e} FLOP, "
        f"{nbytes} B){note} [{card}]")
    return ms, plain, lib, t_ops, t_bytes


def time_paged(label, q, kpool, vpool, tbl, kv_len, flush, card):
    """Kernel 2 (q (B, Hq, hd)) or kernel 3 (q (B, W, Hq, hd)): kernel,
    plain version and SDPA over the gathered view with a per-position
    mask (rows whose frontier is 0 come out NaN there; timing only), and
    the bound: live K/V of the last position plus q and out once, FLOPs
    of every position's frontier.  Returns (ms, plain, lib, t_ops,
    t_bytes)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode.ops import (
        gather_kv, paged_attn_cost, paged_flash_decode,
        paged_flash_decode_plain, paged_flash_verify,
        paged_flash_verify_plain)
    kern, plain_fn = ((paged_flash_decode, paged_flash_decode_plain)
                      if q.dim() == 3 else
                      (paged_flash_verify, paged_flash_verify_plain))
    ms = time_ms(lambda: kern(q, kpool, vpool, tbl, kv_len), flush)
    plain = time_ms(lambda: plain_fn(q, kpool, vpool, tbl, kv_len), flush)
    q4 = q[:, None] if q.dim() == 3 else q
    B, W, Hq, hd = q4.shape
    Hkv = kpool.shape[2]
    S = tbl.shape[1] * kpool.shape[1]
    frontier = (kv_len[:, None] - W + 1 + torch.arange(W, device="cuda")
                [None]).clamp(0, S)                           # (B, W)
    kg = gather_kv(kpool, tbl).repeat_interleave(Hq // Hkv, dim=2)
    vg = gather_kv(vpool, tbl).repeat_interleave(Hq // Hkv, dim=2)
    kg, vg = kg.transpose(1, 2).contiguous(), vg.transpose(1, 2).contiguous()
    mask = (torch.arange(S, device="cuda")[None, None] <
            frontier[:, :, None])[:, None]                    # (B,1,W,S)
    qt = q4.transpose(1, 2).contiguous()
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kg, vg, attn_mask=mask), flush)
    live = int(frontier[:, -1].sum())            # keys of the last position
    flops, nbytes, dname = paged_attn_cost(q, kpool, vpool, tbl, kv_len)
    t_ops = flops / PEAK_OPS[dname] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"times {label} {str(q.dtype).split('.')[-1]} B={B} W={W} "
        f"max_seq {S} live keys {live}: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, sdpa over gathered view (per-position mask) "
        f"{lib:.4f} ms, bound {max(t_ops, t_bytes):.6f} ms "
        f"({'operations' if t_ops > t_bytes else 'bytes'}: {nbytes} B) "
        f"[{card}]")
    return ms, plain, lib, t_ops, t_bytes


def time_mla(label, q_lat, q_rope, ckv_pool, krope_pool, tbl, kv_len,
             scale, flush, card):
    """Kernel 4 (q (B, H, r)) or kernel 5 (q (B, W, H, r)): kernel, plain
    version and SDPA over the gathered latent view (one KV head broadcast
    to all H query heads: q = [q_lat | q_rope], k = [ckv | krope], v =
    ckv) with a per-position mask (rows whose frontier is 0 come out NaN
    there; timing only), and the bound from the kernel's cost function
    (``paged_mla_cost``: the live latent of the last position plus q and
    out once, FLOPs of every position's frontier).  Returns (ms, plain,
    lib, t_ops, t_bytes)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode.ops import (
        gather_kv, paged_flash_decode_mla, paged_flash_decode_mla_plain,
        paged_flash_verify_mla, paged_flash_verify_mla_plain,
        paged_mla_cost)
    decode = q_lat.dim() == 3
    kern, plain_fn = ((paged_flash_decode_mla, paged_flash_decode_mla_plain)
                      if decode else
                      (paged_flash_verify_mla, paged_flash_verify_mla_plain))
    args = (q_lat, q_rope, ckv_pool, krope_pool, tbl, kv_len)
    ms = time_ms(lambda: kern(*args, scale=scale), flush)
    plain = time_ms(lambda: plain_fn(*args, scale=scale), flush)
    ql4, qr4 = (q_lat[:, None], q_rope[:, None]) if decode else (q_lat, q_rope)
    B, W, H, r = ql4.shape
    rh = qr4.shape[3]
    S = tbl.shape[1] * ckv_pool.shape[1]
    frontier = (kv_len[:, None] - W + 1 + torch.arange(W, device="cuda")
                [None]).clamp(0, S)                           # (B, W)
    qs = torch.cat([ql4, qr4], -1).transpose(1, 2).contiguous()
    ks = torch.cat([gather_kv(ckv_pool, tbl), gather_kv(krope_pool, tbl)],
                   -1)[:, None].contiguous()
    vs = gather_kv(ckv_pool, tbl)[:, None].contiguous()
    mask = (torch.arange(S, device="cuda")[None, None] <
            frontier[:, :, None])[:, None]                    # (B,1,W,S)
    try:
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, scale=scale, enable_gqa=True), flush)
    except RuntimeError as e:
        log(f"times {label}: SDPA refused the latent shapes (q/k width "
            f"{r + rh}, v width {r}): {e}")
        lib = None
    live = int(frontier[:, -1].sum())            # keys of the last position
    flops, nbytes, dname = paged_mla_cost(*args)
    t_ops = flops / PEAK_OPS[dname] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"times {label} {dname} B={B} W={W} H={H} r={r} rh={rh} max_seq {S} "
        f"live keys {live}: kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa "
        f"over gathered view (per-position mask) "
        f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
        f"{max(t_ops, t_bytes):.6f} ms "
        f"({'operations' if t_ops > t_bytes else 'bytes'}: {nbytes} B) "
        f"[{card}]")
    return ms, plain, lib, t_ops, t_bytes


def time_ssm(gen, flush, card):
    """One layer of each recurrent mixer at its config's published widths
    (bf16, plain PyTorch: the reference scans in ``lax.scan`` and
    ``associative_scan``, no Pallas kernel): the chunked prefill forward
    of one row at S = 64 and 256 (one chunk each) and the decode step over
    8 rows, median of CUDA-event runs (log lines)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as MD
    from repro_torch.models import ssm as S
    from repro_torch.models.config import BlockSpec
    dt = torch.bfloat16
    for arch, mixer in ((JAMBA, "mamba"), (XLSTM, "mlstm"), (XLSTM, "slstm")):
        cfg = get_config(arch)
        blk = MD.Block(cfg, BlockSpec(mixer, "none"), dt, "cuda")
        p = getattr(blk, mixer)
        MD._ssm_init(cfg, p, S.ssm_leaves(cfg, mixer, None), gen)
        forward, step = S.FORWARD[mixer]
        times = {}
        for n in (64, 256):
            x = _rand((1, n, cfg.d_model), dt, gen)
            times[f"prefill S={n}"] = time_ms(
                lambda: forward(p, cfg, x, return_state=True), flush,
                reps=10)
        x1 = _rand((BATCH, 1, cfg.d_model), dt, gen)
        st = S.zero_state(cfg, mixer, BATCH, dt, "cuda")
        times[f"decode step B={BATCH}"] = time_ms(
            lambda: step(p, cfg, x1, st), flush)
        log(f"times {mixer} ({arch}, d {cfg.d_model}, one layer, bf16, "
            f"plain PyTorch): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
            + f" [{card}]")


def phase_times(rows, errs, launches, card, ctx):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode.ops import (
        flash_decode, flash_decode_cost, flash_decode_plain, gather_kv,
        mla_geometry)
    from repro_torch.kernels.multi_lora.ops import (multi_lora,
                                                    multi_lora_cost,
                                                    multi_lora_plain)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    dt = torch.bfloat16
    esz = 2
    wrappers = tuple(kernel_wrappers().values())
    saved = [fn.launches for fn in wrappers]

    def row(name, source, replaces, ms, plain, lib, t_ops, t_bytes):
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": launches.get(name, 0),
                     "max_abs_err": errs.get(name), "ms": ms,
                     "plain_ms": plain, "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops > t_bytes else "bytes",
                     "library_ms": lib})

    # flash attention at the fleet's prefill widths: B=1, causal, S = 16,
    # 64 and the longest prefill, 479 (the JSON row)
    for line in ptxas_lines("flash_attention"):
        log(f"times ptxas flash_attention: {line}")
    for S in (16, 64, PROMPT_CAP):
        res = time_flash("smollm-360m", S, (15, 5, 64), gen, flush, card)
    row("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:144", *res)

    # kernels 2 and 3 at the fleets' shapes (phase 2's rows; the JSON
    # rows), then at the wide table (log lines)
    for line in ptxas_lines("paged_decode"):
        log(f"times ptxas paged_decode: {line}")
    for name, W, replaces in (
            ("paged_flash_decode", 0, "src/repro/kernels/flash_decode/ops.py:193"),
            ("paged_flash_verify", W_SPEC,
             "src/repro/kernels/flash_decode/ops.py:306")):
        if W:
            (q,), (kpool, vpool, tbl), kv_len, _ = verify_case(dt, gen)
        else:
            q, kpool, vpool, tbl, kv_len = decode_case(dt, gen)
        res = time_paged(name, q, kpool, vpool, tbl, kv_len, flush, card)
        row(name, "src/repro_torch/kernels/csrc/paged_decode.cu", replaces,
            *res)
        time_paged(f"{name} wide", *wide_case(dt, gen, W), flush, card)
    # kernels 1 and 2 at the router fleet's other GQA shapes (log lines)
    for arch, heads in FLEET_HEADS.items():
        time_flash(arch, PROMPT_CAP, heads, gen, flush, card)
        time_paged(f"paged_flash_decode {arch} {heads[0]}/{heads[1]} heads "
                   f"hd {heads[2]}", *decode_case(dt, gen, heads), flush,
                   card)
    # kernel 1 at the whisper encoder's bidirectional shape (the audio
    # phase's launches) and at jamba's attention layer, causal, at the
    # longest prefill (log lines)
    time_flash(AUD, ENC_SHAPE[1], (ENC_SHAPE[2], ENC_SHAPE[2], ENC_SHAPE[3]),
               gen, flush, card, causal=False,
               note=f", launches {ctx.get('audio encoder launches', 0)} in "
                    f"the audio phase")
    time_flash(JAMBA, PROMPT_CAP, (32, 8, 128), gen, flush, card,
               note=f", launches {ctx.get('jamba launches', 0)} in the "
                    f"contig phase at widths {ctx.get('jamba widths')}")
    # the recurrent mixers' scans, which have no kernel (log lines)
    time_ssm(gen, flush, card)

    # kernels 4 and 5 at deepseek's widths: decode at the MLA fleet's
    # decode shapes (phase 2's full-width rows), verify at W = 5 over the
    # same latent pool (the JSON rows); then each at the wide table (log
    # lines)
    for line in ptxas_lines("paged_mla_decode"):
        log(f"times ptxas paged_mla_decode: {line}")
    H, r, rh, _ = mla_shapes()
    for name, W, replaces in (
            ("paged_flash_decode_mla", 0,
             "src/repro/kernels/flash_decode/ops.py:412"),
            ("paged_flash_verify_mla", W_SPEC,
             "src/repro/kernels/flash_decode/ops.py:521")):
        if W:
            qs, rest, kv_len, kw = verify_case(dt, gen, mla=True)
            args = (*qs, *rest, kv_len, kw["scale"])
        else:
            args = mla_decode_case(dt, gen)
        for max_blocks in (MAX_SEQ // BLOCK, WIDE_SEQ // BLOCK):
            geo = mla_geometry(max_blocks, BLOCK, max(W, 1) * H, r, rh, esz)
            log(f"times paged_mla_decode geometry W={max(W, 1)} H={H} "
                f"max_seq {max_blocks * BLOCK}: {geo}")
        res = time_mla(name, *args, flush, card)
        row(name, "src/repro_torch/kernels/csrc/paged_mla_decode.cu",
            replaces, *res)
        time_mla(f"{name} wide", *mla_wide_case(dt, gen, W), flush, card)

    # multi-adapter LoRA at the encoder path's shape: off the path first,
    # bf16 and float32 with the rows shuffled (every tile holds all T
    # tasks: one pass over x per task); last float32 sorted, as the path
    # runs it (the JSON row)
    for line in ptxas_lines("multi_lora"):
        log(f"times ptxas multi_lora: {line}")
    for dname, layout in (("bfloat16", "sorted"), ("float32", "shuffled"),
                          ("float32", "sorted")):
        dtype = getattr(torch, dname)
        x, a, b, ids = lora_path_case(dtype, gen)
        if layout == "shuffled":
            ids = ids[torch.randperm(ids.numel(), generator=gen,
                                     device="cuda")].contiguous()
        (N, din), (T, _, r), dout = x.shape, a.shape, b.shape[2]
        ms = time_ms(lambda: multi_lora(x, a, b, ids), flush)
        plain = time_ms(lambda: multi_lora_plain(x, a, b, ids), flush)
        onehot = F.one_hot(ids.long(), T).to(dtype)
        # library: the reference encoder's own form in one call
        # (encoder.py:151)
        lib = time_ms(lambda: torch.einsum("nd,tdr,tro,nt->no", x, a, b,
                                           onehot), flush)
        flops, nbytes, _ = multi_lora_cost(x, a, b, ids)
        t_ops = flops / PEAK_OPS[dname] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        per_req = launches.get("multi_lora", 0) / max(1, ctx.get(
            "signals requests", 1))
        # the same bytes in one device copy: the floor the card reaches
        dst = torch.empty_like(x)
        copy_ms = time_ms(lambda: dst.copy_(x), flush)
        log(f"times multi_lora {dname} N={N} din={din} dout={dout} T={T} "
            f"r={r} (rows {layout} by task): kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, einsum nd,tdr,tro,nt->no {lib:.4f} ms, copy_ "
            f"of x into an (N, dout) tensor {copy_ms:.4f} ms, bound "
            f"{max(t_ops, t_bytes):.6f} ms "
            f"({'operations' if t_ops > t_bytes else 'bytes'}: {nbytes} B, "
            f"{flops} FLOP), launches {launches.get('multi_lora', 0)} "
            f"({per_req:.2f} per request) [{card}]")
    rows.append({"name": "multi_lora", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/multi_lora.cu",
                 "replaces": "src/repro/kernels/multi_lora/multi_lora.py:60",
                 "launches": launches.get("multi_lora", 0),
                 "max_abs_err": errs.get("multi_lora"), "ms": ms,
                 "plain_ms": plain, "bound_ms": max(t_ops, t_bytes),
                 "bound_by": "operations" if t_ops > t_bytes else "bytes",
                 "library_ms": lib})

    # the contiguous flash_decode wrapper (kernel 1 with Sq = 1) at the
    # fleet's decode shape over a contiguous cache; no path calls it
    q, kpool, vpool, tbl, kv_len = decode_case(dt, gen)
    kv_len = kv_len.clamp(min=1)
    k, v = gather_kv(kpool, tbl).contiguous(), gather_kv(vpool, tbl).contiguous()
    ms = time_ms(lambda: flash_decode(q, k, v, kv_len), flush)
    plain = time_ms(lambda: flash_decode_plain(q, k, v, kv_len), flush)
    kg = k.repeat_interleave(3, dim=2).transpose(1, 2).contiguous()
    vg = v.repeat_interleave(3, dim=2).transpose(1, 2).contiguous()
    mask = (torch.arange(MAX_SEQ, device="cuda")[None] <
            kv_len[:, None])[:, None, None, :]
    q4 = q[:, :, None, :].contiguous()
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        q4, kg, vg, attn_mask=mask), flush)
    live = int(kv_len.sum())
    flops, nbytes, _ = flash_decode_cost(q, k, v, kv_len)
    t_ops = flops / PEAK_OPS["bfloat16"] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"times flash_decode (contiguous, kernel 1 with Sq = 1) bf16 "
        f"B={BATCH} live keys {live}: kernel {ms:.4f} ms, plain {plain:.4f} "
        f"ms, sdpa {lib:.4f} ms, bound {max(t_ops, t_bytes):.6f} ms "
        f"({'operations' if t_ops > t_bytes else 'bytes'}) [{card}]")
    # and at the reference's DECODE_CASES, bf16
    for B, Skv, Hq, Hkv, hd in DECODE_CASES:
        q = _rand((B, Hq, hd), dt, gen)
        k, v = (_rand((B, Skv, Hkv, hd), dt, gen) for _ in range(2))
        kv_len = torch.randint(1, Skv + 1, (B,), generator=gen, device="cuda",
                               dtype=torch.int32)
        ms = time_ms(lambda: flash_decode(q, k, v, kv_len), flush)
        plain = time_ms(lambda: flash_decode_plain(q, k, v, kv_len), flush)
        G = Hq // Hkv
        kg = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
        vg = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
        mask = (torch.arange(Skv, device="cuda")[None] <
                kv_len[:, None])[:, None, None, :]
        q4 = q[:, :, None, :].contiguous()
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q4, kg, vg, attn_mask=mask), flush)
        live = int(kv_len.sum())
        flops, nbytes, _ = flash_decode_cost(q, k, v, kv_len)
        t_ops = flops / PEAK_OPS["bfloat16"] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"times flash_decode bf16 B={B} Skv={Skv} {Hq}/{Hkv} heads hd "
            f"{hd} live keys {live}: kernel {ms:.4f} ms, plain {plain:.4f} "
            f"ms, sdpa {lib:.4f} ms, bound {max(t_ops, t_bytes):.6f} ms "
            f"({'operations' if t_ops > t_bytes else 'bytes'}) [{card}]")
    # timing launches are not main-path launches
    for fn, n in zip(wrappers, saved):
        fn.launches = n


# ---------------------------------------------------------------------------
# phase 19: roofline — the main path's steps on the H100 roofline
# ---------------------------------------------------------------------------

ROOF_RUNS = 10            # timed runs of a step (median of CUDA events)
ROOF_SHARE_MAX = 1.05     # bound / measured above this: the model overcounts
ROOF_MATMUL_REL = 0.01    # matmul FLOPs against the profiler's
ROOF_MATMULS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
# the decode rows' depths: the fleet's longest prefill down to a short one
ROOF_LENS = (PROMPT_CAP, 300, 200, 100, 37, 128, 250, 400)
# dry-run cells traced on the meta device (CPU work, in subprocesses that
# run beside the card's steps); in the first two the query heads split
# over the model axis of 16 while the KV heads stay whole
ROOF_CELLS = (("qwen3-1.7b", "decode_32k"),
              ("qwen3-moe-235b-a22b", "train_4k"),
              ("smollm-360m", "decode_32k"),
              ("deepseek-v2-236b", "train_4k"))


def roof_meta(step_of, cfg, *state):
    """The meta twin of ``step_of(cfg, params, *state)``: the parameters
    as meta tensors, the state's small integers as host values."""
    from repro_torch.models import model as MD
    from repro_torch.roofline import steps as ST
    values = {}
    twin = [ST.meta_of(x, values) for x in state]
    return step_of(cfg, MD.Model(cfg, "meta"), *twin), values


def roof_step(label, step, meta, mf, card, banned=()):
    """One step on the roofline: CUDA-event median over ROOF_RUNS runs,
    the profiler's device-busy time and matmul FLOPs, ``CostMode`` on the
    card (FLOPs by dtype, bytes, bound and its term, predicted peak) held
    to the meta twin's count exactly and to the profiler's matmul FLOPs
    within ROOF_MATMUL_REL, the share bound / measured at most
    ROOF_SHARE_MAX, ``op_lint`` clean where ``banned`` is given, and no
    kernel built or loaded while the warmed step is replayed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.analysis import RecompileGuard, build_counters, lint_fn
    from repro_torch.roofline import steps as ST
    for _ in range(2):
        step.run()
    torch.cuda.synchronize()
    guard = RecompileGuard(build_counters())
    times = []
    for _ in range(ROOF_RUNS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step.run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    ms = statistics.median(times)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_flops=True) as prof:
        step.run()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    busy = sum(e.self_device_time_total for e in avg
               if e.device_type == DeviceType.CUDA) / 1e3
    prof_mm = sum(e.flops for e in avg if e.key in ROOF_MATMULS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cm = ST.trace(step, "cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    tot = cm.totals()
    mtot = ST.trace(meta[0], "meta", meta[1]).totals()
    check(dict(tot.flops_by_dtype) == dict(mtot.flops_by_dtype)
          and tot.bytes == mtot.bytes and tot.kernels == mtot.kernels,
          f"{label}: card trace {dict(tot.flops_by_dtype)} FLOP, "
          f"{tot.bytes} B, {tot.kernels} != meta trace "
          f"{dict(mtot.flops_by_dtype)} FLOP, {mtot.bytes} B, "
          f"{mtot.kernels}")
    check(abs(tot.matmul_flops - prof_mm) <= ROOF_MATMUL_REL * prof_mm,
          f"{label}: matmul FLOPs {tot.matmul_flops} vs the profiler's "
          f"{prof_mm}")
    share = tot.bound_s * 1e3 / ms
    check(share <= ROOF_SHARE_MAX, f"{label}: roofline share {share:.4f} "
          f"> {ROOF_SHARE_MAX}: the cost model overcounts")
    findings = []
    if banned:
        findings = lint_fn(step.run, banned_leading_shapes=banned)
        check(not findings, f"{label}: op_lint: "
              f"{[str(f) for f in findings][:4]}")
    for _ in range(3):
        step.run()
    torch.cuda.synchronize()
    misses = guard.misses()
    check(not any(v > 0 for v in misses.values()),
          f"{label}: kernel builds or loads on replay: {misses}")
    row = {"step": label, "ms": ms, "busy_ms": busy,
           "flops_by_dtype": dict(tot.flops_by_dtype), "bytes": tot.bytes,
           "t_compute_ms": tot.t_compute * 1e3,
           "t_memory_ms": tot.t_memory * 1e3, "bound_ms": tot.bound_s * 1e3,
           "bound_by": tot.bound_by, "share": share,
           "model_flop_share": mf / (ms / 1e3) / PEAK_OPS["bfloat16"],
           "matmul_flops": tot.matmul_flops, "profiler_matmul_flops": prof_mm,
           "kernels": {k: v["count"] for k, v in tot.kernels.items()},
           "ops": tot.ops, "predicted_peak_gib": cm.peak_bytes / 2**30,
           "max_memory_allocated_gib": peak / 2**30,
           "lint_findings": len(findings), "replay_builds": misses}
    log(f"roofline {label}: step p50 {ms:.3f} ms (CUDA events, "
        f"{ROOF_RUNS} runs), device busy {busy:.3f} ms under the profiler; "
        f"FLOPs {dict(tot.flops_by_dtype)} ({tot.matmul_flops} in matmuls, "
        f"profiler {prof_mm}), bytes {tot.bytes}, bound "
        f"{tot.bound_s * 1e3:.6f} ms ({tot.bound_by}: compute "
        f"{tot.t_compute * 1e3:.6f}, memory {tot.t_memory * 1e3:.6f} ms), "
        f"roofline share {share:.5f}, model-FLOP share "
        f"{row['model_flop_share']:.5f}; {tot.ops} ops, kernel regions "
        f"{row['kernels']}; predicted peak {row['predicted_peak_gib']:.3f} "
        f"GiB vs max_memory_allocated {row['max_memory_allocated_gib']:.3f} "
        f"GiB; op_lint findings {len(findings)}; card trace == meta trace "
        f"[{card}]")
    return row


def roof_cells(tmp):
    """Start the dry-run cells, one single-threaded subprocess each, off
    the card and at the lowest CPU priority (the card's steps beside them
    are host-bound)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    return [subprocess.Popen(
        ["nice", "-n", "19", sys.executable, "-m",
         "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out-dir", tmp], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
        for arch, shape in ROOF_CELLS]


def roof_read_cells(procs, tmp):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import SpecMesh
    from repro_torch.models import model as MD
    for (arch, shape), proc in zip(ROOF_CELLS, procs):
        out, _ = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"roofline: dryrun {arch} x {shape} "
              f"failed:\n{out[-3000:]}")
        refusal = [ln for ln in out.splitlines()
                   if ln.startswith("NOT-SHARDABLE")]
        if refusal:
            try:
                MD.check_shardable(get_config(arch), SpecMesh.production())
                refused = False
            except NotImplementedError:
                refused = True
            check(refused, f"roofline: dryrun {arch} x {shape} printed "
                  f"NOT-SHARDABLE for a member the model axis accepts")
            log(f"roofline dryrun {refusal[0]}")
            continue
        with open(os.path.join(tmp, f"{arch}__{shape}__16x16.json")) as f:
            rec = json.load(f)
        log(f"roofline dryrun {arch} x {shape} 16x16 (rank 0 of 256 traced "
            f"on the meta device in {rec['trace_s']:.1f} s; times projected "
            f"from H100 data-sheet peaks, not measured): FLOPs/dev "
            f"{rec['flops_per_device']:.6e} {rec['flops_by_dtype']}, bytes/dev "
            f"{rec['bytes_per_device']:.6e}, collectives "
            f"{rec['collective_counts']} "
            f"{rec['collective_bytes_per_device']:.6e} B, model FLOPs "
            f"{rec['model_flops_total']:.6e}, peak/dev "
            f"{rec['peak_memory_per_device'] / 2**30:.3f} GiB; t_compute "
            f"{rec['t_compute'] * 1e3:.3f} ms, t_memory "
            f"{rec['t_memory'] * 1e3:.3f} ms, t_collective "
            f"{rec['t_collective'] * 1e3:.3f} ms, dominant {rec['dominant']}")


def phase_roofline(card, ctx):
    """The main path's own steps at full width, each on the roofline
    (``roof_step``): (a) smollm-360m's fresh paged prefill of the fleet's
    longest prompt (479 tokens, kernel 1), (b) its batch-8 decode step
    under ``flash_paged`` (kernel 2), (d) the ``train`` phase's step at
    batch 8 x 512, then (c) the deepseek-v2 cut's batch-8 decode step (1
    dense + 7 MoE layers, kernel 4).  Meanwhile two dry-run cells are
    traced in subprocesses (``ROOF_CELLS``)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as MD
    from repro_torch.models.config import model_flops
    from repro_torch.roofline import steps as ST
    from repro_torch.training.optimizer import AdamWConfig
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="roofline-")
    procs = roof_cells(tmp)
    try:
        gc.collect()
        torch.cuda.empty_cache()
        wrappers = kernel_wrappers()
        for fn in wrappers.values():
            fn.launches = 0
        rows = []
        gen = torch.Generator(device="cuda").manual_seed(0)
        B, S = BATCH, MAX_SEQ

        def toks(cfg, shape):
            return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                 device="cuda", dtype=torch.int32)

        # (a), (b), (d): smollm-360m at full width
        cfg = get_config(ARCH).replace(attn_impl="pallas",
                                       decode_impl="flash_paged")
        params = MD.init_params(cfg, gen, "cuda")
        pcache = ST.paged_cache(cfg, 1, S, BLOCK, "cuda")
        ptoks = toks(cfg, (1, PROMPT_CAP))
        rows.append(roof_step(
            f"(a) {ARCH} paged prefill 1 x {PROMPT_CAP}",
            ST.prefill(cfg, params, pcache, ptoks),
            roof_meta(ST.prefill, cfg, pcache, ptoks),
            model_flops(cfg, PROMPT_CAP, "serve"), card))
        cache = ST.paged_cache(cfg, B, S, BLOCK, "cuda")
        ST.fill(cfg, params, cache, list(ROOF_LENS), gen)
        dtoks = toks(cfg, (B, 1))
        rows.append(roof_step(
            f"(b) {ARCH} decode B={B} flash_paged",
            ST.decode(cfg, params, cache, dtoks),
            roof_meta(ST.decode, cfg, cache, dtoks),
            model_flops(cfg, B, "serve"), card,
            banned=((B, S), (2 * B, S))))
        del cache, pcache
        tcfg = get_config(ARCH)
        opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=1)
        ttoks, labels = toks(tcfg, (B, S)), toks(tcfg, (B, S))

        def train_of(c, p, t, lab):
            return ST.train(c, p, None, t, lab, opt_cfg=opt_cfg)
        rows.append(roof_step(
            f"(d) {ARCH} train step {B} x {S}",
            train_of(tcfg, params, ttoks, labels),
            roof_meta(train_of, tcfg, ttoks, labels),
            model_flops(tcfg, B * S, "train"), card))
        del params
        gc.collect()
        torch.cuda.empty_cache()

        # (c): the deepseek-v2 cut
        t0 = time.perf_counter()
        mcfg = get_config(MLA_ARCH).replace(groups=mla_cut_groups(),
                                            decode_impl="flash_paged")
        mparams = MD.init_params(mcfg, gen, "cuda")
        mcache = ST.paged_cache(mcfg, B, S, BLOCK, "cuda")
        ST.fill(mcfg, mparams, mcache, list(ROOF_LENS), gen)
        mtoks = toks(mcfg, (B, 1))
        log(f"roofline: {MLA_ARCH} cut to {MLA_LAYERS} layers drawn and "
            f"filled in {time.perf_counter() - t0:.1f} s")
        # its latent rank r is 512 = max_seq: ban the gathered views
        # (B, S, r) and (B, S, rh), not every (B, r) activation
        r, rh = mcfg.kv_lora_rank, mcfg.rope_head_dim
        rows.append(roof_step(
            f"(c) {MLA_ARCH} cut decode B={B} flash_paged",
            ST.decode(mcfg, mparams, mcache, mtoks),
            roof_meta(ST.decode, mcfg, mcache, mtoks),
            model_flops(mcfg, B, "serve"), card,
            banned=((B, S, r), (B, S, rh), (2 * B, S, r))))
        del mparams, mcache
        gc.collect()
        torch.cuda.empty_cache()
        launched = {k: fn.launches for k, fn in wrappers.items()}
        log(f"roofline: launches {launched}")
        for name in ("flash_attention", "paged_flash_decode",
                     "paged_flash_decode_mla"):
            check(launched[name] > 0, f"roofline: {name} was not launched")
        roof_read_cells(procs, tmp)
        ctx["roofline rows"] = rows
        log(f"roofline: {json.dumps(rows)}")
        log(f"roofline: phase {time.perf_counter() - t_phase:.1f} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (card + build always run; the result lines need "
                    "every phase)")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card} | torch.cuda.get_device_name: "
        f"{torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    errs, launches, rows, ctx = {}, {}, [], {}
    try:
        phase_build()
        if "kernels" in phases:
            phase_kernels(errs)
        if "model" in phases:
            phase_model(ctx)
        if "fleet" in phases:
            phase_fleet(launches, card, ctx)
        if "spec_fleet" in phases:
            phase_spec_fleet(launches, card, ctx)
        if "signals" in phases:
            phase_signals(launches, card, ctx)
        if "mla_model" in phases:
            phase_mla_model(ctx)
        if "mla_fleet" in phases:
            phase_mla_fleet(launches, card)
        if "contig" in phases:
            phase_contig(card, ctx)
        if "router" in phases:
            if "qos" in phases or "audio" in phases:
                ctx["keep router"] = True
            phase_router(launches, card, ctx)
        if "qos" in phases:
            if "audio" in phases:
                ctx["keep router after qos"] = True
            phase_qos(card, ctx)
        if "audio" in phases:
            phase_audio(card, ctx)
        if "train" in phases:
            phase_train(card, ctx)
        if "shard" in phases:
            phase_shard(card, ctx)
            for k, v in ctx["shard launches"].items():
                launches[k] = launches.get(k, 0) + v
        if "shard_train" in phases:
            phase_shard_train(card, ctx)
        if "shard_gqa" in phases:
            phase_shard_gqa(rows, card, ctx)
            for k, v in ctx["shard_gqa launches"].items():
                launches[k] = launches.get(k, 0) + v
        if "shard_mixers" in phases:
            phase_shard_mixers(rows, card, ctx)
            for k, v in ctx["shard_mixers launches"].items():
                launches[k] = launches.get(k, 0) + v
        if "times" in phases:
            phase_times(rows, errs, launches, card, ctx)
        if "roofline" in phases:
            phase_roofline(card, ctx)
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    torch.cuda.synchronize()
    log(f"chip_smoke: phases {phases} passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    if set(phases) != set(PHASES):
        return 0                       # a partial run prints no result
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
