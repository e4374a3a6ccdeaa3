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
   (causal, and lens + window) and decode over the fleet's table.
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
9. router: ``SemanticRouter.route_batch`` end to end, built by
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
   tokens equal).
10. times: kernel, plain version and one PyTorch library call at the
   paths' shapes (median of CUDA-event timings, L2 flushed before each
   run), beside each kernel's bound; kernel 1 at S = 16, 64 and 479 and
   the contiguous ``flash_decode`` at the fleet's decode shape and at
   DECODE_CASES, kernels 2-5 also at the wide table (log lines beside
   the rows), kernels 1 and 2 also at the qwen3-1.7b and glm4-9b shapes
   (log lines), with ``ptxas``'s registers for ``flash_attention.cu``,
   ``paged_decode.cu``, ``paged_mla_decode.cu`` (and its launch geometry)
   and ``multi_lora.cu``; kernel 6 also in bf16 and with shuffled ids at
   the path's shape (log lines).

The last two lines are one JSON object with a row per kernel, then
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX and
nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

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
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
W_SPEC = 5                                # verify width: pending token + k = 4
# the wide table of kernels 2-5: every row at 2048 keys (C = 8, P = 16)
WIDE_SEQ = 2048
WIDE_BLOCKS = 1 + BATCH * (WIDE_SEQ // BLOCK)
PHASES = ("kernels", "model", "fleet", "spec_fleet", "signals", "mla_model",
          "mla_fleet", "router", "times")
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
    shapes: B=1, Hq=15, Hkv=5, hd=64, causal, S in the width buckets; plus
    one lens + window case in which every query row sees a key."""
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


def verify_case(dtype, gen, full=True, mla=False):
    """decode_case's / mla_decode_case's table and pools with W = 5 query
    positions per row.  kv_len (the TOTAL length, the 5 new entries
    included) covers dead positions (kv_len 1 and 3: the first positions'
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
    _, kpool, vpool, tbl, _ = decode_case(dtype, gen)
    tbl[0] = 0
    return ((_rand((BATCH, W_SPEC, 15, 64), dtype, gen),), (kpool, vpool, tbl),
            kv_len, {})


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


def phase_mla_model():
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
        verify_vs_decode(f"mla_model {MLA_ARCH} {dname}", paths, params,
                         caches, MLA_MODEL_TOL[dname])
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


def profile_run(label, fn):
    """Device busy share, the top kernels by device time and the port's
    own kernels (``csrc/*.cu``, in an anonymous namespace) while ``fn``
    runs under torch.profiler.  Its overhead inflates the wall time, so
    the busy share is a floor; only device-side events are summed (a CPU
    op's device time repeats its kernels').  Returns (wall ms, busy ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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


def profile_fleet(fleet, prompts, arch=ARCH, max_new=8):
    """``profile_run`` over the fleet serving one batch (8 prompts, one
    per slot, ``max_new`` tokens)."""
    profile_run(f"profile: {len(prompts)} requests x {max_new} tokens",
                lambda: fleet.generate(arch, prompts, max_new=max_new))


def served_batch(label, fleet, arch, kernels, card):
    """The 12 requests through ``batch_call`` with ``kernels`` (name ->
    wrapper) counted from zero just before and read just after.  Logs
    answers, launches, pool and latency numbers and checks 12 answers of
    32 tokens, every kernel launched and a clean pool.  Returns (launch
    counts, tokens per request, prompt ids per request)."""
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
    stats = sched.pool.stats
    log(f"{label}: {len(answers)} answers, tokens each {sorted(set(ntok))}, "
        f"launches {json.dumps(counts)}, live_refs "
        f"{sched.pool.live_refs()}, cached_tokens {stats.cached_tokens}, "
        f"cow_copies {stats.cow_copies}, prefill calls "
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
    check(sched.pool.live_refs() == 0, f"{label}: blocks leaked after drain")
    check(stats.cached_tokens > 0 and stats.cow_copies > 0,
          f"{label}: the prefix-hit suffix prefill / COW copy did not run")
    return counts, [list(s.out) for s in seqs], [s.ids for s in seqs]


def prompts_of(arch=ARCH):
    return [" ".join(m["content"] for m in r["messages"])
            for r in payloads(arch)]


def reduced_card_vs_cpu(label, arch, overrides, card_kernels=None,
                        speculative=None, per_round=None):
    """Small input against the reference path: a reduced float32 fleet with
    the kernels on the card (speculative when ``speculative`` is given)
    vs the plain fleet on the CPU, token for token.  ``card_kernels``
    (name -> wrapper) are counted on the card run; each must launch, and
    ``per_round`` times the speculative rounds when given."""
    from repro_torch.serving.fleet import LocalFleet
    ov = {arch: dict(overrides, dtype="float32")}
    prompts = prompts_of(arch)
    outs, counts = {}, {}
    for dev, spec in (("cuda", speculative), ("cpu", None)):
        small = LocalFleet([arch], batch=4, gen_tokens=8, warmup=False,
                           decode_impl="flash_paged", arch_overrides=ov,
                           speculative=spec, device=dev)
        for fn in (card_kernels or {}).values():
            fn.launches = 0
        outs[dev] = [o["tokens"] for o in small.generate(arch, prompts)]
        sched = small.schedulers[arch]
        if dev == "cuda":
            counts = {n: fn.launches for n, fn in (card_kernels or {}).items()}
            spec_rounds = sched.spec_rounds
        check(sched.pool.live_refs() == 0, f"{label}: reduced fleet leaked")
    same = outs["cuda"] == outs["cpu"]
    what = "speculative " if speculative is not None else ""
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
# phase 9: the router — route_batch over four full-width members
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
    finally:
        router.close()
    del router, fleet, encoder
    gc.collect()
    torch.cuda.empty_cache()
    reduced_router_card_vs_cpu("router")


# ---------------------------------------------------------------------------
# phase 5: times
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


def time_flash(arch, S, heads, gen, flush, card):
    """Kernel 1 (bf16, B = 1, causal) at ``arch``'s (Hq, Hkv, hd) and S
    tokens: kernel, plain version and SDPA over the repeated KV heads, and
    the bound (q, k, v and out once; the causal half of QK^T and PV).
    Returns (ms, plain, lib, t_ops, t_bytes)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    Hq, Hkv, hd = heads
    dt = torch.bfloat16
    q = _rand((1, S, Hq, hd), dt, gen)
    k = _rand((1, S, Hkv, hd), dt, gen)
    v = _rand((1, S, Hkv, hd), dt, gen)
    ms = time_ms(lambda: flash_attention(q, k, v, causal=True), flush)
    plain = time_ms(lambda: flash_attention_plain(q, k, v, causal=True),
                    flush)
    G = Hq // Hkv
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), flush)
    flops = 4 * hd * Hq * S * (S + 1) / 2
    nbytes = (2 * S * Hq * hd + 2 * S * Hkv * hd) * q.element_size()
    t_ops = flops / PEAK_OPS["bfloat16"] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"times flash_attention bf16 {arch} {Hq}/{Hkv} heads hd {hd} S={S}: "
        f"kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound "
        f"{max(t_ops, t_bytes):.6f} ms "
        f"({'operations' if t_ops > t_bytes else 'bytes'}) [{card}]")
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
        gather_kv, paged_flash_decode, paged_flash_decode_plain,
        paged_flash_verify, paged_flash_verify_plain)
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
    esz = q.element_size()
    nbytes = (2 * live * Hkv * hd + 2 * B * W * Hq * hd) * esz + \
        (tbl.numel() + kv_len.numel()) * 4
    flops = 4 * Hq * hd * int(frontier.sum())
    t_ops = flops / PEAK_OPS[str(q.dtype).split(".")[-1]] * 1e3
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
    there; timing only), and the bound: the live latent of the last
    position plus q and out once, FLOPs of every position's frontier.
    Returns (ms, plain, lib, t_ops, t_bytes)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode.ops import (
        gather_kv, paged_flash_decode_mla, paged_flash_decode_mla_plain,
        paged_flash_verify_mla, paged_flash_verify_mla_plain)
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
    dname = str(q_lat.dtype).split(".")[-1]
    live = int(frontier[:, -1].sum())            # keys of the last position
    nbytes = (live * (r + rh) + B * W * H * (2 * r + rh)) * \
        q_lat.element_size() + (tbl.numel() + kv_len.numel()) * 4
    flops = int(frontier.sum()) * H * (2 * (r + rh) + 2 * r)
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


def phase_times(rows, errs, launches, card, ctx):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode.ops import (
        flash_decode, flash_decode_plain, gather_kv, mla_geometry)
    from repro_torch.kernels.multi_lora.ops import multi_lora, multi_lora_plain
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
        xsz = x.element_size()
        nbytes = (N * din + N * dout + T * r * (din + dout)) * xsz + N * 4
        flops = 2 * N * r * (din + dout)
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
    nbytes = (2 * live * 5 * 64 + 2 * BATCH * 15 * 64) * esz + \
        kv_len.numel() * 4
    t_ops = 4 * 15 * 64 * live / PEAK_OPS["bfloat16"] * 1e3
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
        nbytes = (2 * live * Hkv * hd + 2 * B * Hq * hd) * esz + B * 4
        t_ops = 4 * Hq * hd * live / PEAK_OPS["bfloat16"] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"times flash_decode bf16 B={B} Skv={Skv} {Hq}/{Hkv} heads hd "
            f"{hd} live keys {live}: kernel {ms:.4f} ms, plain {plain:.4f} "
            f"ms, sdpa {lib:.4f} ms, bound {max(t_ops, t_bytes):.6f} ms "
            f"({'operations' if t_ops > t_bytes else 'bytes'}) [{card}]")
    # timing launches are not main-path launches
    for fn, n in zip(wrappers, saved):
        fn.launches = n


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
            phase_mla_model()
        if "mla_fleet" in phases:
            phase_mla_fleet(launches, card)
        if "router" in phases:
            phase_router(launches, card, ctx)
        if "times" in phases:
            phase_times(rows, errs, launches, card, ctx)
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
