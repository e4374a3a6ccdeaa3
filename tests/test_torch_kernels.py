"""The port's kernel modules on the CPU: the plain versions against the JAX
kernels and oracles, and the wrappers' device dispatch.

On a CPU tensor each wrapper runs its plain version; the CUDA kernels
themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  Inputs are drawn with numpy from fixed seeds.

Tolerances: ``_tol`` of ``tests/test_kernels.py`` (float32 2e-5, bf16
2e-2, as atol = rtol) — the same limits the JAX kernel is held to.
"""

import inspect
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import (attention_reference as j_attn_ref,
                                           flash_attention as j_flash)
from repro.kernels.flash_decode import decode_reference as j_decode_ref
from repro.kernels.flash_decode import flash_decode as j_flash_decode
from repro.kernels.flash_decode import paged_decode_reference as j_paged_ref
from repro.kernels.flash_decode import paged_mla_decode_reference as j_mla_ref
from repro.kernels.multi_lora import multi_lora as j_multi_lora
from repro.kernels.multi_lora import multi_lora_reference as j_lora_ref
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (attention_reference,
                                                 flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_attention.ops import flash_geometry
from repro_torch.kernels.multi_lora.ops import (LORA_SMEM_TWO_CTAS,
                                                lora_geometry)
from repro_torch.kernels.flash_decode import (decode_reference,
                                              flash_decode,
                                              flash_decode_plain,
                                              gather_kv,
                                              paged_decode_reference,
                                              paged_flash_decode,
                                              paged_flash_decode_mla,
                                              paged_flash_decode_mla_plain,
                                              paged_flash_decode_plain,
                                              paged_flash_verify,
                                              paged_flash_verify_mla,
                                              paged_flash_verify_mla_plain,
                                              paged_flash_verify_plain,
                                              paged_mla_decode_reference,
                                              paged_mla_verify_reference,
                                              paged_verify_reference)
from repro_torch.kernels.flash_decode.ops import (PAGED_MAX_CLUSTER,
                                                  SMEM_LIMIT, _check,
                                                  paged_geometry,
                                                  verify_chunks)
from repro_torch.kernels.multi_lora import (multi_lora, multi_lora_plain,
                                            multi_lora_reference)
from test_kernels import DECODE_CASES, FLASH_CASES, LORA_CASES, _tol


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


def _tdtype(jd):
    return torch.bfloat16 if jd == jnp.bfloat16 else torch.float32


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[f"fa{i}" for i in range(len(FLASH_CASES))])
def test_flash_attention_plain_vs_jax(case):
    """Plain version vs the Pallas kernel (interpret mode) and the oracle;
    the port's own oracle vs the JAX oracle."""
    B, Sq, Skv, Hq, Hkv, hd, causal, window, lens, jd, bq, bk = case
    r = np.random.default_rng(Sq + Skv + Hq)
    q, k, v = (r.standard_normal(s) for s in
               ((B, Sq, Hq, hd), (B, Skv, Hkv, hd), (B, Skv, Hkv, hd)))
    td = _tdtype(jd)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    out = flash_attention_plain(_t(q, td), _t(k, td), _t(v, td), tl,
                                causal=causal, sliding_window=window)
    jq, jk, jv = _j(q, jd), _j(k, jd), _j(v, jd)
    kern = j_flash(jq, jk, jv, jl, causal=causal, sliding_window=window,
                   block_q=bq, block_k=bk, interpret=True)
    ref = j_attn_ref(jq, jk, jv, causal=causal, sliding_window=window,
                     kv_len=jl)
    tol = _tol(jd)
    for other in (kern, ref):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(other, np.float32),
                                   atol=tol, rtol=tol)
    mine = attention_reference(_t(q, td), _t(k, td), _t(v, td), causal=causal,
                               sliding_window=window, kv_len=tl)
    np.testing.assert_allclose(mine.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol, rtol=tol)


def _rand_case(rnd, *, B, nb, max_blocks, blk):
    """Random block table with shared and trash blocks + ragged kv_len
    (``test_disagg._rand_case``'s recipe), always with a kv_len == 0 row."""
    tbl = np.zeros((B, max_blocks), np.int32)
    kv_len = np.zeros((B,), np.int32)
    shared = rnd.randrange(1, nb)
    for b in range(1, B):
        if rnd.random() < 0.25:
            continue                        # fully-masked lane: all trash
        live = rnd.randrange(1, max_blocks + 1)
        kv_len[b] = rnd.randrange((live - 1) * blk + 1, live * blk + 1)
        for i in range(live):
            tbl[b, i] = shared if rnd.random() < 0.3 \
                else rnd.randrange(1, nb)
    return tbl, kv_len


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", range(3))
def test_paged_decode_plain_vs_jax_oracle(dt, seed):
    """Random tables (shared + trash blocks, dead tails) vs the JAX gather
    oracle; kv_len == 0 rows must be exact zeros (the oracle's all-masked
    softmax degenerates to a mean, so those rows are checked apart)."""
    jd = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    td = _tdtype(jd)
    B, nb, max_blocks, blk, Hq, Hkv, hd = 6, 12, 4, 16, 6, 2, 64
    r = np.random.default_rng(seed)
    kp = r.standard_normal((nb, blk, Hkv, hd))
    vp = r.standard_normal((nb, blk, Hkv, hd))
    q = r.standard_normal((B, Hq, hd))
    tbl, kv_len = _rand_case(random.Random(seed), B=B, nb=nb,
                             max_blocks=max_blocks, blk=blk)
    out = paged_flash_decode_plain(_t(q, td), _t(kp, td), _t(vp, td),
                                   torch.from_numpy(tbl),
                                   torch.from_numpy(kv_len)).float().numpy()
    ref = np.asarray(j_paged_ref(_j(q, jd), _j(kp, jd), _j(vp, jd),
                                 jnp.asarray(tbl), jnp.asarray(kv_len)),
                     np.float32)
    live = kv_len > 0
    tol = _tol(jd)
    np.testing.assert_allclose(out[live], ref[live], atol=tol, rtol=tol)
    assert (out[~live] == 0.0).all()
    mine = paged_decode_reference(_t(q, td), _t(kp, td), _t(vp, td),
                                  torch.from_numpy(tbl),
                                  torch.from_numpy(kv_len)).float().numpy()
    np.testing.assert_allclose(mine, ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", range(3))
def test_paged_mla_decode_plain_vs_jax_oracle(dt, seed):
    """``test_disagg.py``'s MLA sweep shapes (B 4, nb 10, 4 blocks of 16,
    H 8, r 64, rh 32) over random tables vs the JAX gather oracle;
    kv_len == 0 rows are exact zeros."""
    jd = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    td = _tdtype(jd)
    B, nb, max_blocks, blk, H, r, rh = 4, 10, 4, 16, 8, 64, 32
    scale = 1.0 / np.sqrt(96.0)
    g = np.random.default_rng(100 + seed)
    ckv = g.standard_normal((nb, blk, r))
    kr = g.standard_normal((nb, blk, rh))
    ql = g.standard_normal((B, H, r))
    qr = g.standard_normal((B, H, rh))
    tbl, kv_len = _rand_case(random.Random(100 + seed), B=B, nb=nb,
                             max_blocks=max_blocks, blk=blk)
    targs = (_t(ql, td), _t(qr, td), _t(ckv, td), _t(kr, td),
             torch.from_numpy(tbl), torch.from_numpy(kv_len))
    out = paged_flash_decode_mla_plain(*targs, scale=scale).float().numpy()
    ref = np.asarray(j_mla_ref(_j(ql, jd), _j(qr, jd), _j(ckv, jd), _j(kr, jd),
                               jnp.asarray(tbl), jnp.asarray(kv_len),
                               scale=scale), np.float32)
    live = kv_len > 0
    tol = _tol(jd)
    np.testing.assert_allclose(out[live], ref[live], atol=tol, rtol=tol)
    assert (out[~live] == 0.0).all()
    mine = paged_mla_decode_reference(*targs, scale=scale).float().numpy()
    np.testing.assert_allclose(mine, ref, atol=tol, rtol=tol)


def test_gather_kv_layout():
    pool = torch.arange(5 * 4 * 2 * 3, dtype=torch.float32).reshape(5, 4, 2, 3)
    tbl = torch.tensor([[3, 0], [1, 4]], dtype=torch.int32)
    view = gather_kv(pool, tbl)
    assert view.shape == (2, 8, 2, 3)
    assert torch.equal(view[0, :4], pool[3]) and torch.equal(view[0, 4:],
                                                             pool[0])
    assert torch.equal(view[1, 4:], pool[4])


def test_wrappers_take_plain_version_on_cpu():
    """A CPU tensor runs the plain version (bitwise) and launches nothing;
    a tensor on another device raises instead of falling back."""
    r = np.random.default_rng(0)
    q = _t(r.standard_normal((1, 8, 4, 16)), torch.float32)
    k = _t(r.standard_normal((1, 8, 2, 16)), torch.float32)
    before = flash_attention.launches
    assert torch.equal(flash_attention(q, k, k, causal=True),
                       flash_attention_plain(q, k, k, causal=True))
    pool = _t(r.standard_normal((3, 4, 2, 16)), torch.float32)
    tbl = torch.tensor([[1, 2]], dtype=torch.int32)
    kl = torch.tensor([5], dtype=torch.int32)
    qd = q[:, 0]
    dbefore = paged_flash_decode.launches
    assert torch.equal(paged_flash_decode(qd, pool, pool, tbl, kl),
                       paged_flash_decode_plain(qd, pool, pool, tbl, kl))
    assert flash_attention.launches == before
    assert paged_flash_decode.launches == dbefore
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        paged_flash_decode(qd.to("meta"), pool, pool, tbl, kl)


def test_mla_wrapper_takes_plain_version_on_cpu():
    r = np.random.default_rng(1)
    ql = _t(r.standard_normal((2, 4, 16)), torch.float32)
    qr = _t(r.standard_normal((2, 4, 8)), torch.float32)
    ckv = _t(r.standard_normal((3, 4, 16)), torch.float32)
    kr = _t(r.standard_normal((3, 4, 8)), torch.float32)
    tbl = torch.tensor([[1, 2], [2, 0]], dtype=torch.int32)
    kl = torch.tensor([6, 0], dtype=torch.int32)
    before = paged_flash_decode_mla.launches
    out = paged_flash_decode_mla(ql, qr, ckv, kr, tbl, kl, scale=0.2)
    assert torch.equal(out, paged_flash_decode_mla_plain(ql, qr, ckv, kr, tbl,
                                                         kl, scale=0.2))
    assert bool((out[1] == 0).all())
    assert paged_flash_decode_mla.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        paged_flash_decode_mla(ql.to("meta"), qr, ckv, kr, tbl, kl, scale=0.2)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", range(2))
def test_paged_verify_plain_vs_jax_decode_oracle(dt, seed):
    """Verify = W decode steps: each position of the plain verify (random
    shared/trash tables, W = 4, every frontier >= 1) against the JAX gather
    oracle at that position's frontier ``kv_len - W + t + 1``; the port's
    verify oracle agrees too."""
    jd = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    td = _tdtype(jd)
    B, nb, max_blocks, blk, Hq, Hkv, hd, W = 6, 12, 4, 16, 6, 2, 64, 4
    r = np.random.default_rng(50 + seed)
    kp = r.standard_normal((nb, blk, Hkv, hd))
    vp = r.standard_normal((nb, blk, Hkv, hd))
    q = r.standard_normal((B, W, Hq, hd))
    tbl, kv_len = _rand_case(random.Random(50 + seed), B=B, nb=nb,
                             max_blocks=max_blocks, blk=blk)
    kv_len = np.maximum(kv_len, W).astype(np.int32)
    targs = (_t(kp, td), _t(vp, td), torch.from_numpy(tbl),
             torch.from_numpy(kv_len))
    out = paged_flash_verify_plain(_t(q, td), *targs).float().numpy()
    mine = paged_verify_reference(_t(q, td), *targs).float().numpy()
    tol = _tol(jd)
    for t in range(W):
        ref = np.asarray(j_paged_ref(_j(q[:, t], jd), _j(kp, jd), _j(vp, jd),
                                     jnp.asarray(tbl),
                                     jnp.asarray(kv_len - (W - 1 - t))),
                         np.float32)
        np.testing.assert_allclose(out[:, t], ref, atol=tol, rtol=tol)
        np.testing.assert_allclose(mine[:, t], ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_paged_mla_verify_plain_vs_jax_decode_oracle(dt):
    jd = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    td = _tdtype(jd)
    B, nb, max_blocks, blk, H, r, rh, W = 4, 10, 4, 16, 8, 64, 32, 3
    scale = 1.0 / np.sqrt(96.0)
    g = np.random.default_rng(150)
    ckv = g.standard_normal((nb, blk, r))
    kr = g.standard_normal((nb, blk, rh))
    ql = g.standard_normal((B, W, H, r))
    qr = g.standard_normal((B, W, H, rh))
    tbl, kv_len = _rand_case(random.Random(150), B=B, nb=nb,
                             max_blocks=max_blocks, blk=blk)
    kv_len = np.maximum(kv_len, W).astype(np.int32)
    targs = (_t(ckv, td), _t(kr, td), torch.from_numpy(tbl),
             torch.from_numpy(kv_len))
    out = paged_flash_verify_mla_plain(_t(ql, td), _t(qr, td), *targs,
                                       scale=scale).float().numpy()
    mine = paged_mla_verify_reference(_t(ql, td), _t(qr, td), *targs,
                                      scale=scale).float().numpy()
    tol = _tol(jd)
    for t in range(W):
        ref = np.asarray(j_mla_ref(_j(ql[:, t], jd), _j(qr[:, t], jd),
                                   _j(ckv, jd), _j(kr, jd), jnp.asarray(tbl),
                                   jnp.asarray(kv_len - (W - 1 - t)),
                                   scale=scale), np.float32)
        np.testing.assert_allclose(out[:, t], ref, atol=tol, rtol=tol)
        np.testing.assert_allclose(mine[:, t], ref, atol=tol, rtol=tol)


def test_verify_wrappers_take_plain_version_on_cpu():
    """The verify wrappers run their plain versions on CPU tensors
    (bitwise, no launch counted) and raise on any other device."""
    r = np.random.default_rng(2)
    q = _t(r.standard_normal((2, 3, 4, 16)), torch.float32)
    pool = _t(r.standard_normal((3, 4, 2, 16)), torch.float32)
    tbl = torch.tensor([[1, 2], [2, 0]], dtype=torch.int32)
    kl = torch.tensor([7, 3], dtype=torch.int32)
    before = paged_flash_verify.launches
    assert torch.equal(paged_flash_verify(q, pool, pool, tbl, kl),
                       paged_flash_verify_plain(q, pool, pool, tbl, kl))
    assert paged_flash_verify.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        paged_flash_verify(q.to("meta"), pool, pool, tbl, kl)
    ql = _t(r.standard_normal((2, 3, 4, 16)), torch.float32)
    qr = _t(r.standard_normal((2, 3, 4, 8)), torch.float32)
    ckv = _t(r.standard_normal((3, 4, 16)), torch.float32)
    kr = _t(r.standard_normal((3, 4, 8)), torch.float32)
    mbefore = paged_flash_verify_mla.launches
    assert torch.equal(
        paged_flash_verify_mla(ql, qr, ckv, kr, tbl, kl, scale=0.2),
        paged_flash_verify_mla_plain(ql, qr, ckv, kr, tbl, kl, scale=0.2))
    assert paged_flash_verify_mla.launches == mbefore
    with pytest.raises(ValueError, match="unsupported device"):
        paged_flash_verify_mla(ql.to("meta"), qr, ckv, kr, tbl, kl,
                               scale=0.2)


# (max_blocks, block_tokens, cluster C, span P): C = 1, C = 3, the fleet's
# 512-token table, the uneven 33 blocks (rank 7 owns nothing), max_seq 2048
GEOMETRY_CASES = [(1, 16, 1, 1), (3, 16, 3, 1), (8, 4, 8, 1), (32, 16, 8, 4),
                  (33, 16, 8, 5), (128, 16, 8, 16), (1000, 16, 8, 125)]


@pytest.mark.parametrize("max_blocks,blk,C,P", GEOMETRY_CASES)
def test_paged_geometry_spans(max_blocks, blk, C, P):
    """The cluster's spans cover [0, max_blocks) once, in rank order, with
    C <= 8; C and P come from the table width alone (the same for every
    number of query rows, head_dim and dtype)."""
    geo = paged_geometry(max_blocks, blk, 15, 64, 2)
    assert (geo.cluster, geo.span_blocks) == (C, P)
    assert C <= PAGED_MAX_CLUSTER
    spans = [range(min(c * P, max_blocks), min((c + 1) * P, max_blocks))
             for c in range(C)]
    assert [i for sp in spans for i in sp] == list(range(max_blocks))
    if max_blocks == 33:
        assert len(spans[7]) == 0
    params = inspect.signature(paged_geometry).parameters
    assert "W" not in params and "kv_len" not in params
    for rows, hd, esz in ((1, 20, 4), (3, 64, 2), (24, 128, 4), (256, 16, 4)):
        assert paged_geometry(max_blocks, blk, rows, hd, esz)[:2] == (C, P)


def _old_smem(W, G, hd, max_seq):
    """The shared memory of the single-block kernel this one replaced."""
    return W * G * (hd + max_seq) * 4


# (W, G, hd, dtype) of the card tests and chip_smoke.py
SMEM_CASES = [(W, G, hd, dt) for W, G, hd in
              ((1, 3, 64), (5, 3, 64), (3, 3, 20), (2, 4, 128), (1, 1, 64),
               (6, 3, 64), (8, 3, 20), (6, 3, 128), (1, 4, 128), (1, 1, 20))
              for dt in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("W,G,hd,dt", SMEM_CASES)
def test_paged_geometry_shared_memory(W, G, hd, dt):
    """Every table width the card tests and chip_smoke.py use fits in a
    block's shared memory; the longest max_seq taken (blocks of 16) is at
    least the replaced kernel's; a table beyond it raises the "shared
    memory" error."""
    esz = torch.tensor([], dtype=dt).element_size()
    for max_blocks in (1, 3, 8, 32, 33, 128):
        geo = paged_geometry(max_blocks, 16, W * G, hd, esz)
        assert geo.smem_bytes <= SMEM_LIMIT
    old = max(n for n in range(1, 4096)
              if _old_smem(W, G, hd, 16 * n) <= SMEM_LIMIT)
    assert all(paged_geometry(n, 16, W * G, hd, esz).smem_bytes <= SMEM_LIMIT
               for n in range(1, old + 1))
    new = old
    while paged_geometry(new + 1, 16, W * G, hd, esz).smem_bytes <= \
            SMEM_LIMIT:
        new += 1
    assert new >= old
    meta = dict(device="meta", dtype=dt)
    q = torch.empty((1, W, 3 * G, hd), **meta)
    pool = torch.empty((new + 2, 16, 3, hd), **meta)
    kl = torch.empty((1,), device="meta", dtype=torch.int32)
    ok = torch.empty((1, new), device="meta", dtype=torch.int32)
    assert _check("paged_flash_verify", q, pool, pool, ok, kl) == \
        paged_geometry(new, 16, W * G, hd, esz)
    too_long = torch.empty((1, new + 1), device="meta", dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        _check("paged_flash_verify", q, pool, pool, too_long, kl)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("W,chunks", [(12, [(0, 5), (5, 10), (10, 12)]),
                                      (7, [(0, 4), (4, 7)]),
                                      (5, [(0, 5)])])
def test_chunked_plain_verify_equals_one_verify(dt, W, chunks):
    """The identity the verify split rests on: a W-position verify equals
    its chunks [t0, t1), each a verify of t1 - t0 positions with
    ``kv_len - (W - t1)`` (every position keeps its frontier), dead
    positions (frontier <= 0) included."""
    rnd = random.Random(W)
    r = np.random.default_rng(W)
    nb, blk, max_blocks, Hkv, G, hd = 24, 4, 6, 2, 3, 16
    td = torch.float32 if dt == "float32" else torch.bfloat16
    tbl, kv_len = _rand_case(rnd, B=6, nb=nb, max_blocks=max_blocks, blk=blk)
    kv_len[:3] = [1, W - 2, W]              # dead positions, first frontier 1
    q = _t(r.standard_normal((6, W, Hkv * G, hd)), td)
    kp = _t(r.standard_normal((nb, blk, Hkv, hd)), td)
    vp = _t(r.standard_normal((nb, blk, Hkv, hd)), td)
    tb, kl = torch.from_numpy(tbl), torch.from_numpy(kv_len)
    whole = paged_flash_verify_plain(q, kp, vp, tb, kl)
    parts = torch.cat([paged_flash_verify_plain(
        q[:, t0:t1].contiguous(), kp, vp, tb, kl - (W - t1))
        for t0, t1 in chunks], dim=1)
    tol = 1e-6 if dt == "float32" else 8e-3
    torch.testing.assert_close(parts.float(), whole.float(), atol=tol,
                               rtol=tol)
    frontier = kl[:, None] - W + 1 + torch.arange(W)[None]
    assert bool((frontier <= 0).any())
    assert bool((parts[frontier <= 0] == 0).all())


# (W, G, hd, esz, max_blocks): the card test's formerly refused 192 rows,
# the fleet's verify (no split), wide tables at hd 64 and hd 20
CHUNK_CASES = [(12, 16, 128, 4, 1), (12, 16, 128, 2, 8), (5, 3, 64, 2, 32),
               (64, 4, 64, 4, 128), (40, 8, 20, 2, 64), (9, 16, 128, 4, 300)]


@pytest.mark.parametrize("W,G,hd,esz,max_blocks", CHUNK_CASES)
def test_verify_chunks_take_the_widest_launch_that_fits(W, G, hd, esz,
                                                        max_blocks):
    """The chunks cover [0, W) in order; each fits one launch; all but the
    last are the widest that fits (one more position would not); one chunk
    when the whole verify fits."""
    chunks = verify_chunks(W, G, max_blocks, 16, hd, esz)
    assert chunks[0][0] == 0 and chunks[-1][1] == W
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    per = chunks[0][1]
    assert all(t1 - t0 == per for t0, t1 in chunks[:-1])
    assert 0 < chunks[-1][1] - chunks[-1][0] <= per

    def fits(n):
        return paged_geometry(max_blocks, 16, n * G, hd,
                              esz).smem_bytes <= SMEM_LIMIT
    assert fits(per)
    assert per == W or not fits(per + 1)
    assert (len(chunks) == 1) == fits(W)


def test_verify_chunks_refuse_only_what_decode_refuses():
    """The split raises the "shared memory" error exactly when one
    position's G rows do not fit: the decode launch on the same table is
    refused too; one block fewer and both run."""
    G, hd, blk = 4, 16, 4
    esz = 4
    n = 1
    while paged_geometry(n + 1, blk, G, hd, esz).smem_bytes <= SMEM_LIMIT:
        n += 1
    assert verify_chunks(64, G, n, blk, hd, esz)[0][1] >= 1
    with pytest.raises(ValueError, match="shared memory"):
        verify_chunks(64, G, n + 1, blk, hd, esz)
    meta = dict(device="meta", dtype=torch.float32)
    q = torch.empty((1, 1, 2 * G, hd), **meta)
    pool = torch.empty((4, blk, 2, hd), **meta)
    kl = torch.empty((1,), device="meta", dtype=torch.int32)
    _check("paged_flash_decode", q, pool, pool,
           torch.empty((1, n), device="meta", dtype=torch.int32), kl)
    with pytest.raises(ValueError, match="shared memory"):
        _check("paged_flash_decode", q, pool, pool,
               torch.empty((1, n + 1), device="meta", dtype=torch.int32), kl)


@pytest.mark.parametrize("hd", [20, 32, 64, 128])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_geometry_shared_memory(hd, dt):
    """Kernel 1's dynamic shared memory fits a block at every head_dim the
    card tests use: the bf16 body's Q tile and K/V ring of 128-key stages
    (head_dim padded to 32, 64 or 128, rows 16 bytes wider; 5 stages up to
    64, 3 at 128); the float32 body's is 0 (its tiles are static)."""
    esz = torch.tensor([], dtype=dt).element_size()
    geo = flash_geometry(hd, esz)
    assert geo.head_pad >= hd and geo.head_pad % 16 == 0
    assert geo.smem_bytes <= SMEM_LIMIT
    if dt == torch.bfloat16:
        assert geo.head_pad == {20: 32, 32: 32, 64: 64, 128: 128}[hd]
        assert geo.stages == (5 if hd <= 64 else 3)
        assert geo.smem_bytes == \
            (64 + 2 * geo.stages * 128) * (geo.head_pad + 8) * 2
    else:
        assert geo.stages == 0 and geo.smem_bytes == 0


def test_build_is_lazy_and_keyed_by_source(monkeypatch, tmp_path):
    """Importing the kernel modules builds nothing; the library name
    carries the source hash; a missing nvcc is a clear error."""
    assert not _build._libs
    assert _build._lib_path("paged_decode") == _build._lib_path("paged_decode")
    assert _build._lib_path("paged_decode") != \
        _build._lib_path("flash_attention")
    assert len({_build._lib_path(n) for n in _build.SOURCES}) == \
        len(_build.SOURCES) == 4
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


# ---------------------------------------------------------------------------
# contiguous-cache decode (the flash-attention kernel with Sq = 1)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=[f"fd{i}" for i in range(len(DECODE_CASES))])
def test_flash_decode_plain_vs_jax(case):
    """The plain version vs the JAX ``flash_decode`` (the Pallas kernel in
    interpret mode) and its oracle; the port's oracle vs the JAX one."""
    B, Skv, Hq, Hkv, hd, jd = case
    r = np.random.default_rng(Skv + Hq)
    q = r.standard_normal((B, Hq, hd))
    k = r.standard_normal((B, Skv, Hkv, hd))
    v = r.standard_normal((B, Skv, Hkv, hd))
    kl = r.integers(1, Skv + 1, size=(B,)).astype(np.int32)
    td = _tdtype(jd)
    tl = torch.from_numpy(kl)
    out = flash_decode_plain(_t(q, td), _t(k, td), _t(v, td), tl)
    assert torch.equal(out, flash_decode(_t(q, td), _t(k, td), _t(v, td), tl))
    jargs = (_j(q, jd), _j(k, jd), _j(v, jd), jnp.asarray(kl))
    tol = _tol(jd)
    for other in (j_flash_decode(*jargs, interpret=True),
                  j_decode_ref(*jargs)):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(other, np.float32),
                                   atol=tol, rtol=tol)
    mine = decode_reference(_t(q, td), _t(k, td), _t(v, td), tl)
    np.testing.assert_allclose(mine.float().numpy(),
                               np.asarray(j_decode_ref(*jargs), np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# multi-adapter LoRA (kernel 6)
# ---------------------------------------------------------------------------

def _lora_inputs(seed, N, din, dout, T, r):
    g = np.random.default_rng(seed)
    return (g.standard_normal((N, din)), g.standard_normal((T, din, r)) * 0.05,
            g.standard_normal((T, r, dout)) * 0.05)


def _hold_lora(x, a, b, ids, jd, *, scale=1.0, tol=None):
    """The plain version and the port's oracle against the JAX kernel
    (interpret mode) and its oracle on the same inputs."""
    td = _tdtype(jd)
    tx, ta, tb = _t(x, td), _t(a, td), _t(b, td)
    tids = torch.from_numpy(np.asarray(ids, np.int32))
    out = multi_lora_plain(tx, ta, tb, tids, scale=scale)
    mine = multi_lora_reference(tx, ta, tb, tids, scale=scale)
    assert out.dtype == td and out.shape == (x.shape[0], b.shape[2])
    jx, ja, jb = _j(x, jd), _j(a, jd), _j(b, jd)
    jids = jnp.asarray(np.asarray(ids, np.int32))
    kern = j_multi_lora(jx, ja, jb, jids, scale=scale, interpret=True)
    tol = _tol(jd) if tol is None else tol
    for got in (out, mine):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(kern, np.float32),
                                   atol=tol, rtol=2e-2)
    return out, kern


@pytest.mark.parametrize("case", LORA_CASES,
                         ids=[f"ml{i}" for i in range(len(LORA_CASES))])
def test_multi_lora_plain_vs_jax(case):
    """``test_kernels.py``'s cases (ragged N = 130, T up to 10, r up to 64,
    bf16) at scale 2.0, within ``_tol`` (atol) and rtol 2e-2, as the JAX
    kernel is held to its oracle; the JAX oracle agrees too."""
    N, din, dout, T, r, jd = case
    x, a, b = _lora_inputs(N + din + T, N, din, dout, T, r)
    ids = np.random.default_rng(N).integers(0, T, size=(N,))
    out, _ = _hold_lora(x, a, b, ids, jd, scale=2.0)
    ref = j_lora_ref(_j(x, jd), _j(a, jd), _j(b, jd),
                     jnp.asarray(ids, jnp.int32), scale=2.0)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=_tol(jd), rtol=2e-2)


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_multi_lora_plain_random_task_permutations(seed):
    """Block-sorted and shuffled task layouts with one task absent
    (``test_kernels.py``'s permutation recipe) at float32, within 2e-5;
    permuting rows and their tasks together permutes the output rows."""
    N, din, dout, T, r = 96, 128, 64, 5, 8
    x, a, b = _lora_inputs(seed, N, din, dout, T, r)
    base = np.arange(N) % (T - 1)                       # task T-1 absent
    perm = np.random.RandomState(seed).permutation(N)
    for ids in (base, base[perm]):
        _hold_lora(x, a, b, ids, jnp.float32, tol=2e-5)
    tx, ta, tb = (_t(v, torch.float32) for v in (x, a, b))
    out = multi_lora_plain(tx, ta, tb, torch.from_numpy(base))
    out_p = multi_lora_plain(tx[perm], ta, tb, torch.from_numpy(base[perm]))
    torch.testing.assert_close(out_p, out[perm], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("block_n", [64, 128])
def test_multi_lora_plain_vs_jax_runs_across_tile_edges(block_n):
    """Sorted task runs of 1, 63, 65, 127, 129 and 257 rows (across the
    64- and 128-row tile edges of the JAX kernel's ``block_n`` and of
    ``csrc/multi_lora.cu``'s 128-row tiles) at float32, scale 2: the plain
    version against the JAX kernel (interpret mode) with that block and
    against the JAX oracle, within 1e-4 (TF32 off; summation order only)."""
    runs = (1, 63, 65, 127, 129, 257)
    T, din, dout, r = 4, 64, 48, 8
    ids = np.concatenate([np.full(n, k % T) for k, n in enumerate(runs)])
    N = ids.size
    x, a, b = _lora_inputs(N, N, din, dout, T, r)
    out = multi_lora_plain(*(_t(v, torch.float32) for v in (x, a, b)),
                           torch.from_numpy(ids.astype(np.int32)), scale=2.0)
    jargs = (*(_j(v, jnp.float32) for v in (x, a, b)),
             jnp.asarray(ids, jnp.int32))
    for ref in (j_multi_lora(*jargs, scale=2.0, block_n=block_n,
                             interpret=True),
                j_lora_ref(*jargs, scale=2.0)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("r", [1, 16, 32, 64])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_lora_geometry_shared_memory(r, dt):
    """Kernel 6's dynamic shared memory at every rank class: within a
    block's 232 448 B and within the two-CTAs-per-SM budget, a ring of 2
    to 4 stages, each the larger of a shrink job (128 bytes of each of 128
    x rows padded by 16 bytes, plus as many rows of A) and an expand job
    (rank_pad rows of 64 columns of B padded by 16 bytes), plus the 8 warps'
    16 x 72 staging tiles; the most stages that fit."""
    esz = torch.tensor([], dtype=dt).element_size()
    geo = lora_geometry(r, esz)
    assert geo.rank_pad == {1: 8, 16: 16, 32: 32, 64: 64}[r]
    assert 2 <= geo.stages <= 4
    assert geo.smem_bytes <= LORA_SMEM_TWO_CTAS <= SMEM_LIMIT
    kc = 128 // esz
    a_stride = geo.rank_pad + (0 if geo.rank_pad % 16 == 8 else 8)
    stage = max((128 * (kc + 16 // esz) + kc * a_stride) * esz,
                geo.rank_pad * (64 + 16 // esz) * esz)
    stage = -(-stage // 128) * 128
    staging = 8 * 16 * 72 * esz
    assert geo.smem_bytes == geo.stages * stage + staging
    assert geo.stages == 4 or \
        (geo.stages + 1) * stage + staging > LORA_SMEM_TWO_CTAS
    # the encoder path's geometry (float32, r = 32): 3 stages, 107 520 B
    if dt == torch.float32 and r == 32:
        assert (geo.stages, geo.smem_bytes) == (3, 107_520)


def test_multi_lora_fused_base_vs_jax():
    """``x @ w + delta`` through the public wrappers, within 1e-4 as the
    JAX test holds its own."""
    x, a, b = _lora_inputs(7, 32, 64, 64, 2, 8)
    w = np.random.default_rng(8).standard_normal((64, 64)) * 0.1
    ids = np.random.default_rng(9).integers(0, 2, size=(32,))
    out = multi_lora(*(_t(v, torch.float32) for v in (x, a, b)),
                     torch.from_numpy(ids.astype(np.int32)),
                     w=_t(w, torch.float32))
    ref = j_multi_lora(*(_j(v, jnp.float32) for v in (x, a, b)),
                       jnp.asarray(ids, jnp.int32), w=_j(w, jnp.float32),
                       interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("jd", [jnp.float32, jnp.bfloat16],
                         ids=["float32", "bfloat16"])
def test_multi_lora_out_of_range_ids_give_zeros(jd):
    """Ids outside [0, T) (negative, T, far beyond) give exact zero rows,
    as the JAX wrapper's all-zero one-hot row does; the other rows still
    match."""
    N, din, dout, T, r = 40, 32, 48, 3, 4
    x, a, b = _lora_inputs(11, N, din, dout, T, r)
    ids = np.random.default_rng(12).integers(0, T, size=(N,))
    dead = np.array([0, 5, 17, 39])
    ids[dead] = [-1, T, 1000, -7]
    out, kern = _hold_lora(x, a, b, ids, jd, scale=2.0)
    assert (out[torch.from_numpy(dead)] == 0).all()
    assert (np.asarray(kern, np.float32)[dead] == 0).all()


def test_multi_lora_wrapper_takes_plain_version_on_cpu():
    """A CPU tensor runs the plain version (bitwise) and launches nothing;
    another device raises instead of falling back."""
    x, a, b = (_t(v, torch.float32) for v in _lora_inputs(3, 10, 16, 8, 2, 4))
    ids = torch.tensor([0, 1] * 5, dtype=torch.int32)
    before = multi_lora.launches
    assert torch.equal(multi_lora(x, a, b, ids, scale=0.5),
                       multi_lora_plain(x, a, b, ids, scale=0.5))
    assert multi_lora.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        multi_lora(x.to("meta"), a, b, ids)
