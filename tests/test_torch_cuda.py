"""The port's CUDA kernels on the card (marker ``cuda``; skipped without
one — a CUDA kernel has no CPU mode).  Run on a machine with an NVIDIA
card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held to its plain PyTorch version on the same inputs:
float32 within 1e-4 (TF32 off; summation order only), bfloat16 within
2e-2 as atol = rtol (``tests/test_kernels.py:_tol``).  The verify kernels
are also held to the decode kernels bitwise: position t of a W-wide verify
equals a decode launch at ``kv_len - W + t + 1``.  No JAX here: the
machine with the card need not have it.
"""

import random

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_plain)
from repro_torch.kernels.flash_decode.ops import (
    flash_decode, flash_decode_plain, paged_flash_decode,
    paged_flash_decode_mla, paged_flash_decode_mla_plain,
    paged_flash_decode_plain, paged_geometry, paged_flash_verify, paged_flash_verify_mla,
    paged_flash_verify_mla_plain, paged_flash_verify_plain)
from repro_torch.kernels.flash_decode.ops import (_MLA_ARGTYPES, _check,
                                                  mla_geometry, verify_chunks)
from repro_torch.kernels.multi_lora.ops import multi_lora, multi_lora_plain

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(a, b, dtype):
    tol = TOL[dtype]
    torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


FLASH = [
    # B, Sq, Skv, Hq, Hkv, hd, causal, window, lens, q_offset
    (1, 479, 479, 15, 5, 64, True, 0, None, 0),
    (2, 100, 100, 3, 1, 20, True, 0, None, 0),
    (2, 128, 384, 6, 3, 32, False, 0, (300, 128), 0),
    (1, 64, 200, 4, 2, 128, True, 0, None, 136),
    (2, 256, 256, 8, 2, 64, True, 64, (256, 200), 0),
    # query tiles of 64 rows and key tiles of 64 keys: edges crossed
    (2, 1, 300, 8, 2, 64, False, 0, (300, 77), 0),    # Sq 1, G 4
    (1, 63, 63, 4, 4, 32, True, 0, None, 0),          # G 1, hd 32
    (1, 64, 64, 8, 2, 128, True, 0, None, 0),         # G 4, hd 128
    (2, 65, 65, 6, 2, 20, True, 0, None, 0),          # hd 20: scalar loads
    (1, 129, 129, 4, 1, 64, True, 24, None, 0),       # window < a key tile
    (1, 129, 300, 3, 3, 128, True, 0, None, 171),     # q_offset 171
    # row 1 sees keys < 40 through a window of 16: its query rows >= 55
    # see nothing, the q tiles from row 64 on not one key
    (2, 129, 129, 4, 2, 32, True, 16, (129, 40), 0),
    # the router fleet's prefill shapes at the longest prefill: qwen3-1.7b
    # (16/8 heads, hd 128) and glm4-9b (32/2, G 16, hd 128)
    (1, 479, 479, 16, 8, 128, True, 0, None, 0),
    (2, 479, 479, 16, 8, 128, True, 0, (479, 37), 0),
    (1, 479, 479, 32, 2, 128, True, 0, None, 0),
    (2, 479, 479, 32, 2, 128, True, 256, (479, 300), 0),
    # the whisper encoder's bidirectional self-attention over its 1500
    # stub frames (6/6 heads of 64) and jamba's attention layer (32/8 heads
    # of 128, causal) at the longest prefill
    (1, 1500, 1500, 6, 6, 64, False, 0, None, 0),
    (1, 479, 479, 32, 8, 128, True, 0, None, 0),
]


def _seen_rows(B, Sq, Skv, causal, window, lens, off, device):
    """(B, Sq) bool: the query rows that see at least one key."""
    qpos = torch.arange(Sq, device=device)[:, None] + off
    key = torch.arange(Skv, device=device)[None]
    vis = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        vis &= key <= qpos
    if window > 0:
        vis &= key > qpos - window
    n = torch.tensor([Skv] * B if lens is None else lens, device=device)
    return (vis[None] & (key[None] < n[:, None, None])).any(-1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH, ids=[f"fa{i}" for i in range(len(FLASH))])
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):
    """Rows that see a key agree with the plain version; rows that see
    none are exact zeros (the plain version gives the mean of V there)."""
    B, Sq, Skv, Hq, Hkv, hd, causal, window, lens, off = case
    g = torch.Generator(device=cuda).manual_seed(Sq + hd)
    q = torch.randn((B, Sq, Hq, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, Skv, Hkv, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, Skv, Hkv, hd), generator=g, device=cuda).to(dtype)
    ln = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, ln, causal=causal, sliding_window=window,
                          q_offset=off)
    ref = flash_attention_plain(q, k, v, ln, causal=causal,
                                sliding_window=window, q_offset=off)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    seen = _seen_rows(B, Sq, Skv, causal, window, lens, off, cuda)
    _close(out[seen], ref[seen], dtype)
    assert bool((out[~seen] == 0).all())


def _edge_lens(max_blocks, blk, low):
    """kv_len at the cluster's span edges (P * blk - 1, P * blk, P * blk + 1
    with P the span of ``paged_geometry``) and the full table, each at
    least ``low``."""
    span = paged_geometry(max_blocks, blk, 1, 64, 2).span_blocks * blk
    S = max_blocks * blk
    return [min(max(n, low), S) for n in (span - 1, span, span + 1, S)]


# table widths: cluster C = 1, C = 3, C = 8 (P = 1), the uneven 33 blocks
# (C = 8, P = 5, rank 7 empty), and max_seq 2048 (C = 8, P = 16)
MAX_BLOCKS = [1, 3, 8, 33, 128]


@pytest.mark.parametrize("max_blocks", MAX_BLOCKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,hd", [(15, 5, 64), (3, 1, 20), (8, 2, 128),
                                       (4, 4, 64), (16, 8, 128),
                                       (32, 2, 128)])
def test_paged_decode_kernel_matches_plain(cuda, dtype, Hq, Hkv, hd,
                                           max_blocks):
    blk = 16
    nb = max(40, max_blocks + 1)
    rnd = random.Random(hd + Hq + max_blocks)
    lens = [0] + _edge_lens(max_blocks, blk, 1) + [
        rnd.randrange(1, max_blocks * blk + 1) for _ in range(3)]
    B = len(lens)                               # row 0: kv_len == 0
    tbl = np.zeros((B, max_blocks), np.int32)
    shared = rnd.randrange(1, nb)
    for b in range(1, B):
        for i in range(max_blocks):
            tbl[b, i] = shared if rnd.random() < 0.3 else rnd.randrange(1, nb)
    g = torch.Generator(device=cuda).manual_seed(hd)
    q = torch.randn((B, Hq, hd), generator=g, device=cuda).to(dtype)
    kp = torch.randn((nb, blk, Hkv, hd), generator=g, device=cuda).to(dtype)
    vp = torch.randn((nb, blk, Hkv, hd), generator=g, device=cuda).to(dtype)
    t = torch.from_numpy(tbl).to(cuda)
    kl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = paged_flash_decode.launches
    out = paged_flash_decode(q, kp, vp, t, kl)
    ref = paged_flash_decode_plain(q, kp, vp, t, kl)
    torch.cuda.synchronize()
    assert paged_flash_decode.launches == before + 1
    assert bool((out[0] == 0).all())
    _close(out, ref, dtype)


def _mla_case(cuda, dtype, *, B, H, r, rh, nb, max_blocks, seed):
    """Random permutation of physical blocks per row; kv_len covers 0, 1,
    a partial block and the full table."""
    blk = 16
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(seed))
    tbl = (perm[:B * max_blocks] + 1).reshape(B, max_blocks).to(torch.int32)
    S = max_blocks * blk
    lens = [0, 1, 7, S] + [random.Random(seed + b).randrange(1, S + 1)
                           for b in range(B - 4)]
    g = torch.Generator(device=cuda).manual_seed(seed)
    return (torch.randn((B, H, r), generator=g, device=cuda).to(dtype),
            torch.randn((B, H, rh), generator=g, device=cuda).to(dtype),
            torch.randn((nb, blk, r), generator=g, device=cuda).to(dtype),
            torch.randn((nb, blk, rh), generator=g, device=cuda).to(dtype),
            tbl.to(cuda), torch.tensor(lens, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,r,rh,nb,max_blocks", [
    (8, 128, 512, 64, 385, 32),      # deepseek-v2 at full width, max_seq 512
    (5, 4, 16, 8, 40, 4),            # reduced: one masked head tile
    (6, 20, 64, 32, 60, 8),          # a full tile plus a remainder tile
    # the cluster split: C = 1, C = 3, the uneven 9 blocks (C = 8, P = 2,
    # ranks 5-7 own nothing), and a 2048-key table at full width
    (5, 4, 16, 8, 40, 1), (6, 20, 64, 32, 60, 3), (6, 20, 64, 32, 60, 9),
    (8, 128, 512, 64, 1025, 128)])
def test_paged_mla_decode_kernel_matches_plain(cuda, dtype, B, H, r, rh, nb,
                                               max_blocks):
    args = _mla_case(cuda, dtype, B=B, H=H, r=r, rh=rh, nb=nb,
                     max_blocks=max_blocks, seed=H + r)
    scale = 1.0 / (2.0 * rh) ** 0.5
    before = paged_flash_decode_mla.launches
    out = paged_flash_decode_mla(*args, scale=scale)
    ref = paged_flash_decode_mla_plain(*args, scale=scale)
    torch.cuda.synchronize()
    assert paged_flash_decode_mla.launches == before + 1
    assert out.dtype == dtype and out.shape == args[0].shape
    assert bool((out[0] == 0).all())                     # kv_len == 0
    _close(out, ref, dtype)


def _verify_lens(B, S, W, seed):
    """kv_len per row: W (first frontier 1), a dead row (kv_len 1: the
    first W-1 positions see nothing), the full table, and random."""
    return [W, 1, S] + [random.Random(seed + b).randrange(W, S + 1)
                        for b in range(B - 3)]


@pytest.mark.parametrize("max_blocks", MAX_BLOCKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,hd,W", [(15, 5, 64, 5), (3, 1, 20, 3),
                                         (8, 2, 128, 2), (4, 4, 64, 1),
                                         (15, 5, 64, 6), (9, 3, 20, 8),
                                         (6, 2, 128, 6)])
def test_paged_verify_kernel_matches_plain_and_decode(cuda, dtype, Hq, Hkv,
                                                      hd, W, max_blocks):
    """W up to 8 (W x G = 18 and 24 query rows: two row tiles of 16);
    kv_len at the span edges, the full table, W (first frontier 1) and 1
    (dead positions)."""
    blk = 16
    nb = max(60, max_blocks + 1)
    S = max_blocks * blk
    lens = [min(W, S), 1] + _edge_lens(max_blocks, blk, W) + [
        random.Random(hd + b).randrange(min(W, S), S + 1) for b in range(2)]
    B = len(lens)
    rnd = random.Random(hd + W + max_blocks)
    tbl = torch.tensor([[rnd.randrange(1, nb) for _ in range(max_blocks)]
                        for _ in range(B)], dtype=torch.int32)
    t = tbl.to(cuda)
    kl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(hd + W)
    q = torch.randn((B, W, Hq, hd), generator=g, device=cuda).to(dtype)
    kp = torch.randn((nb, blk, Hkv, hd), generator=g, device=cuda).to(dtype)
    vp = torch.randn((nb, blk, Hkv, hd), generator=g, device=cuda).to(dtype)
    before = paged_flash_verify.launches
    out = paged_flash_verify(q, kp, vp, t, kl)
    ref = paged_flash_verify_plain(q, kp, vp, t, kl)
    torch.cuda.synchronize()
    assert paged_flash_verify.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    _close(out, ref, dtype)
    frontier = kl[:, None] - W + 1 + torch.arange(W, device=cuda)[None]
    assert bool((out[frontier <= 0] == 0).all())        # dead positions
    for pos in range(W):
        step = paged_flash_decode(q[:, pos].contiguous(), kp, vp, t,
                                  kl - (W - 1 - pos))
        assert torch.equal(out[:, pos], step), f"position {pos}"


@pytest.mark.parametrize("max_blocks", [1, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_verify_splits_what_one_launch_cannot_hold(cuda, dtype,
                                                         max_blocks):
    """W = 12 positions x G = 16 query heads of hd 128 (192 query rows):
    one launch does not fit in shared memory (refused before the split),
    so the verify runs the chunks of ``verify_chunks``; plain within
    tolerance, dead positions zeros, each position == decode bitwise."""
    W, Hq, Hkv, hd, blk = 12, 32, 2, 128, 16
    nb = 40
    S = max_blocks * blk
    lens = [W, 1, S] + [random.Random(b).randrange(W, S + 1)
                        for b in range(2)]
    B = len(lens)
    rnd = random.Random(max_blocks)
    t = torch.tensor([[rnd.randrange(1, nb) for _ in range(max_blocks)]
                      for _ in range(B)], dtype=torch.int32, device=cuda)
    kl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(W + max_blocks)
    q = torch.randn((B, W, Hq, hd), generator=g, device=cuda).to(dtype)
    kp = torch.randn((nb, blk, Hkv, hd), generator=g, device=cuda).to(dtype)
    vp = torch.randn((nb, blk, Hkv, hd), generator=g, device=cuda).to(dtype)
    with pytest.raises(ValueError, match="shared memory"):
        _check("paged_flash_verify", q, kp, vp, t, kl)
    chunks = verify_chunks(W, Hq // Hkv, max_blocks, blk, hd,
                           q.element_size())
    assert len(chunks) == 2
    before = paged_flash_verify.launches
    out = paged_flash_verify(q, kp, vp, t, kl)
    ref = paged_flash_verify_plain(q, kp, vp, t, kl)
    torch.cuda.synchronize()
    assert paged_flash_verify.launches == before + len(chunks)
    assert out.dtype == dtype and out.shape == q.shape
    _close(out, ref, dtype)
    frontier = kl[:, None] - W + 1 + torch.arange(W, device=cuda)[None]
    assert bool((out[frontier <= 0] == 0).all())        # dead positions
    for pos in range(W):
        step = paged_flash_decode(q[:, pos].contiguous(), kp, vp, t,
                                  kl - (W - 1 - pos))
        assert torch.equal(out[:, pos], step), f"position {pos}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,W,H,r,rh,nb,max_blocks", [
    (8, 5, 128, 512, 64, 385, 32),   # deepseek-v2 at full width, max_seq 512
    (5, 3, 4, 16, 8, 40, 4),         # reduced: one masked head tile
    (4, 1, 20, 64, 32, 60, 8),       # W = 1: the decode kernel's launch
    (8, 5, 128, 512, 64, 1025, 128),  # full width, a 2048-key table
    (5, 8, 20, 64, 32, 60, 9)])      # row tiles that mix positions
def test_paged_mla_verify_kernel_matches_plain_and_decode(cuda, dtype, B, W,
                                                          H, r, rh, nb,
                                                          max_blocks):
    blk = 16
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(r))
    tbl = (perm[:B * max_blocks] + 1).reshape(B, max_blocks).to(torch.int32)
    kl = torch.tensor(_verify_lens(B, max_blocks * blk, W, r),
                      dtype=torch.int32, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(H + r)
    args = (torch.randn((B, W, H, r), generator=g, device=cuda).to(dtype),
            torch.randn((B, W, H, rh), generator=g, device=cuda).to(dtype),
            torch.randn((nb, blk, r), generator=g, device=cuda).to(dtype),
            torch.randn((nb, blk, rh), generator=g, device=cuda).to(dtype),
            tbl.to(cuda), kl)
    scale = 1.0 / (2.0 * rh) ** 0.5
    before = paged_flash_verify_mla.launches
    out = paged_flash_verify_mla(*args, scale=scale)
    ref = paged_flash_verify_mla_plain(*args, scale=scale)
    torch.cuda.synchronize()
    assert paged_flash_verify_mla.launches == before + 1
    assert out.dtype == dtype and out.shape == args[0].shape
    _close(out, ref, dtype)
    assert bool((out[1, :W - 1] == 0).all())            # frontier <= 0
    ql, qr = args[0], args[1]
    for pos in range(W):
        step = paged_flash_decode_mla(ql[:, pos].contiguous(),
                                      qr[:, pos].contiguous(), *args[2:5],
                                      kl - (W - 1 - pos), scale=scale)
        assert torch.equal(out[:, pos], step), f"position {pos}"


def _mla_edge_lens(max_blocks, blk, W):
    """kv_len at the cluster's span edges (P * blk - 1, P * blk, P * blk +
    1, 2 P * blk with P the span of ``mla_geometry``), at the pool-block
    edges, and the full table, each at least W."""
    span = mla_geometry(max_blocks, blk, 1, 64, 32, 2).span_blocks * blk
    S = max_blocks * blk
    return [min(max(n, W), S) for n in (span - 1, span, span + 1, 2 * span,
                                        blk - 1, blk, blk + 1, S - 1, S)]


# table widths of the cluster split: C = 1, C = 3, the uneven 9 blocks
# (C = 8, P = 2, ranks 5-7 empty), the fleet's 512 tokens, 2048 tokens
MLA_BLOCKS = [1, 3, 9, 32, 128]


@pytest.mark.parametrize("max_blocks", MLA_BLOCKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,r,rh,W", [
    (128, 512, 64, 1), (128, 512, 64, 5),   # full width: 2 / 10 row tiles
    (20, 64, 32, 1), (20, 64, 32, 2), (20, 64, 32, 5), (20, 64, 32, 8),
    (4, 16, 8, 1), (4, 16, 8, 2), (4, 16, 8, 5), (4, 16, 8, 8)])
def test_paged_mla_kernels_at_cluster_edges(cuda, dtype, H, r, rh, W,
                                             max_blocks):
    """Kernels 4 and 5 where the cluster split is delicate: frontiers at
    span and block edges, row tiles that mix positions (row = t * H + h),
    an all-trash table row (row 1) and dead positions (row 0, kv_len 0;
    row 2, kv_len 1).  Verify within tolerance of its plain version, dead
    positions exact zeros, each position == the decode kernel at its
    frontier bitwise; decode within tolerance of its plain version."""
    blk = 16
    nb = max(40, max_blocks + 1)
    S = max_blocks * blk
    lens = [0, min(W + 3, S), 1] + _mla_edge_lens(max_blocks, blk, W)
    B = len(lens)
    rnd = random.Random(H + W + max_blocks)
    tbl = [[rnd.randrange(1, nb) for _ in range(max_blocks)]
           for _ in range(B)]
    tbl[1] = [0] * max_blocks                   # freed slot: trash block 0
    t = torch.tensor(tbl, dtype=torch.int32, device=cuda)
    kl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(H + r + W)
    ql = torch.randn((B, W, H, r), generator=g, device=cuda).to(dtype)
    qr = torch.randn((B, W, H, rh), generator=g, device=cuda).to(dtype)
    ckv = torch.randn((nb, blk, r), generator=g, device=cuda).to(dtype)
    kr = torch.randn((nb, blk, rh), generator=g, device=cuda).to(dtype)
    scale = 1.0 / (2.0 * rh) ** 0.5
    before = paged_flash_verify_mla.launches
    out = paged_flash_verify_mla(ql, qr, ckv, kr, t, kl, scale=scale)
    ref = paged_flash_verify_mla_plain(ql, qr, ckv, kr, t, kl, scale=scale)
    torch.cuda.synchronize()
    assert paged_flash_verify_mla.launches == before + 1
    assert out.dtype == dtype and out.shape == ql.shape
    frontier = kl[:, None] - W + 1 + torch.arange(W, device=cuda)[None]
    assert bool((out[frontier <= 0] == 0).all())        # dead positions
    _close(out, ref, dtype)
    dbefore = paged_flash_decode_mla.launches
    for pos in range(W):
        args = (ql[:, pos].contiguous(), qr[:, pos].contiguous(), ckv, kr, t,
                kl - (W - 1 - pos))
        step = paged_flash_decode_mla(*args, scale=scale)
        assert torch.equal(out[:, pos], step), f"position {pos}"
        _close(step, paged_flash_decode_mla_plain(*args, scale=scale), dtype)
    assert paged_flash_decode_mla.launches == dbefore + W


def test_paged_mla_kernel_refuses_short_shared_memory(cuda):
    """The C entry refuses a launch given one byte less dynamic shared
    memory than ``mla_geometry``'s (the kernel's carve) at every row tile
    and in both dtypes, and takes exactly that much."""
    from repro_torch.kernels import _build
    fn = _build.c_function("paged_mla_decode", "paged_mla_fwd", _MLA_ARGTYPES)
    stream = torch.cuda.current_stream().cuda_stream
    blk, nb = 16, 40
    for dtype in (torch.float32, torch.bfloat16):
        for H, r, rh, W, max_blocks in ((128, 512, 64, 1, 32),
                                        (20, 64, 32, 1, 9),
                                        (4, 16, 8, 1, 1), (4, 16, 8, 5, 3)):
            B = 3
            g = torch.Generator(device=cuda).manual_seed(H + W)
            ql = torch.randn((B, W, H, r), generator=g, device=cuda).to(dtype)
            qr = torch.randn((B, W, H, rh), generator=g,
                             device=cuda).to(dtype)
            ckv = torch.randn((nb, blk, r), generator=g, device=cuda).to(dtype)
            kr = torch.randn((nb, blk, rh), generator=g, device=cuda).to(dtype)
            t = torch.randint(1, nb, (B, max_blocks), generator=g, device=cuda,
                              dtype=torch.int32)
            kl = torch.tensor([W, max_blocks * blk, 7], dtype=torch.int32,
                              device=cuda)
            out = torch.empty_like(ql)
            geo = mla_geometry(max_blocks, blk, W * H, r, rh,
                               ql.element_size())
            args = (ql.data_ptr(), qr.data_ptr(), ckv.data_ptr(),
                    kr.data_ptr(), t.data_ptr(), kl.data_ptr(),
                    out.data_ptr(), B, W, H, r, rh, nb, blk, max_blocks,
                    int(dtype == torch.bfloat16), 0.1, *geo[:-1])
            assert fn(*args, geo.smem_bytes - 1, stream) != 0
            assert fn(*args, geo.smem_bytes, stream) == 0
            torch.cuda.synchronize()
            _close(out, paged_flash_verify_mla_plain(ql, qr, ckv, kr, t, kl,
                                                     scale=0.1), dtype)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.randn((1, 8, 4, 16), device=cuda)
    k = torch.randn((1, 8, 2, 16), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, k)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), k.half())
    pool = torch.randn((3, 4, 2, 16), device=cuda)
    with pytest.raises(ValueError, match="int32"):
        paged_flash_decode(q[:, 0], pool, pool,
                           torch.zeros((1, 2), dtype=torch.int64, device=cuda),
                           torch.ones((1,), dtype=torch.int32, device=cuda))
    ql, qr = torch.randn((2, 4, 16), device=cuda), torch.randn((2, 4, 8),
                                                               device=cuda)
    ckv, kr = torch.randn((5, 16, 16), device=cuda), torch.randn((5, 16, 8),
                                                                 device=cuda)
    tbl = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
    kl = torch.ones((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        paged_flash_decode_mla(ql, qr, ckv, kr, tbl.long(), kl, scale=0.1)
    with pytest.raises(TypeError):
        paged_flash_decode_mla(ql.half(), qr.half(), ckv.half(), kr.half(),
                               tbl, kl, scale=0.1)
    with pytest.raises(ValueError, match="contiguous"):
        paged_flash_decode_mla(ql.transpose(0, 1).contiguous().transpose(0, 1),
                               qr, ckv, kr, tbl, kl, scale=0.1)
    with pytest.raises(ValueError, match="shared memory"):
        # 16 query rows x a 8192-token span of float32 scores per CTA
        paged_flash_decode_mla(ql, qr, ckv, kr,
                               torch.zeros((2, 4096), dtype=torch.int32,
                                           device=cuda), kl, scale=0.1)
    with pytest.raises(ValueError, match="disagree"):
        paged_flash_decode_mla(ql, qr, ckv[..., :8].contiguous(), kr, tbl, kl,
                               scale=0.1)
    with pytest.raises(ValueError, match="shared memory"):
        # one position's 4 query rows x a 16 384-token span of float32
        # scores per CTA: no chunk of positions fits
        paged_flash_verify(torch.randn((1, 64, 8, 16), device=cuda), pool,
                           pool, torch.zeros((1, 32768), dtype=torch.int32,
                                             device=cuda),
                           torch.ones((1,), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="disagree"):
        paged_flash_verify_mla(ql[:, None], qr[:, None].expand(2, 2, 4, 8)
                               .contiguous(), ckv, kr, tbl, kl, scale=0.1)


def test_reduced_fleet_on_card_equals_cpu(cuda):
    """Reduced float32 fleet with both kernels on the card vs the same
    fleet on the CPU (plain versions): identical tokens, and the kernels
    really ran."""
    from repro_torch.serving.fleet import LocalFleet
    arch = "smollm-360m"
    ov = {arch: {"dtype": "float32", "attn_impl": "pallas"}}
    prompts = ["a b c d e f g h i j k l m n o p q r s t", "short one",
               "a b c d e f g h i j k l m n o p different tail here"]
    outs = {}
    for dev in ("cuda", "cpu"):
        f = LocalFleet([arch], batch=2, gen_tokens=8, warmup=False,
                       decode_impl="flash_paged", arch_overrides=ov,
                       device=dev)
        fa, pd = flash_attention.launches, paged_flash_decode.launches
        outs[dev] = [o["tokens"] for o in f.generate(arch, prompts)]
        if dev == "cuda":
            assert flash_attention.launches > fa
            assert paged_flash_decode.launches > pd
        assert f.schedulers[arch].pool.live_refs() == 0
    assert outs["cuda"] == outs["cpu"]


def test_contiguous_equals_paged_xla_tokens_on_card(cuda):
    """``paged=False`` and ``paged=True`` (``decode_impl="xla"``) fleets of
    one seed on the card, bf16, prompts with no shared prefix: the paged
    decode attends over the gathered view, which has the contiguous row's
    layout, so the tokens are identical bit for bit."""
    from repro_torch.serving.fleet import LocalFleet
    arch = "smollm-360m"
    prompts = ["a b c d e f g h i j k l m n o p q r s t", "short one",
               "the third prompt shares nothing with the other two",
               " ".join(f"w{i}" for i in range(70))]
    outs = {}
    for paged in (False, True):
        f = LocalFleet([arch], batch=2, gen_tokens=8, warmup=False,
                       paged=paged, decode_impl="xla",
                       arch_overrides={arch: {"attn_impl": "pallas"}},
                       device=cuda)
        assert f.members[arch].paged == paged
        outs[paged] = [o["tokens"] for o in f.generate(arch, prompts)]
    assert outs[False] == outs[True]


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-350m",
                                  "whisper-tiny"])
def test_reduced_contiguous_fleet_on_card_equals_cpu(cuda, arch):
    """Reduced float32 SSM and audio members (the contiguous cache; kernel
    1 on jamba's attention and whisper's encoder and decoder prefill) on
    the card vs the CPU: identical tokens."""
    from repro_torch.serving.fleet import LocalFleet
    ov = {arch: {"dtype": "float32", "attn_impl": "pallas"}}
    prompts = ["a b c d e f g h i j k l m n o p q r s t", "short one",
               "the third prompt", "transcribe my voice memo"]
    outs = {}
    for dev in ("cuda", "cpu"):
        f = LocalFleet([arch], batch=2, gen_tokens=6, warmup=False,
                       arch_overrides=ov, device=dev)
        assert not f.members[arch].paged
        fa = flash_attention.launches
        outs[dev] = [o["tokens"] for o in f.generate(arch, prompts)]
        if dev == "cuda":
            assert (flash_attention.launches > fa) == (arch != "xlstm-350m")
    assert outs["cuda"] == outs["cpu"]


def test_reduced_router_on_card_equals_cpu(cuda):
    """``serve.build_router`` over the four reduced float32 members on the
    card vs on the CPU: the demo requests under the default and the cost
    and privacy tenants give equal decisions, models and contents, and
    kernels 1, 2 and 4 ran on the card."""
    from pathlib import Path

    from repro_torch.core.types import Message, Request
    from repro_torch.launch import serve
    root = Path(__file__).resolve().parents[1]
    outs = {}
    for dev in ("cuda", "cpu"):
        router, fleet = serve.build_router(gen_tokens=6, device=dev,
                                           dtype="float32", batch=4,
                                           warmup=False)
        # measured service times differ between devices: the latency
        # selector reads the profiles alone
        router.selection_ctx.observe_latency = lambda model, ms: None
        for pol in ("cost", "privacy"):
            router.add_policy(pol, (root / "examples" / "policies" /
                                    f"{pol}.vsr").read_text())
        reqs = []
        for i in range(12):
            r = Request(messages=[Message("user", serve.DEMO_REQUESTS[i % 8])],
                        user=f"user{i % 3}")
            r.metadata["policy"] = ("default", "cost", "privacy")[i % 3]
            reqs.append(r)
        before = [fn.launches for fn in (flash_attention, paged_flash_decode,
                                         paged_flash_decode_mla)]
        try:
            pairs = router.route_batch(reqs)
        finally:
            router.close()
        outs[dev] = [(o.decision, o.model, r.content) for r, o in pairs]
        if dev == "cuda":
            after = [fn.launches for fn in (flash_attention,
                                            paged_flash_decode,
                                            paged_flash_decode_mla)]
            assert all(a > b for a, b in zip(after, before))
        assert all(s.pool.live_refs() == 0 for s in fleet.schedulers.values())
    assert outs["cuda"] == outs["cpu"]


def test_reduced_mla_fleet_on_card_equals_cpu(cuda):
    """Reduced float32 deepseek-v2 fleet (MLA + MoE) with the MLA decode
    kernel on the card vs the same fleet on the CPU: identical tokens, and
    the kernel ran once per MLA layer and decode step."""
    from repro_torch.serving.fleet import LocalFleet
    arch = "deepseek-v2-236b"
    prompts = ["a b c d e f g h i j k l m n o p q r s t", "short one",
               "a b c d e f g h i j k l m n o p different tail here"]
    outs = {}
    for dev in ("cuda", "cpu"):
        f = LocalFleet([arch], batch=2, gen_tokens=8, warmup=False,
                       decode_impl="flash_paged",
                       arch_overrides={arch: {"dtype": "float32"}},
                       device=dev)
        before = paged_flash_decode_mla.launches
        outs[dev] = [o["tokens"] for o in f.generate(arch, prompts)]
        if dev == "cuda":
            steps = f.schedulers[arch].decode_steps
            assert paged_flash_decode_mla.launches - before == 3 * steps > 0
        assert f.schedulers[arch].pool.live_refs() == 0
    assert outs["cuda"] == outs["cpu"]


@pytest.mark.parametrize("arch,layers", [("smollm-360m", 2),
                                         ("deepseek-v2-236b", 3)])
def test_reduced_spec_fleet_on_card_equals_cpu(cuda, arch, layers):
    """Reduced float32 speculative fleet (aligned draft, k = 4) with the
    verify kernels on the card vs the plain fleet on the CPU: identical
    tokens, and the target's verify kernel ran once per layer and
    speculative round.  (The draft keeps the registry's bf16, so its
    proposals — and the spec counters — may differ between card and CPU;
    the tokens are the float32 target's.)"""
    from repro_torch.serving.fleet import LocalFleet
    from repro_torch.serving.scheduler import SpecConfig
    verify = paged_flash_verify_mla if arch == "deepseek-v2-236b" \
        else paged_flash_verify
    prompts = ["a b c d e f g h i j k l m n o p q r s t", "short one",
               "a b c d e f g h i j k l m n o p different tail here"]
    outs = {}
    for dev, spec in (("cuda", SpecConfig(arch, k=4)), ("cpu", None)):
        f = LocalFleet([arch], batch=2, gen_tokens=8, warmup=False,
                       decode_impl="flash_paged",
                       arch_overrides={arch: {"dtype": "float32"}},
                       speculative=spec, device=dev)
        s = f.schedulers[arch]
        before = verify.launches
        outs[dev] = [o["tokens"] for o in f.generate(arch, prompts)]
        if dev == "cuda":
            assert verify.launches - before == layers * s.spec_rounds > 0
        assert s.pool.live_refs() == 0
    assert outs["cuda"] == outs["cpu"]


def _preempt_roundtrip(fleet, arch):
    """``tests/test_qos.py``'s round trip: three low-priority rows fill the
    slots, a priority-100 arrival parks one; returns (uninterrupted
    tokens, resumed tokens, VIP tokens)."""
    lane, sched = fleet.lanes[arch], fleet.schedulers[arch]
    victims = [f"background analysis over corpus {i} with clauses {i}"
               for i in range(3)]
    ref = [o["tokens"] for o in fleet.generate(arch, victims, max_new=6)]
    pre0 = sched.preempted
    rids = [lane.submit(p, max_new=6, priority=0, slo="batch")
            for p in victims]
    lane.step()
    lane.step()
    hi = lane.submit("urgent vip request", max_new=2, priority=100,
                     slo="premium")
    done = {s.rid: list(s.out) for s in sched.drain()}
    assert sched.preempted == pre0 + 1
    assert sched.pool.live_refs() == 0
    return ref, [done[r] for r in rids], done[hi]


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-236b"])
def test_reduced_preemption_roundtrip_on_card_equals_cpu(cuda, arch):
    """Park/resume on a reduced float32 fleet with the decode kernel on
    the card (kernel 2 or 4): the parked victim resumes with its
    uninterrupted tokens, and every token equals the CPU fleet's."""
    from repro_torch.serving.fleet import LocalFleet
    kernel = paged_flash_decode_mla if arch == "deepseek-v2-236b" \
        else paged_flash_decode
    ov = {"dtype": "float32"}
    if arch == "smollm-360m":
        ov["attn_impl"] = "pallas"
    outs = {}
    for dev in ("cuda", "cpu"):
        f = LocalFleet([arch], batch=3, gen_tokens=6, warmup=False,
                       decode_impl="flash_paged", arch_overrides={arch: ov},
                       device=dev)
        before = kernel.launches
        outs[dev] = _preempt_roundtrip(f, arch)
        ref, got, vip = outs[dev]
        assert got == ref and len(vip) == 2
        if dev == "cuda":
            assert kernel.launches > before
    assert outs["cuda"] == outs["cpu"]


def test_image_lane_on_card_equals_cpu(cuda):
    """The sd-tiny denoiser in torch ops on the card gives the CPU's image
    payloads (elementwise float32: the same bits), and a served image
    comes back through the router transport."""
    from repro_torch.serving.fleet import LocalFleet
    prompts = ["Draw an illustration of a fox in a forest",
               "Generate an image of a sailboat logo", "a red fox",
               "blue mountain", "late arrival"]
    outs = {}
    for dev in ("cuda", "cpu"):
        f = LocalFleet(["sd-tiny"], batch=2, device=dev)
        assert f.lanes["sd-tiny"].latents.device.type == dev
        outs[dev] = [o["image"] for o in f.generate("sd-tiny", prompts)]
    assert outs["cuda"] == outs["cpu"]
    assert all(len(o["data"]) == 64 for o in outs["cuda"])


# ---------------------------------------------------------------------------
# contiguous-cache decode and multi-adapter LoRA (kernel 6)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Skv,Hq,Hkv,hd,dtype", [
    (4, 512, 8, 2, 64, torch.float32), (2, 384, 6, 6, 128, torch.float32),
    (3, 1024, 16, 4, 64, torch.float32), (2, 256, 4, 1, 64, torch.bfloat16)])
def test_flash_decode_kernel_matches_plain(cuda, B, Skv, Hq, Hkv, hd, dtype):
    """``tests/test_kernels.py``'s DECODE_CASES through the flash-attention
    kernel with one query position per row."""
    g = torch.Generator(device=cuda).manual_seed(Skv)
    q = torch.randn((B, Hq, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, Skv, Hkv, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, Skv, Hkv, hd), generator=g, device=cuda).to(dtype)
    kl = torch.randint(1, Skv + 1, (B,), generator=g, device=cuda,
                       dtype=torch.int32)
    before = flash_attention.launches
    out = flash_decode(q, k, v, kl)
    ref = flash_decode_plain(q, k, v, kl)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    _close(out, ref, dtype)


# N, din, dout, T, r: tests/test_kernels.py's LORA_CASES and the encoder
# path's shape (5 tasks x 12 texts x 512 tokens at ModernBERT-base width);
# then the edges of the kernel's tiling (tiles of BM = 128 rows, 32-column
# x/A chunks, 64-column B chunks, rank padded to 8/16/32/64): N = 1; runs
# straddling tile edges; din/dout with chunk tails (100 -> 36) and not
# multiples of 4 (99 -> 37: element copies, unpaired stores); ranks 1 and
# 64 at ModernBERT-base width; one task only
LORA = [(256, 768, 768, 6, 32), (130, 512, 256, 3, 16),
        (256, 384, 384, 10, 64), (64, 128, 128, 1, 8),
        (5 * 12 * 512, 768, 768, 5, 32),
        (1, 768, 768, 5, 32), (514, 768, 768, 4, 32), (300, 100, 36, 3, 16),
        (300, 99, 37, 3, 5), (256, 768, 768, 4, 1), (300, 768, 768, 5, 64),
        (640, 768, 768, 1, 32)]
LORA_BM = 128                 # rows per tile of csrc/multi_lora.cu
# sorted run lengths around the tile edge: 1, BM - 1, BM + 1, 2 BM + 1
LORA_RUNS = (1, LORA_BM - 1, LORA_BM + 1, 2 * LORA_BM + 1)


def _lora_ids(cuda, N, T, layout):
    g = torch.Generator().manual_seed(N + T)
    if layout == "sorted":                  # multitask_logits' layout
        ids = torch.arange(N) * T // N
    elif layout == "shuffled_absent":       # random order, task T-1 absent
        ids = (torch.arange(N) % max(1, T - 1))[torch.randperm(N,
                                                               generator=g)]
    elif layout == "runs":                  # sorted runs across tile edges
        runs, i = [], 0
        while sum(runs) < N:
            runs.append(LORA_RUNS[i % len(LORA_RUNS)])
            i += 1
        ids = torch.cat([torch.full((n,), k % T) for k, n in
                         enumerate(runs)])[:N]
    elif layout == "all_out_of_range":      # no valid id: all rows zero
        ids = torch.tensor([-1, T, 1 << 20, -7]).repeat(N)[:N]
    else:                                   # out-of-range ids mixed in
        ids = torch.randint(0, T, (N,), generator=g)
        ids[::7] = -1
        ids[3::11] = T
        ids[5::13] = 1 << 20
    return ids.to(torch.int32).to(cuda)


@pytest.mark.parametrize("layout", ["sorted", "shuffled_absent",
                                    "out_of_range", "runs",
                                    "all_out_of_range"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,din,dout,T,r", LORA,
                         ids=[f"ml{i}" for i in range(len(LORA))])
def test_multi_lora_kernel_matches_plain(cuda, N, din, dout, T, r, dtype,
                                         layout):
    g = torch.Generator(device=cuda).manual_seed(din + r)
    x = torch.randn((N, din), generator=g, device=cuda).to(dtype)
    a = (torch.randn((T, din, r), generator=g, device=cuda) * 0.05).to(dtype)
    b = (torch.randn((T, r, dout), generator=g, device=cuda) * 0.05).to(dtype)
    ids = _lora_ids(cuda, N, T, layout)
    before = multi_lora.launches
    out = multi_lora(x, a, b, ids, scale=2.0)
    ref = multi_lora_plain(x, a, b, ids, scale=2.0)
    torch.cuda.synchronize()
    assert multi_lora.launches == before + 1
    assert out.shape == (N, dout) and out.dtype == dtype
    _close(out, ref, dtype)
    dead = (ids < 0) | (ids >= T)
    assert bool((out[dead] == 0).all())
    w = torch.randn((din, dout), generator=g, device=cuda).to(dtype)
    fused = multi_lora(x, a, b, ids, w, scale=2.0)
    torch.cuda.synchronize()
    assert torch.equal(fused, x @ w + out)


def test_multi_lora_kernel_refuses_short_shared_memory(cuda):
    """The C entry refuses a launch given one byte less dynamic shared
    memory than ``lora_geometry``'s (the kernel's carve) at every padded
    rank, and takes exactly that much."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.multi_lora.ops import _ARGTYPES, lora_geometry
    fn = _build.c_function("multi_lora", "multi_lora_fwd", _ARGTYPES)
    stream = torch.cuda.current_stream().cuda_stream
    for dtype in (torch.float32, torch.bfloat16):
        for r in (1, 16, 32, 64):
            g = torch.Generator(device=cuda).manual_seed(r)
            x = torch.randn((130, 40), generator=g, device=cuda).to(dtype)
            a = torch.randn((2, 40, r), generator=g, device=cuda).to(dtype)
            b = torch.randn((2, r, 24), generator=g, device=cuda).to(dtype)
            ids = (torch.arange(130, device=cuda) % 2).to(torch.int32)
            out = torch.empty((130, 24), device=cuda, dtype=dtype)
            geo = lora_geometry(r, x.element_size())
            args = (x.data_ptr(), a.data_ptr(), b.data_ptr(), ids.data_ptr(),
                    out.data_ptr(), 130, 40, 24, 2, r, 1.0,
                    int(dtype == torch.bfloat16))
            assert fn(*args, geo.smem_bytes - 1, stream) != 0
            assert fn(*args, geo.smem_bytes, stream) == 0
            torch.cuda.synchronize()
            _close(out, multi_lora_plain(x, a, b, ids), dtype)


def test_multi_lora_kernel_rejects_bad_inputs(cuda):
    x = torch.zeros((4, 8), device=cuda)
    a = torch.zeros((2, 8, 65), device=cuda)
    b = torch.zeros((2, 65, 8), device=cuda)
    ids = torch.zeros((4,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="rank"):
        multi_lora(x, a, b, ids)
    with pytest.raises(ValueError, match="int32"):
        multi_lora(x, a[:, :, :4].contiguous(), b[:, :4].contiguous(),
                   ids.long())
    with pytest.raises(TypeError):
        multi_lora(x.half(), a[:, :, :4].half().contiguous(),
                   b[:, :4].half().contiguous(), ids)


def test_multi_lora_launch_count_is_exact_across_threads(cuda):
    """The signal engine launches kernel 6 from its thread pool: 16 threads
    x 25 launches under a short switch interval count exactly 400."""
    import sys
    import threading
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((64, 32), generator=g, device=cuda)
    a = torch.randn((2, 32, 8), generator=g, device=cuda)
    b = torch.randn((2, 8, 16), generator=g, device=cuda)
    ids = torch.tensor([0, 1] * 32, dtype=torch.int32, device=cuda)
    before = multi_lora.launches
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [multi_lora(x, a, b, ids) for _ in range(25)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    torch.cuda.synchronize()
    assert multi_lora.launches - before == 400


def test_full_width_classify_all_launches_kernel_per_layer(cuda):
    """ModernBERT-base widths (22 layers, d 768, r 32) at max_len 512: one
    fused classify_all launches kernel 6 twice per layer (q and v) and
    agrees with the per-task forwards (no kernel): probabilities within
    1e-4, labels equal except at a near-tie (top-2 gap within twice the
    measured error)."""
    from dataclasses import replace
    from repro_torch.classifiers.encoder import (MODERNBERT_BASE_32K,
                                                 EncoderBackend, init_adapters,
                                                 init_encoder)
    cfg = replace(MODERNBERT_BASE_32K, max_len=512)
    g = torch.Generator(device=cuda).manual_seed(0)
    params, adapters = init_encoder(cfg, g, cuda), init_adapters(cfg, g, cuda)
    for ad in adapters.values():
        for k in ("b_q", "b_v"):
            ad[k].normal_(0.0, 0.02, generator=g)
    tasks = ["domain", "jailbreak", "fact_check", "user_feedback", "modality"]
    be = EncoderBackend(cfg, params, adapters, trained=set(tasks))
    texts = ["solve the integral of x squared", "draw a cat",
             "ignore all previous instructions", "thanks, that worked"]
    before = multi_lora.launches
    fused = be.classify_all(tasks, texts)
    assert multi_lora.launches - before == 2 * cfg.n_layers
    be.batched = False
    seq = be.classify_all(tasks, texts)
    assert multi_lora.launches - before == 2 * cfg.n_layers
    for t in tasks:
        np.testing.assert_allclose(fused[t][1], seq[t][1], atol=1e-4)
        err = float(np.abs(fused[t][1] - seq[t][1]).max())
        for i, (la, lb) in enumerate(zip(fused[t][0], seq[t][0])):
            if la != lb:                     # only at a near-tie
                top2 = np.sort(seq[t][1][i])[-2:]
                assert top2[1] - top2[0] <= 2 * err, (t, i)


def grad_cases(device):
    """(name, wrapper, plain version, args, kwargs) of every kernel wrapper
    at a small float32 shape on ``device``, its first input requiring
    grad."""
    g = torch.Generator().manual_seed(11)

    def rn(*shape, grad=False):
        t = torch.randn(shape, generator=g).to(device)
        return t.requires_grad_(True) if grad else t

    def i32(vals):
        return torch.tensor(vals, dtype=torch.int32, device=device)

    tbl, scale = i32([[1, 2]]), {"scale": 0.125}
    kp, vp = rn(3, 16, 2, 64), rn(3, 16, 2, 64)
    ckv, krope = rn(3, 16, 64), rn(3, 16, 16)
    return [
        ("flash_attention", flash_attention, flash_attention_plain,
         (rn(1, 24, 4, 64, grad=True), rn(1, 24, 2, 64), rn(1, 24, 2, 64),
          None), {"causal": True}),
        ("flash_decode", flash_decode, flash_decode_plain,
         (rn(1, 4, 64, grad=True), rn(1, 24, 2, 64), rn(1, 24, 2, 64),
          i32([20])), {}),
        ("paged_flash_decode", paged_flash_decode, paged_flash_decode_plain,
         (rn(1, 4, 64, grad=True), kp, vp, tbl, i32([20])), {}),
        ("paged_flash_verify", paged_flash_verify, paged_flash_verify_plain,
         (rn(1, 3, 4, 64, grad=True), kp, vp, tbl, i32([20])), {}),
        ("paged_flash_decode_mla", paged_flash_decode_mla,
         paged_flash_decode_mla_plain,
         (rn(1, 4, 64, grad=True), rn(1, 4, 16), ckv, krope, tbl,
          i32([20])), scale),
        ("paged_flash_verify_mla", paged_flash_verify_mla,
         paged_flash_verify_mla_plain,
         (rn(1, 3, 4, 64, grad=True), rn(1, 3, 4, 16), ckv, krope, tbl,
          i32([20])), scale),
        ("multi_lora", multi_lora, multi_lora_plain,
         (rn(40, 32, grad=True), rn(2, 32, 8), rn(2, 8, 32),
          i32([0] * 20 + [1] * 20)), {}),
    ]


@pytest.mark.parametrize("i", range(7))
def test_wrappers_refuse_autograd(cuda, i):
    """A wrapper whose input requires grad raises under autograd instead
    of returning a result with no ``grad_fn``; under ``torch.no_grad`` it
    launches its kernel (counted) and agrees with its plain version."""
    name, fn, plain, args, kw = grad_cases(cuda)[i]
    with pytest.raises(NotImplementedError, match="no gradient"):
        fn(*args, **kw)
    with torch.no_grad():
        counter = flash_attention if name == "flash_decode" else fn
        before = counter.launches
        out = fn(*args, **kw)
        assert counter.launches == before + 1
        _close(out, plain(*args, **kw), torch.float32)


# ---------------------------------------------------------------------------
# the model axis: each rank's kernels at its local shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["prefill_479", "prefill_16", "decode",
                                    "mla_decode", "mla_verify"])
def test_kernels_at_sharded_local_shapes(cuda, dtype, kernel):
    """qwen3-moe-235b over 2 ranks: each rank's 32 of 64 query heads and 2
    of 4 KV heads of 128 (kernel 1 at the fleet's longest prefill and at a
    16-token bucket, kernel 2 over the fleet's 32-block table); deepseek-v2
    over 2 ranks: 64 of 128 MLA heads (kernels 4 and 5, verify W = 5)."""
    g = torch.Generator(device=cuda).manual_seed(64)
    if kernel.startswith("prefill"):
        S = int(kernel.split("_")[1])
        q = torch.randn((1, S, 32, 128), generator=g, device=cuda).to(dtype)
        k = torch.randn((1, S, 2, 128), generator=g, device=cuda).to(dtype)
        v = torch.randn((1, S, 2, 128), generator=g, device=cuda).to(dtype)
        before = flash_attention.launches
        out = flash_attention(q, k, v, None, causal=True)
        ref = flash_attention_plain(q, k, v, None, causal=True)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        _close(out, ref, dtype)
        return
    blk, max_blocks, B = 16, 32, 8
    rnd = random.Random(7)
    lens = [0, 1, 15, 16, 17, 255, 479, max_blocks * blk]
    if kernel == "decode":
        nb = 1 + (B + 4) * max_blocks
        tbl = torch.tensor([[rnd.randrange(1, nb) for _ in range(max_blocks)]
                            for _ in range(B)], dtype=torch.int32,
                           device=cuda)
        q = torch.randn((B, 32, 128), generator=g, device=cuda).to(dtype)
        kp = torch.randn((nb, blk, 2, 128), generator=g,
                         device=cuda).to(dtype)
        vp = torch.randn((nb, blk, 2, 128), generator=g,
                         device=cuda).to(dtype)
        kl = torch.tensor(lens, dtype=torch.int32, device=cuda)
        before = paged_flash_decode.launches
        out = paged_flash_decode(q, kp, vp, tbl, kl)
        ref = paged_flash_decode_plain(q, kp, vp, tbl, kl)
        torch.cuda.synchronize()
        assert paged_flash_decode.launches == before + 1
        _close(out, ref, dtype)
        return
    nb = 1 + (B + 4) * max_blocks
    args = _mla_case(cuda, dtype, B=B, H=64, r=512, rh=64, nb=nb,
                     max_blocks=max_blocks, seed=64)
    scale = 1.0 / (2.0 * 64) ** 0.5
    if kernel == "mla_decode":
        before = paged_flash_decode_mla.launches
        out = paged_flash_decode_mla(*args, scale=scale)
        ref = paged_flash_decode_mla_plain(*args, scale=scale)
        torch.cuda.synchronize()
        assert paged_flash_decode_mla.launches == before + 1
        _close(out, ref, dtype)
        return
    W = 5
    kl = torch.tensor(_verify_lens(B, max_blocks * blk, W, 64),
                      dtype=torch.int32, device=cuda)
    vargs = (torch.randn((B, W, 64, 512), generator=g, device=cuda).to(dtype),
             torch.randn((B, W, 64, 64), generator=g, device=cuda).to(dtype),
             args[2], args[3], args[4], kl)
    before = paged_flash_verify_mla.launches
    out = paged_flash_verify_mla(*vargs, scale=scale)
    ref = paged_flash_verify_mla_plain(*vargs, scale=scale)
    torch.cuda.synchronize()
    assert paged_flash_verify_mla.launches == before + 1
    _close(out, ref, dtype)


def test_reduced_sharded_fleet_on_card_equals_cpu(cuda):
    """The reduced float32 qwen3-moe fleet over 2 ranks on the card (both
    kernels on) gives the tokens of the same fleet over 2 CPU ranks and of
    the unsharded fleet; each rank launched both kernels."""
    from repro_torch.launch import mesh as LM
    from repro_torch.serving.fleet import LocalFleet
    arch = "qwen3-moe-235b-a22b"
    kw = dict(batch=2, max_seq=64, gen_tokens=6, warmup=False,
              decode_impl="flash_paged",
              arch_overrides={arch: {"dtype": "float32",
                                     "attn_impl": "pallas"}})
    prompts = ["shard me across ranks", "tiny",
               " ".join(f"w{i}" for i in range(30))]
    want = [o["tokens"] for o in LocalFleet([arch], device="cpu", **kw)
            .generate(arch, prompts)]
    for dev in ("cuda", "cpu"):
        with LM.host_ranks(2, device=dev):
            f = LocalFleet([arch], model_axis=2, device=dev, **kw)
            f.rank_stats(reset=True)
            got = [o["tokens"] for o in f.generate(arch, prompts)]
            stats = f.rank_stats()
        assert got == want, dev
        if dev == "cuda":
            for s in stats:
                assert s["launches"]["flash_attention"] > 0
                assert s["launches"]["paged_flash_decode"] > 0
            assert stats[0]["launches"] == stats[1]["launches"]


# ---------------------------------------------------------------------------
# the model axis, training half: build_train_step over ranks on the card
# ---------------------------------------------------------------------------

def _train_rank(arch, named, device, steps=3, ckdir=None):
    """One rank: ``steps`` of ``build_train_step`` on ``make_host_mesh(2)``
    for the reduced float32 ``arch`` from the whole weights ``named`` on
    ``device`` (``device`` None: ``make_step_fn`` on the CPU without a
    mesh); per step (loss, grad norm), and the whole weights after on the
    CPU.  ``ckdir``: the ranks also save their state there."""
    from repro_torch.bridge import shard_params, train_state_tree, whole_params
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as MD
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_lib import build_train_step, make_step_fn
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced(arch).replace(dtype="float32")
    oc = AdamWConfig(warmup_steps=1)
    mesh = None
    if device is None:
        params = MD.Model(cfg, "cpu")
        params.load_state_dict(named)
        step = make_step_fn(cfg, oc, moe_impl="ep")
    else:
        mesh = LM.make_host_mesh(2)
        params = MD.Model(cfg, device, mesh=mesh)
        params.load_state_dict(shard_params(named, cfg, mesh))
        step, _ = build_train_step(cfg, mesh, oc, batch=4, moe_impl="ep")
    opt = init_opt_state(params)
    stream = TokenStream(cfg.vocab_size, 4, 32)
    out = []
    for i in range(steps):
        toks, labels = (torch.from_numpy(a) for a in stream.batch_at(i))
        params, opt, met = step(params, opt, toks, labels)
        out.append((float(met["loss"]), float(met["grad_norm"])))
    if ckdir is not None:
        save_checkpoint(ckdir, steps, train_state_tree(params, opt, cfg),
                        {"next_step": steps}, mesh=mesh)
    if mesh is None:
        return out, {k: v.cpu() for k, v in params.state_dict().items()}
    return out, whole_params(params, params, mesh)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-moe-235b-a22b"])
def test_sharded_train_step_on_card_equals_cpu(cuda, arch, tmp_path):
    """``build_train_step`` over 2 card ranks (data 1 x model 2: tensor-,
    vocab- and expert-parallel, gradients through the collectives) ==
    over 2 CPU ranks == ``make_step_fn`` unsharded on the CPU, reduced
    float32: losses and gradient norms within rel 1e-5; the card ranks'
    checkpoint restores in one CPU process to their weights, bit for
    bit."""
    from repro_torch.bridge import (opt_state_to_jax, params_from_jax,
                                    ref_tree)
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_reduced
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as MD
    from repro_torch.training.optimizer import init_opt_state
    cfg = get_reduced(arch).replace(dtype="float32")
    named = MD.init_params(cfg, torch.Generator().manual_seed(0),
                           "cpu").state_dict()
    want, _ = _train_rank(arch, named, None)
    ck = str(tmp_path / "ck")
    with LM.host_ranks(2, device="cuda") as ctl:
        card = ctl.gather(_train_rank, arch, named, "cuda", 3, ck)
        cpu = ctl.gather(_train_rank, arch, named, "cpu")
    for run, _ in card + cpu:
        for got, ref in zip(run, want):
            for a, b in zip(got, ref):
                assert abs(a - b) <= 1e-5 * abs(b), (run, want)
    model = MD.Model(cfg, "cpu")
    opt = init_opt_state(model)
    (ptree, _), meta = restore_checkpoint(
        ck, 3, (ref_tree(model, cfg), opt_state_to_jax(opt, cfg,
                                                        numpy=False)))
    assert meta == {"next_step": 3}
    model.load_state_dict(params_from_jax(ptree))
    for k, v in model.state_dict().items():
        assert torch.equal(v, card[0][1][k]), k


# ---------------------------------------------------------------------------
# the roofline plane on the card: the cost model's exactness
# ---------------------------------------------------------------------------

def _roofline_state(arch, device, max_seq=64):
    from repro_torch.configs import get_reduced
    from repro_torch.models import model as MD
    from repro_torch.roofline import steps as ST
    cfg = get_reduced(arch).replace(dtype="float32",
                                    decode_impl="flash_paged")
    if not cfg.is_mla:
        cfg = cfg.replace(attn_impl="pallas")
    gen = torch.Generator().manual_seed(0)
    params = MD.init_params(cfg, gen, "cpu")
    cache = ST.paged_cache(cfg, 4, max_seq, 16, "cpu")
    ST.fill(cfg, params, cache, [5, 17, 33, 9], gen)
    params = params.to(device)
    cache = {k: (v.to(device) if isinstance(v, torch.Tensor) else
                 {b: {n: t.to(device) for n, t in lv.items()}
                  for b, lv in v.items()}) for k, v in cache.items()}
    toks = torch.randint(0, cfg.vocab_size, (1, 20), generator=gen,
                         dtype=torch.int32).to(device)
    dtoks = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen,
                          dtype=torch.int32).to(device)
    return cfg, params, cache, toks, dtoks


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-236b"])
def test_cost_mode_on_card_equals_meta_and_cpu_kernel_notes(cuda, arch):
    """The reduced member's paged prefill and ``flash_paged`` decode traced
    on the card count exactly what their meta twins count (FLOPs by dtype,
    bytes, ops, kernel regions), and the kernels' cost notes equal those
    of the same steps on the CPU (plain versions)."""
    from repro_torch.models import model as MD
    from repro_torch.roofline import steps as ST
    runs = {}
    for dev in ("cuda", "cpu"):
        cfg, params, cache, toks, dtoks = _roofline_state(arch, dev)
        runs[dev] = {"prefill": ST.trace(ST.prefill(cfg, params, cache, toks,
                                                    row=3), dev),
                     "decode": ST.trace(ST.decode(cfg, params, cache, dtoks),
                                        dev)}
        if dev == "cuda":
            values = {}
            mcache = ST.meta_of(cache, values)
            meta = MD.Model(cfg, "meta")
            runs["meta"] = {
                "prefill": ST.trace(ST.prefill(cfg, meta, mcache,
                                               ST.meta_of(toks, values),
                                               row=3), "meta", values),
                "decode": ST.trace(ST.decode(cfg, meta, mcache,
                                             ST.meta_of(dtoks, values)),
                                   "meta", values)}
    for kind in ("prefill", "decode"):
        card, meta, cpu = (runs[d][kind].totals()
                           for d in ("cuda", "meta", "cpu"))
        assert dict(card.flops_by_dtype) == dict(meta.flops_by_dtype), kind
        assert card.bytes == meta.bytes and card.ops == meta.ops, kind
        assert card.kernels == meta.kernels == cpu.kernels, kind
    assert runs["cuda"]["decode"].totals().kernels


def test_flash_paged_decode_step_lints_clean_on_card(cuda):
    """On the card the whole ``flash_paged`` decode step (4 slots,
    max_seq 112: no width of the reduced configs) shows no (B, S) / (2B,
    S) shape and no host sync outside the kernel regions, and replaying
    it builds or loads no kernel."""
    from repro_torch.analysis import RecompileGuard, build_counters, lint_fn
    from repro_torch.roofline import steps as ST
    for arch in ("smollm-360m", "deepseek-v2-236b"):
        cfg, params, cache, _, dtoks = _roofline_state(arch, "cuda", 112)
        step = ST.decode(cfg, params, cache, dtoks)
        step.run()
        guard = RecompileGuard(build_counters())
        findings = lint_fn(step.run, banned_leading_shapes=[(4, 112),
                                                            (8, 112)])
        assert findings == [], (arch, [str(f) for f in findings])
        for _ in range(3):
            step.run()
        guard.assert_no_recompiles()


def test_decide_batch_counts_one_host_transfer_on_card(cuda):
    """``RouterProgram.decide_batch`` on the card: the gate lints clean,
    and the whole call has exactly the one documented host transfer."""
    from repro_torch.analysis import lint_fn
    from repro_torch.core.program import compile_router_program
    with open("examples/policies/cost.vsr") as f:
        prog = compile_router_program(f.read(), device="cuda")
    rng = np.random.default_rng(1)
    match = (rng.random((4, len(prog.keys))) > 0.5).astype(np.float32)
    conf = rng.random((4, len(prog.keys))).astype(np.float32)
    findings = lint_fn(prog.decide_batch, match, conf)
    assert [f.rule for f in findings] == ["host-sync"], [str(f) for f in
                                                         findings]
    assert lint_fn(prog._gate, torch.as_tensor(match, device="cuda"),
                   torch.as_tensor(conf, device="cuda")) == []
