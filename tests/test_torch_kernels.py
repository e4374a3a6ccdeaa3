"""The port's kernel modules on the CPU: the plain versions against the JAX
kernels and oracles, and the wrappers' device dispatch.

On a CPU tensor each wrapper runs its plain version; the CUDA kernels
themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  Inputs are drawn with numpy from fixed seeds.

Tolerances: ``_tol`` of ``tests/test_kernels.py`` (float32 2e-5, bf16
2e-2, as atol = rtol) — the same limits the JAX kernel is held to.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import (attention_reference as j_attn_ref,
                                           flash_attention as j_flash)
from repro.kernels.flash_decode import paged_decode_reference as j_paged_ref
from repro.kernels.flash_decode import paged_mla_decode_reference as j_mla_ref
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (attention_reference,
                                                 flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_decode import (gather_kv,
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
from test_kernels import FLASH_CASES, _tol


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


def test_build_is_lazy_and_keyed_by_source(monkeypatch, tmp_path):
    """Importing the kernel modules builds nothing; the library name
    carries the source hash; a missing nvcc is a clear error."""
    assert not _build._libs
    assert _build._lib_path("paged_decode") == _build._lib_path("paged_decode")
    assert _build._lib_path("paged_decode") != \
        _build._lib_path("flash_attention")
    assert len({_build._lib_path(n) for n in _build.SOURCES}) == \
        len(_build.SOURCES) == 3
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
