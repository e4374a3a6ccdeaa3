"""The port's layer functions against their JAX twins (CPU, small shapes).

Inputs are drawn with numpy from a fixed seed and handed to both
packages.  Tolerances: float32 1e-5 (the two frameworks' CPU kernels sum
in different orders); bfloat16 2e-2 absolute + relative, a few bf16 ulps
(2^-8 relative) of the O(1) values compared — the frameworks round bf16
intermediates at different places.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models.config import BlockSpec, LayerGroup, ModelConfig
from repro_torch.models import layers as TL
from repro_torch.models.config import ModelConfig as TModelConfig

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(a: np.ndarray, dt: str):
    jd, td, _ = DTYPES[dt]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a, np.float32)).to(td)


def _close(j, t, dt):
    tol = DTYPES[dt][2]
    np.testing.assert_allclose(np.asarray(t.float()),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


def _cfgs(qk_norm=False):
    kw = dict(name="t", family="dense", d_model=24, n_heads=4, n_kv_heads=2,
              head_dim=8, d_ff=40, vocab_size=64, qk_norm=qk_norm)
    return (ModelConfig(groups=(LayerGroup((BlockSpec("attn"),), 1),), **kw),
            TModelConfig(groups=(), **kw))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_rms_norm(dt):
    r = np.random.default_rng(0)
    x, s = r.standard_normal((3, 5, 24)), 1 + 0.1 * r.standard_normal(24)
    (jx, tx), (js, ts) = _pair(x, dt), _pair(s, dt)
    _close(JL.rms_norm(jx, js, 1e-6), TL.rms_norm(tx, ts, 1e-6), dt)


@pytest.mark.parametrize("shape", [(7,), (2, 5)])
def test_rope_tables(shape):
    pos = np.random.default_rng(1).integers(0, 500, shape)
    jc, js = JL.rope_tables(jnp.asarray(pos, jnp.int32), 64, 1e4)
    tc, ts = TL.rope_tables(torch.from_numpy(pos), 64, 1e4)
    # angles up to 500 rad: f32 sin/cos of the same f32 angle, 1e-5
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope(dt, per_row):
    r = np.random.default_rng(2)
    x = r.standard_normal((2, 5, 3, 16))
    pos = r.integers(0, 100, (2, 5) if per_row else (5,))
    jcs = JL.rope_tables(jnp.asarray(pos, jnp.int32), 16, 1e4)
    tcs = TL.rope_tables(torch.from_numpy(pos), 16, 1e4)
    jx, tx = _pair(x, dt)
    _close(JL.apply_rope(jx, *jcs), TL.apply_rope(tx, *tcs), dt)


@pytest.mark.parametrize("case", [
    dict(causal=True), dict(causal=False, kv_len=5),
    dict(causal=True, sliding_window=3, q_offset=2),
    dict(causal=False, q_offset="vec", kv_len="vec"),
    dict(causal=True, q_offset="vec")])
def test_attn_mask(case):
    B, Sq, Skv = 3, 4, 9
    vec = np.asarray([0, 3, 5])
    jkw, tkw = {}, {}
    for k, v in case.items():
        if v == "vec":
            jkw[k], tkw[k] = jnp.asarray(vec, jnp.int32), torch.from_numpy(vec)
        else:
            jkw[k] = tkw[k] = v
    jm, jp = JL._attn_mask(B, Sq, Skv, **jkw)
    tm, tp = TL._attn_mask(B, Sq, Skv, **tkw)
    assert jp == tp
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


SDPA_CASES = [
    dict(causal=True),
    dict(causal=True, sliding_window=3),
    dict(causal=False, q_offset="vec", kv_len="vec"),
    dict(causal=True, q_offset="vec"),
]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("ci", range(len(SDPA_CASES)))
def test_sdpa(dt, ci):
    r = np.random.default_rng(3 + ci)
    B, Sq, Skv, Hq, Hkv, hd = 2, 4, 9, 6, 2, 8
    q, k, v = (r.standard_normal(s) for s in
               ((B, Sq, Hq, hd), (B, Skv, Hkv, hd), (B, Skv, Hkv, hd)))
    vec = np.asarray([2, 5])
    jkw, tkw = {}, {}
    for key, val in SDPA_CASES[ci].items():
        if val == "vec":
            jkw[key] = jnp.asarray(vec + (Sq if key == "kv_len" else 0),
                                   jnp.int32)
            tkw[key] = torch.from_numpy(vec + (Sq if key == "kv_len" else 0))
        else:
            jkw[key] = tkw[key] = val
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dt), _pair(k, dt), _pair(v, dt)
    _close(JL.sdpa(jq, jk, jv, **jkw), TL.sdpa(tq, tk, tv, **tkw), dt)


def _attn_params(r, cfg_t, dt, qk_norm):
    d, H, Hkv, hd = 24, 4, 2, 8
    p = {"wq": r.standard_normal((d, H * hd)) / 5,
         "wk": r.standard_normal((d, Hkv * hd)) / 5,
         "wv": r.standard_normal((d, Hkv * hd)) / 5,
         "wo": r.standard_normal((H * hd, d)) / 5}
    if qk_norm:
        p["q_norm"] = 1 + 0.1 * r.standard_normal(hd)
        p["k_norm"] = 1 + 0.1 * r.standard_normal(hd)
    pairs = {k: _pair(v, dt) for k, v in p.items()}
    return ({k: a for k, (a, _) in pairs.items()},
            {k: b for k, (_, b) in pairs.items()})


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("qk_norm", [False, True])
def test_attn_qkv_and_out(dt, qk_norm):
    r = np.random.default_rng(7)
    cfg_j, cfg_t = _cfgs(qk_norm)
    jp, tp = _attn_params(r, cfg_t, dt, qk_norm)
    jx, tx = _pair(r.standard_normal((2, 5, 24)), dt)
    pos = np.arange(5)
    jrope = JL.rope_tables(jnp.asarray(pos, jnp.int32), 8, 1e4)
    trope = TL.rope_tables(torch.from_numpy(pos), 8, 1e4)
    jqkv = JL.attn_qkv(jp, cfg_j, jx, jx, jrope, jrope)
    tqkv = TL.attn_qkv(tp, cfg_t, tx, tx, trope, trope)
    for a, b in zip(jqkv, tqkv):
        _close(a, b, dt)
    _close(JL.attn_out(jp, jqkv[0]), TL.attn_out(tp, tqkv[0]), dt)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_ffn_apply(dt):
    r = np.random.default_rng(8)
    p = {"w_gate": r.standard_normal((24, 40)) / 5,
         "w_up": r.standard_normal((24, 40)) / 5,
         "w_down": r.standard_normal((40, 24)) / 6}
    pairs = {k: _pair(v, dt) for k, v in p.items()}
    jx, tx = _pair(r.standard_normal((2, 3, 24)), dt)
    _close(JL.ffn_apply({k: a for k, (a, _) in pairs.items()}, jx),
           TL.ffn_apply({k: b for k, (_, b) in pairs.items()}, tx), dt)


def test_neg_inf_matches_reference():
    assert TL.NEG_INF == JL.NEG_INF


# ---------------------------------------------------------------------------
# MLA (reduced deepseek-v2: d 64, 4 heads, q_lora 32, r 16, nope 16, rope 8)
# ---------------------------------------------------------------------------

MLA_ARCH = "deepseek-v2-236b"


def _mla_params(r, dt, cfg):
    d, H = cfg.d_model, cfg.n_heads
    nh, rh, vh = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    rk = cfg.kv_lora_rank
    p = {"wq_a": r.standard_normal((d, cfg.q_lora_rank)) / 8,
         "q_norm": 1 + 0.1 * r.standard_normal(cfg.q_lora_rank),
         "wq_b": r.standard_normal((cfg.q_lora_rank, H * (nh + rh))) / 6,
         "wkv_a": r.standard_normal((d, rk + rh)) / 8,
         "kv_norm": 1 + 0.1 * r.standard_normal(rk),
         "wk_b": r.standard_normal((H, rk, nh)) / 4,
         "wv_b": r.standard_normal((H, rk, vh)) / 4,
         "wo": r.standard_normal((H * vh, d)) / 8}
    pairs = {k: _pair(v, dt) for k, v in p.items()}
    return ({k: a for k, (a, _) in pairs.items()},
            {k: b for k, (_, b) in pairs.items()})


def _mla_setup(dt, seed, S=6, per_row=False):
    from repro.configs import get_reduced as j_get_reduced
    from repro_torch.configs import get_reduced
    cfg_j, cfg_t = j_get_reduced(MLA_ARCH), get_reduced(MLA_ARCH)
    r = np.random.default_rng(seed)
    jp, tp = _mla_params(r, dt, cfg_t)
    jx, tx = _pair(r.standard_normal((2, S, cfg_t.d_model)), dt)
    pos = r.integers(0, 40, (2, S)) if per_row else np.arange(S)
    jrope = JL.rope_tables(jnp.asarray(pos, jnp.int32), cfg_t.rope_head_dim,
                           cfg_t.rope_theta)
    trope = TL.rope_tables(torch.from_numpy(pos), cfg_t.rope_head_dim,
                           cfg_t.rope_theta)
    return cfg_j, cfg_t, jp, tp, jx, tx, jrope, trope


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("per_row", [False, True])
def test_mla_q_and_kv_latent(dt, per_row):
    cfg_j, cfg_t, jp, tp, jx, tx, jrope, trope = _mla_setup(dt, 9,
                                                            per_row=per_row)
    for a, b in zip(JL.mla_q(jp, cfg_j, jx, jrope),
                    TL.mla_q(tp, cfg_t, tx, trope)):
        _close(a, b, dt)
    for a, b in zip(JL.mla_kv_latent(jp, cfg_j, jx, jrope),
                    TL.mla_kv_latent(tp, cfg_t, tx, trope)):
        _close(a, b, dt)


MLA_CASES = [
    dict(causal=True),                                   # prefill
    dict(causal=False, q_offset="vec", kv_len="vec"),    # per-row decode
    dict(causal=True, q_offset="vec"),                   # suffix prefill
]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("ci", range(len(MLA_CASES)))
def test_mla_attention(dt, ci):
    """Absorbed attention from the same latents: q from ``mla_q``, the
    cache from ``mla_kv_latent`` over 9 positions."""
    cfg_j, cfg_t, jp, tp, jx, tx, jrope, trope = _mla_setup(dt, 10 + ci, S=9)
    jc, jk = JL.mla_kv_latent(jp, cfg_j, jx, jrope)
    tc, tk = TL.mla_kv_latent(tp, cfg_t, tx, trope)
    Sq = 9 if MLA_CASES[ci] == dict(causal=True) else 3
    jq = [a[:, -Sq:] for a in JL.mla_q(jp, cfg_j, jx, jrope)]
    tq = [a[:, -Sq:] for a in TL.mla_q(tp, cfg_t, tx, trope)]
    vec = np.asarray([2, 6 - Sq + 3])
    jkw, tkw = {}, {}
    for key, val in MLA_CASES[ci].items():
        if val == "vec":
            v = vec + (Sq if key == "kv_len" else 0)
            jkw[key], tkw[key] = jnp.asarray(v, jnp.int32), torch.from_numpy(v)
        else:
            jkw[key] = tkw[key] = val
    _close(JL.mla_attention(jp, cfg_j, *jq, jc, jk, **jkw),
           TL.mla_attention(tp, cfg_t, *tq, tc, tk, **tkw), dt)
