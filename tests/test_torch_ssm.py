"""The port's recurrent mixers (``repro_torch.models.ssm``) against the
JAX ones, and the SSM members (jamba: mamba + attention + MoE; xlstm:
mLSTM + sLSTM) served from the contiguous cache.

The six cases of ``tests/test_ssm.py`` run on the port's functions with
the reference's ``*_init`` parameters (float32, reduced configs): chunked
== stepwise within the reference's tolerances, state carried across
segments, mLSTM stable over 512 tokens, causal-conv state — and each port
function also against its JAX twin on the same inputs, within 1e-5 (both
compute in float32; the port keeps the reference's chunking and its
associative-scan combine order).  The fleets are token-exact against the
JAX fleets over bridged weights at float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import ssm as JS
from repro.serving.fleet import LocalFleet as JaxFleet
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.models import ssm as S
from repro_torch.serving.fleet import LocalFleet
from repro_torch.serving.scheduler import PREFILL_BUCKETS, bucket_len

KEY = jax.random.PRNGKey(42)
JAMBA, XLSTM = "jamba-v0.1-52b", "xlstm-350m"
VS_JAX = dict(atol=1e-5, rtol=1e-5)


def _cfgs(arch):
    return (j_get_reduced(arch).replace(dtype="float32"),
            get_reduced(arch).replace(dtype="float32"))


def _t(tree):
    """JAX pytree -> the same nesting of float32 CPU tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _n(tree):
    if isinstance(tree, dict):
        return {k: _n(v) for k, v in tree.items()}
    return np.asarray(tree)


def _close(a, b, **tol):
    a, b = _n(a), _n(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k], **tol)
        return
    np.testing.assert_allclose(a, b, **tol)


def _x(shape, scale=0.5):
    return jax.random.normal(KEY, shape) * scale


def _steps(step, p, cfg, x, st):
    ys = []
    for t in range(x.shape[1]):
        y1, st = step(p, cfg, x[:, t:t + 1], st)
        ys.append(y1)
    return torch.cat(ys, dim=1), st


def test_mamba_chunked_equals_stepwise():
    jcfg, cfg = _cfgs(JAMBA)
    jp = JS.mamba_init(KEY, jcfg, jnp.float32)
    p = _t(jp)
    x = _x((2, 16, cfg.d_model))
    y_full, st_full = S.mamba_forward(p, cfg, _t(x), return_state=True)
    y_seq, st = _steps(S.mamba_step, p, cfg, _t(x),
                       S.zero_state(cfg, "mamba", 2, torch.float32, "cpu"))
    _close(y_full, y_seq, atol=1e-4, rtol=1e-4)
    _close(st_full["h"], st["h"], atol=1e-4, rtol=1e-4)
    jy, jst = JS.mamba_forward(jp, jcfg, x, return_state=True)
    _close(y_full, jy, **VS_JAX)
    _close(st_full, jst, **VS_JAX)
    jy1, jst1 = JS.mamba_step(jp, jcfg, x[:, :1],
                              JS.mamba_zero_state(jcfg, 2, jnp.float32))
    y1, st1 = S.mamba_step(p, cfg, _t(x[:, :1]),
                           S.zero_state(cfg, "mamba", 2, torch.float32,
                                        "cpu"))
    _close(y1, jy1, **VS_JAX)
    _close(st1, jst1, **VS_JAX)


def test_mamba_state_carry_across_segments():
    jcfg, cfg = _cfgs(JAMBA)
    jp = JS.mamba_init(KEY, jcfg, jnp.float32)
    p = _t(jp)
    x = _x((1, 12, cfg.d_model))
    y_full, _ = S.mamba_forward(p, cfg, _t(x))
    y1, st = S.mamba_forward(p, cfg, _t(x[:, :7]), return_state=True)
    y2, _ = S.mamba_forward(p, cfg, _t(x[:, 7:]), state=st)
    _close(torch.cat([y1, y2], 1), y_full, atol=1e-4, rtol=1e-4)
    jy1, jst = JS.mamba_forward(jp, jcfg, x[:, :7], return_state=True)
    jy2, _ = JS.mamba_forward(jp, jcfg, x[:, 7:], state=jst)
    _close(y2, jy2, **VS_JAX)
    _close(st, jst, **VS_JAX)


def test_mlstm_chunked_equals_stepwise():
    jcfg, cfg = _cfgs(XLSTM)
    jp = JS.mlstm_init(KEY, jcfg, jnp.float32)
    p = _t(jp)
    x = _x((2, 16, cfg.d_model))
    y_full, st_full = S.mlstm_forward(p, cfg, _t(x), return_state=True)
    y_seq, st = _steps(S.mlstm_step, p, cfg, _t(x),
                       S.zero_state(cfg, "mlstm", 2, torch.float32, "cpu"))
    _close(y_full, y_seq, atol=2e-4, rtol=2e-3)
    _close(st_full["C"], st["C"], atol=2e-4, rtol=2e-3)
    jy, jst = JS.mlstm_forward(jp, jcfg, x, return_state=True)
    _close(y_full, jy, **VS_JAX)
    _close(st_full, jst, **VS_JAX)
    jst0 = JS.mlstm_zero_state(jcfg, 2, jnp.float32)
    jy1, jst1 = JS.mlstm_step(jp, jcfg, x[:, :1], jst0)
    y1, st1 = S.mlstm_step(p, cfg, _t(x[:, :1]), _t(jst0))
    _close(y1, jy1, **VS_JAX)
    _close(st1, jst1, **VS_JAX)


def test_slstm_forward_equals_stepwise():
    jcfg, cfg = _cfgs(XLSTM)
    jp = JS.slstm_init(KEY, jcfg, jnp.float32)
    p = _t(jp)
    x = _x((2, 10, cfg.d_model))
    y_full, st_full = S.slstm_forward(p, cfg, _t(x), return_state=True)
    y_seq, st = _steps(S.slstm_step, p, cfg, _t(x),
                       S.zero_state(cfg, "slstm", 2, torch.float32, "cpu"))
    _close(y_full, y_seq, atol=1e-5, rtol=1e-5)
    _close(st_full["c"], st["c"], atol=1e-5, rtol=1e-5)
    jy, jst = JS.slstm_forward(jp, jcfg, x, return_state=True)
    _close(y_full, jy, **VS_JAX)
    _close(st_full, jst, **VS_JAX)


def test_mlstm_stability_long_context():
    """Exponential gating must not overflow across 512 tokens (two chunks
    of 256), and the port follows the reference there too."""
    jcfg, cfg = _cfgs(XLSTM)
    jp = JS.mlstm_init(KEY, jcfg, jnp.float32)
    x = _x((1, 512, cfg.d_model), scale=2.0)
    y, st = S.mlstm_forward(_t(jp), cfg, _t(x), return_state=True)
    assert bool(torch.isfinite(y).all())
    assert bool(torch.isfinite(st["C"]).all())
    jy, jst = JS.mlstm_forward(jp, jcfg, x, return_state=True)
    _close(y, jy, atol=1e-4, rtol=1e-4)
    _close(st["m"], jst["m"], **VS_JAX)


def test_causal_conv_state_equivalence():
    w = jax.random.normal(KEY, (4, 8)) * 0.3
    b = jnp.zeros((8,))
    x = jax.random.normal(KEY, (2, 20, 8))
    tw, tb, tx = _t(w), _t(b), _t(x)
    y_full, _ = S._causal_conv(tx, tw, tb, None)
    y1, st = S._causal_conv(tx[:, :11], tw, tb, None)
    y2, _ = S._causal_conv(tx[:, 11:], tw, tb, st)
    _close(torch.cat([y1, y2], 1), y_full, atol=1e-5, rtol=1e-5)
    jy1, jst = JS._causal_conv(x[:, :11], w, b, None)
    _close(y1, jy1, **VS_JAX)
    _close(st, jst, **VS_JAX)


def test_associative_scan_matches_jax_bitwise():
    """The within-chunk scan keeps ``jax.lax.associative_scan``'s combine
    order: equal outputs at every length up to a chunk's, odd ones too."""
    rng = np.random.default_rng(0)
    for n in (1, 2, 5, 16, 33):
        a = rng.uniform(0.5, 1.0, (2, n, 3)).astype(np.float32)
        b = rng.standard_normal((2, n, 3)).astype(np.float32)
        ja, jb = jax.lax.associative_scan(
            lambda e1, e2: (e1[0] * e2[0], e2[0] * e1[1] + e2[1]),
            (jnp.asarray(a), jnp.asarray(b)), axis=1)
        ta, tb = S._associative_scan(S._mamba_combine,
                                     [torch.from_numpy(a),
                                      torch.from_numpy(b)])
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_bucket_len_exact_widths():
    cap = 95
    for n in (1, 3, 16, 17, 64, 65, 95, 200):
        assert bucket_len(n, cap, exact=True) == min(n, cap)
    assert [bucket_len(n, cap, exact=False) for n in (1, 16, 17, 65)] == \
        [16, 16, 64, cap]
    assert PREFILL_BUCKETS == (16, 64)


# ---------------------------------------------------------------------------
# the SSM members served from the contiguous cache
# ---------------------------------------------------------------------------

PROMPTS = ["a short one", "the second prompt is a little longer than that",
           " ".join(f"w{i}" for i in range(23)), "tiny"]


@pytest.mark.parametrize("arch", [JAMBA, XLSTM])
def test_ssm_fleet_tokens_match_jax(arch):
    """More prompts than slots, exact prefill widths (one width per prompt
    length), and a preemption round trip: identical tokens; both members
    stay on the contiguous cache."""
    f32 = {arch: {"dtype": "float32"}}
    jf = JaxFleet([arch], batch=2, gen_tokens=5, warmup=False,
                  arch_overrides=f32)
    tf = LocalFleet([arch], batch=2, gen_tokens=5, warmup=False,
                    arch_overrides=f32, device="cpu")
    tf.members[arch].params.load_state_dict(
        params_from_jax(jf.members[arch].params))
    m = tf.members[arch]
    assert not m.paged and m.exact_prefill
    a = [x["tokens"] for x in jf.generate(arch, PROMPTS)]
    b = [x["tokens"] for x in tf.generate(arch, PROMPTS)]
    assert b == a
    outs = []
    for fleet in (jf, tf):
        sched = fleet.schedulers[arch]
        sched.submit(np.arange(4, 24, dtype=np.int32), max_new=5)
        sched.submit(np.arange(30, 41, dtype=np.int32), max_new=5)
        sched.step()
        sched.submit(np.arange(50, 57, dtype=np.int32), max_new=5,
                     priority=10)
        outs.append({s.rid: list(s.out) for s in sched.drain()})
        assert sched.preempted == 1
    assert outs[1] == outs[0]
