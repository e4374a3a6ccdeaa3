"""The port's model against the JAX model: reduced smollm-360m (GQA) and
reduced deepseek-v2 (MLA + MoE, dropless, ``moe_impl="sort"``) with the
reference's ``init_params`` weights bridged over, through paged fresh
prefill, a prefix-hit suffix prefill and 8 decode steps.

Tolerances: float32 logits within 1e-4 absolute (both frameworks compute
in float32; they differ in summation order only) and greedy tokens
identical; bfloat16 logits within 5e-2 (bf16 rounds at 2^-8 relative and
the two frameworks round at different places), teacher-forced with the
reference's tokens so both sides see the same inputs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import model as JMD
from repro_torch.bridge import model_from_jax, params_from_jax
from repro_torch.configs import get_config, get_reduced
from repro_torch.models import model as MD
from repro_torch.serving.serve_lib import greedy

ARCH = "smollm-360m"
MLA_ARCH = "deepseek-v2-236b"
MAX_SEQ, BLK, NB, STEPS = 64, 16, 9, 8
ROWS = np.asarray([[1, 2, 3, 4], [1, 2, 5, 6]], np.int32)


def _inputs():
    """Row A: 40 tokens, fresh prefill at width 64.  Row B: A's first 32
    tokens (two shared blocks) + 13 of its own, a suffix prefill of 13
    tokens at width 16 from start 32 through a table that maps B's first
    two blocks onto A's."""
    r = np.random.default_rng(5)
    a = r.integers(4, 256, 40).astype(np.int32)
    b = np.concatenate([a[:32], r.integers(4, 256, 13).astype(np.int32)])
    ta = np.zeros((1, 64), np.int32)
    ta[0, :40] = a
    tb = np.zeros((1, 16), np.int32)
    tb[0, :13] = b[32:]
    return [(ta, [40], [0], ROWS[:1], True), (tb, [13], [32], ROWS[1:], False)]


def _dropless(cfg):
    """The fleet's MoE capacity rule (no-op without experts)."""
    if not cfg.n_experts:
        return cfg
    return cfg.replace(moe_capacity_factor=max(
        cfg.moe_capacity_factor, cfg.n_experts / cfg.moe_top_k))


def _jax_run(dtype, arch=ARCH):
    """The reference: both prefills, then STEPS greedy decode steps.
    Returns (params, logits per call, tokens fed at each decode step)."""
    cfg = _dropless(j_get_reduced(arch).replace(dtype=dtype))
    params = JMD.init_params(cfg, jax.random.PRNGKey(0))
    cache = JMD.init_paged_cache(cfg, 2, MAX_SEQ, NB, BLK)
    pre = jax.jit(functools.partial(JMD.prefill, cfg, moe_impl="sort"),
                  static_argnames=("paged_fresh",))
    dec = jax.jit(functools.partial(JMD.decode_step, cfg, moe_impl="sort"))
    logits, feeds = [], []
    for toks, lens, start, trow, fresh in _inputs():
        lg, cache = pre(params, jnp.asarray(toks), cache,
                        lens=jnp.asarray(lens, jnp.int32),
                        start=jnp.asarray(start, jnp.int32),
                        tbl=jnp.asarray(trow), paged_fresh=fresh)
        logits.append(np.asarray(lg, np.float32))
    cache["pos"] = jnp.asarray([40, 45], jnp.int32)
    cache["tbl"] = jnp.asarray(ROWS)
    tok = np.concatenate([lg.argmax(-1) for lg in logits]).astype(np.int32)
    for _ in range(STEPS):
        feeds.append(tok)
        lg, cache = dec(params, jnp.asarray(tok[:, None]), cache)
        logits.append(np.asarray(lg, np.float32))
        tok = np.asarray(jnp.argmax(lg, -1), np.int32)
    return params, logits, feeds


def _port_run(dtype, jparams, attn_impl, decode_impl, feeds=None,
              arch=ARCH):
    """The port on the same inputs; greedy on its own tokens unless
    ``feeds`` (teacher forcing) is given.  Returns (logits per call,
    tokens fed at each decode step, cache)."""
    cfg = _dropless(get_reduced(arch).replace(
        dtype=dtype, attn_impl=attn_impl, decode_impl=decode_impl))
    model = model_from_jax(jparams, cfg, device="cpu")
    cache = MD.init_paged_cache(cfg, 2, MAX_SEQ, NB, BLK, device="cpu")
    logits, fed = [], []
    for toks, lens, start, trow, fresh in _inputs():
        lg, cache = MD.prefill(cfg, model, torch.from_numpy(toks), cache,
                               moe_impl="sort", lens=torch.tensor(lens),
                               start=torch.tensor(start),
                               tbl=torch.from_numpy(trow), paged_fresh=fresh)
        logits.append(lg.float().numpy())
    cache["pos"] = torch.tensor([40, 45], dtype=torch.int32)
    cache["tbl"] = torch.from_numpy(ROWS)
    tok = np.concatenate([lg.argmax(-1) for lg in logits]).astype(np.int32)
    for i in range(STEPS):
        if feeds is not None:
            tok = feeds[i]
        fed.append(tok)
        lg, cache = MD.decode_step(cfg, model, torch.tensor(tok[:, None]),
                                   cache, moe_impl="sort")
        logits.append(lg.float().numpy())
        tok = greedy(lg).numpy()
    return logits, fed, cache


@pytest.fixture(scope="module")
def ref32():
    return _jax_run("float32")


@pytest.mark.parametrize("attn_impl,decode_impl",
                         [("einsum", "xla"), ("pallas", "flash_paged")])
def test_float32_logits_and_tokens_match_jax(ref32, attn_impl, decode_impl):
    jparams, jlogits, jfeeds = ref32
    logits, fed, cache = _port_run("float32", jparams, attn_impl, decode_impl)
    for i, (a, b) in enumerate(zip(logits, jlogits)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0,
                                   err_msg=f"call {i}")
    assert [t.tolist() for t in fed] == [t.tolist() for t in jfeeds]
    assert cache["pos"].tolist() == [40 + STEPS, 45 + STEPS]


def test_bfloat16_logits_match_jax():
    jparams, jlogits, jfeeds = _jax_run("bfloat16")
    logits, _, _ = _port_run("bfloat16", jparams, "einsum", "xla",
                             feeds=jfeeds)
    for i, (a, b) in enumerate(zip(logits, jlogits)):
        np.testing.assert_allclose(a, b, atol=5e-2, rtol=0,
                                   err_msg=f"call {i}")


def test_kernel_options_equal_plain_path_bitwise_on_cpu(ref32):
    """On the CPU the kernel options run the plain versions, which keep
    the plain path's exact op order: identical logits, not just close."""
    plain, _, _ = _port_run("float32", ref32[0], "einsum", "xla")
    kern, _, _ = _port_run("float32", ref32[0], "pallas", "flash_paged")
    for a, b in zip(plain, kern):
        assert np.array_equal(a, b)


def test_bridge_maps_every_leaf(ref32):
    jparams = ref32[0]
    state = params_from_jax(jparams)
    model = MD.Model(get_reduced(ARCH).replace(dtype="float32"), "cpu")
    assert set(state) == set(model.state_dict())
    np.testing.assert_array_equal(
        state["blocks.1.attn.wq"].numpy(),
        np.asarray(jparams["g0"]["b0"]["attn"]["wq"][1]))


def test_init_params_scheme_and_device_rule(monkeypatch):
    cfg = get_reduced(ARCH)
    m = MD.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert m.embed.dtype == torch.bfloat16 and len(m.blocks) == 2
    assert torch.all(m.blocks[0].norm1 == 1)
    wq = m.blocks[0].attn["wq"].float()
    assert abs(wq.std().item() * np.sqrt(cfg.d_model) - 1) < 0.1
    assert abs(m.embed.float().std().item() - 0.02) < 0.002
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MD.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MD.init_paged_cache(cfg, 2, MAX_SEQ, NB, BLK)


def test_unported_configs_raise():
    """``decode_impl="shardmap"`` (multi-device) still raises;
    ``attn_impl="blocked"`` (ported with training), cross-attention
    context and the contiguous cache are served."""
    cfg = get_config(ARCH)
    with pytest.raises(NotImplementedError):
        MD.check_supported(cfg.replace(decode_impl="shardmap"))
    MD.check_supported(cfg.replace(attn_impl="blocked"))
    MD.check_supported(cfg.replace(cross_ctx_len=4))
    small = get_reduced(ARCH).replace(dtype="float32")
    model = MD.init_params(small, torch.Generator().manual_seed(0), "cpu")
    logits, cache = MD.prefill(small, model,
                               torch.zeros((1, 4), dtype=torch.int32),
                               MD.init_cache(small, 1, MAX_SEQ, "cpu"))
    assert logits.shape == (1, small.vocab_size) and int(cache["pos"]) == 4


# ---------------------------------------------------------------------------
# reduced deepseek-v2: MLA + MoE (1 dense + 2 MoE layers, 8 experts top-2)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mla32():
    return _jax_run("float32", MLA_ARCH)


@pytest.mark.parametrize("decode_impl", ["xla", "flash_paged"])
def test_mla_float32_logits_and_tokens_match_jax(mla32, decode_impl):
    """Fresh prefill, a suffix prefill over the gathered view (expanded
    form) and 8 absorbed decode steps: logits within 1e-4, greedy tokens
    identical."""
    jparams, jlogits, jfeeds = mla32
    logits, fed, cache = _port_run("float32", jparams, "einsum", decode_impl,
                                   arch=MLA_ARCH)
    for i, (a, b) in enumerate(zip(logits, jlogits)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0,
                                   err_msg=f"call {i}")
    assert [t.tolist() for t in fed] == [t.tolist() for t in jfeeds]
    assert cache["pos"].tolist() == [40 + STEPS, 45 + STEPS]


def test_mla_kernel_option_equals_plain_path_bitwise_on_cpu(mla32):
    plain, _, _ = _port_run("float32", mla32[0], "einsum", "xla",
                            arch=MLA_ARCH)
    kern, _, _ = _port_run("float32", mla32[0], "einsum", "flash_paged",
                           arch=MLA_ARCH)
    for a, b in zip(plain, kern):
        assert np.array_equal(a, b)


def test_mla_bridge_maps_every_leaf(mla32):
    """Layer 0 (MLA + dense FFN) and the MoE layers map leaf for leaf; the
    router stays float32 in a bf16 model."""
    jparams = mla32[0]
    state = params_from_jax(jparams)
    model = MD.Model(get_reduced(MLA_ARCH), "cpu")
    assert set(state) == set(model.state_dict())
    assert "blocks.0.ffn.w_gate" in state and "blocks.0.moe.router" not in state
    np.testing.assert_array_equal(
        state["blocks.2.moe.shared.w_up"].numpy(),
        np.asarray(jparams["g1"]["b0"]["moe"]["shared"]["w_up"][1]))
    np.testing.assert_array_equal(
        state["blocks.1.mla.wk_b"].numpy(),
        np.asarray(jparams["g1"]["b0"]["mla"]["wk_b"][0]))
    assert model.blocks[1].moe["router"].dtype == torch.float32
    assert model.blocks[1].moe["w_gate"].dtype == torch.bfloat16
    model.load_state_dict(state)
    assert model.blocks[2].moe["router"].dtype == torch.float32


def test_mla_init_params_scheme_and_cache_leaves():
    cfg = get_reduced(MLA_ARCH)
    m = MD.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert len(m.blocks) == 3 and m.blocks[0].spec.ffn == "dense"
    assert m.blocks[1].moe["router"].dtype == torch.float32
    assert abs(m.blocks[1].moe["router"].std().item() - 0.02) < 0.005
    assert torch.all(m.blocks[0].mla["kv_norm"] == 1)
    wk_b = m.blocks[0].mla["wk_b"].float()            # fan_in = kv_lora_rank
    assert abs(wk_b.std().item() * np.sqrt(cfg.kv_lora_rank) - 1) < 0.1
    wg = m.blocks[1].moe["w_gate"].float()             # fan_in = d_model
    assert abs(wg.std().item() * np.sqrt(cfg.d_model) - 1) < 0.1
    cache = MD.init_paged_cache(cfg, 2, MAX_SEQ, NB, BLK, device="cpu")
    assert cache["g0"]["b0"]["ckv"].shape == (1, NB, BLK, cfg.kv_lora_rank)
    assert cache["g1"]["b0"]["krope"].shape == (2, NB, BLK, cfg.rope_head_dim)


def test_mla_unported_options_raise():
    cfg = get_reduced(MLA_ARCH).replace(dtype="float32")
    model = MD.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cache = MD.init_paged_cache(cfg, 1, MAX_SEQ, NB, BLK, device="cpu")
    toks = torch.full((1, 4), 5, dtype=torch.int32)
    tbl = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    # the default moe_impl "gshard" is ported now (with training)
    logits, _ = MD.prefill(cfg, model, toks, cache, tbl=tbl,
                           paged_fresh=True)
    assert logits.shape == (1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    from repro_torch.models.config import BlockSpec, LayerGroup
    mamba = cfg.replace(groups=(LayerGroup((BlockSpec("mamba", "moe"),), 1),))
    MD.check_supported(mamba)           # SSM mixers are served ...
    assert not MD.paged_supported(mamba)
    with pytest.raises(ValueError, match="mamba"):   # ... contiguous only
        MD.init_paged_cache(mamba, 1, MAX_SEQ, NB, BLK, device="cpu")
