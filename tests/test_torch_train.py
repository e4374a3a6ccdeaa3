"""The port's training forward against the JAX package's: ``loss_fn`` and
its gradients (reduced, float32, the reference's ``init_params`` weights
bridged over) for the dense and cross-attention archs here — the MoE archs
in ``test_torch_train_moe.py`` and the SSM archs in
``test_torch_train_ssm.py`` (under "gshard" and "sort"), so that each file
stays short on one core — then the bf16 twin of
``test_arch_smoke::test_train_grad_finite``, remat on == off bitwise,
``attn_impl="blocked"`` (``layers.sdpa_blocked``) against the reference,
and ``attn_impl="pallas"`` refusing gradients.

Tolerances: loss, ce, moe_lb and moe_z within rel 1e-5 (both sides
compute in float32 and differ in summation order only); each gradient
leaf, mapped through ``bridge.params_to_jax``, within 1e-4 of that leaf's
max |g| under ``jax.grad``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.configs import list_archs as j_list_archs
from repro.models import layers as JL
from repro.models import model as JMD
from repro_torch.bridge import model_from_jax, params_to_jax
from repro_torch.configs import get_reduced, list_archs
from repro_torch.models import layers as L
from repro_torch.models import model as MD
from repro_torch.training.train_lib import trainable, value_and_grad

B, S = 2, 8
MOE_ARCHS = ("deepseek-v2-236b", "qwen3-moe-235b-a22b")
SSM_ARCHS = ("jamba-v0.1-52b", "xlstm-350m")


def cases(archs):
    """(arch, moe_impl) pairs: MoE archs under "gshard" and "sort"."""
    return [(a, impl) for a in archs
            for impl in (("gshard", "sort") if get_reduced(a).n_experts
                         else ("gshard",))]


DENSE = cases(a for a in list_archs() if a not in MOE_ARCHS + SSM_ARCHS)


def _inputs(cfg, seed=0):
    """Tokens, labels with masked (-100) entries, and the cross context
    of an encoder-decoder / vision config (numpy, from ``seed``)."""
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :3] = -100
    cross = None
    if cfg.cross_ctx_len:
        cross = r.standard_normal(
            (B, cfg.cross_ctx_len, cfg.d_model)).astype(np.float32)
    return toks, labels, cross


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def test_registry_lists_every_reference_arch():
    assert list_archs() == j_list_archs()
    assert set(MOE_ARCHS + SSM_ARCHS) <= set(list_archs())


def check_loss_and_grads(arch, impl):
    """``loss_fn`` and every gradient leaf of the port against the
    reference's for ``arch`` under ``moe_impl=impl``."""
    cj = j_get_reduced(arch).replace(dtype="float32")
    ct = get_reduced(arch).replace(dtype="float32")
    params = JMD.init_params(cj, jax.random.PRNGKey(0))
    toks, labels, cross = _inputs(cj)

    def lf(p):
        return JMD.loss_fn(cj, p, jnp.asarray(toks), jnp.asarray(labels),
                           _j(cross), moe_impl=impl, remat=True)

    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(lf, has_aux=True))(
        params)
    model = model_from_jax(params, ct, "cpu")
    loss, met, grads = value_and_grad(ct, model, _t(toks), _t(labels),
                                      _t(cross), moe_impl=impl)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in ("ce", "moe_lb", "moe_z"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5,
                                   atol=0 if float(jmet[k]) else 1e-12)
    if ct.n_experts:
        assert float(met["moe_lb"]) > 0 and float(met["moe_z"]) > 0
    tg = params_to_jax(grads, ct)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    tflat = jax.tree_util.tree_leaves(tg)
    assert len(jflat) == len(tflat)
    assert jax.tree_util.tree_structure(tg) == \
        jax.tree_util.tree_structure(jax.tree.map(np.asarray, jgrads))
    for (path, jg), g in zip(jflat, tflat):
        jg = np.asarray(jg, np.float32)
        assert g.shape == jg.shape, path
        scale = max(float(np.abs(jg).max()), 1e-30)
        err = float(np.abs(g - jg).max())
        assert err <= 1e-4 * scale, (jax.tree_util.keystr(path), err, scale)


@pytest.mark.parametrize("arch,impl", DENSE,
                         ids=[f"{a}-{i}" for a, i in DENSE])
def test_loss_and_grads_match_jax(arch, impl):
    check_loss_and_grads(arch, impl)


@pytest.mark.parametrize("arch", list_archs())
def test_train_grad_finite(arch):
    """Twin of ``test_arch_smoke::test_train_grad_finite``: bf16 reduced
    configs, seeded torch weights, tokens as their own labels."""
    cfg = get_reduced(arch)
    gen = torch.Generator().manual_seed(0)
    model = MD.init_params(cfg, gen, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    cross = None
    if cfg.cross_ctx_len:
        cross = torch.randn((B, cfg.cross_ctx_len, cfg.d_model),
                            generator=gen).to(torch.bfloat16)
    loss, _, grads = value_and_grad(cfg, model, toks, toks, cross)
    assert bool(torch.isfinite(loss))
    assert np.log(cfg.vocab_size) * 0.3 < float(loss) < \
        np.log(cfg.vocab_size) * 3
    for name, g in grads.items():
        assert bool(torch.isfinite(g.float()).all()), name
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "whisper-tiny",
                                  "deepseek-v2-236b"])
def test_remat_matches_no_remat_bitwise(arch):
    """Recomputing each period's activations in the backward pass (the
    encoder's too) changes nothing: loss, metrics and every gradient are
    bitwise those of the stored-activation run."""
    cfg = get_reduced(arch).replace(dtype="float32")
    model = MD.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    toks, labels, cross = _inputs(cfg, seed=1)
    a = value_and_grad(cfg, model, _t(toks), _t(labels), _t(cross),
                       remat=True)
    b = value_and_grad(cfg, model, _t(toks), _t(labels), _t(cross),
                       remat=False)
    assert torch.equal(a[0], b[0])
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k]), k
    for name in a[2]:
        assert torch.equal(a[2][name], b[2][name]), name


SDPA_CASES = [
    # Skv, block, causal, window, q_offset, kv_len
    (64, 16, True, 0, 0, None),
    (64, 16, False, 0, 0, None),
    (64, 32, True, 24, 0, None),
    (48, 16, True, 0, 16, 40),
    (40, 16, True, 0, 0, None),       # 40 % 16 != 0: plain sdpa
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SDPA_CASES,
                         ids=[f"blk{i}" for i in range(len(SDPA_CASES))])
def test_sdpa_blocked_matches_jax(case, dtype):
    Skv, block, causal, window, q_offset, kv_len = case
    Sq = Skv - q_offset
    r = np.random.default_rng(7)
    q = r.standard_normal((2, Sq, 6, 16)).astype(np.float32)
    k = r.standard_normal((2, Skv, 2, 16)).astype(np.float32)
    v = r.standard_normal((2, Skv, 2, 16)).astype(np.float32)
    jd = jnp.dtype(dtype)
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    ref = JL.sdpa_blocked(*(jnp.asarray(x, jd) for x in (q, k, v)),
                          causal=causal, sliding_window=window,
                          q_offset=q_offset, kv_len=kv_len, block=block)
    out = L.sdpa_blocked(*(torch.from_numpy(x).to(td) for x in (q, k, v)),
                         causal=causal, sliding_window=window,
                         q_offset=q_offset, kv_len=kv_len, block=block)
    assert out.dtype == td and out.shape == ref.shape
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


def test_blocked_attention_loss_and_grads_match_jax():
    """``attn_impl="blocked"`` through the model (KV blocks of 4 over 8
    positions) against the reference's, and against the einsum path."""
    arch = "llama3.2-1b"
    cj = j_get_reduced(arch).replace(dtype="float32", attn_impl="blocked",
                                     attn_block=4)
    ct = get_reduced(arch).replace(dtype="float32", attn_impl="blocked",
                                   attn_block=4)
    params = JMD.init_params(cj, jax.random.PRNGKey(2))
    toks, labels, _ = _inputs(cj, seed=2)

    def lf(p):
        return JMD.loss_fn(cj, p, jnp.asarray(toks), jnp.asarray(labels))[0]

    jloss, jgrads = jax.value_and_grad(lf)(params)
    model = model_from_jax(params, ct, "cpu")
    loss, _, grads = value_and_grad(ct, model, _t(toks), _t(labels))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for jg, g in zip(jax.tree_util.tree_leaves(jgrads),
                     jax.tree_util.tree_leaves(params_to_jax(grads, ct))):
        jg = np.asarray(jg)
        assert np.abs(g - jg).max() <= 1e-4 * np.abs(jg).max()
    plain = value_and_grad(ct.replace(attn_impl="einsum"), model,
                           _t(toks), _t(labels))[0]
    np.testing.assert_allclose(float(loss), float(plain), rtol=1e-5)


def test_pallas_attention_refuses_gradients():
    """Under ``attn_impl="pallas"`` the forward reaches the flash kernel's
    wrapper, which has no gradient: asking for one raises, as
    ``jax.grad`` through the reference's kernel does; the same forward
    without gradients runs."""
    cfg = get_reduced("smollm-360m").replace(dtype="float32",
                                             attn_impl="pallas")
    model = MD.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, S))
    with pytest.raises(NotImplementedError, match="no gradient"):
        value_and_grad(cfg, model, toks, toks)
    assert not any(p.requires_grad for p in model.parameters())
    with trainable(model), torch.no_grad():
        logits, _ = MD.forward(cfg, model, toks)
    assert logits.shape == (B, S, cfg.vocab_size)
    with torch.no_grad():
        einsum = MD.forward(cfg.replace(attn_impl="einsum"), model, toks)[0]
    torch.testing.assert_close(logits, einsum, atol=1e-5, rtol=1e-5)



@pytest.mark.parametrize("i", range(7))
def test_kernel_wrappers_refuse_autograd_on_cpu(i):
    """Every kernel wrapper refuses inputs that require grad under
    autograd on the CPU too (where it would run its plain version), as
    ``tests/test_torch_cuda.py::test_wrappers_refuse_autograd`` holds on
    the card; under ``torch.no_grad`` it returns its plain version's
    result."""
    from test_torch_cuda import grad_cases
    name, fn, plain, args, kw = grad_cases("cpu")[i]
    with pytest.raises(NotImplementedError, match=name):
        fn(*args, **kw)
    with torch.no_grad():
        torch.testing.assert_close(fn(*args, **kw), plain(*args, **kw),
                                   rtol=0, atol=0)
