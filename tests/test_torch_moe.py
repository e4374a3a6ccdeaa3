"""The port's MoE FFN against ``repro.models.moe`` (CPU, reduced deepseek-v2:
d 64, 8 experts top-2, 2 shared experts of width 32).

Inputs are drawn with numpy from fixed seeds and handed to both packages.
The capacity factor is the fleet's dropless one, E/k.  Tolerances: float32
1e-5 (summation order only); bfloat16 2e-2 absolute + relative (a few
bf16 ulps of the O(1) outputs).  Expert choices must be identical: the
router scale is large enough that no two of a token's probabilities are
within float32 rounding of each other.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import moe as JM
from repro_torch.configs import get_reduced
from repro_torch.models import moe as TM

ARCH = "deepseek-v2-236b"
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _cfgs(cf=None):
    """Both packages' reduced configs at capacity factor ``cf`` (default:
    the fleet's dropless E/k)."""
    cj, ct = j_get_reduced(ARCH), get_reduced(ARCH)
    cf = cf or ct.n_experts / ct.moe_top_k
    return (cj.replace(moe_capacity_factor=cf),
            ct.replace(moe_capacity_factor=cf))


def _pair(a, dt):
    jd, td, _ = DTYPES[dt]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a, np.float32)).to(td)


def _params(seed, dt, cfg):
    r = np.random.default_rng(seed)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    fs = cfg.n_shared_experts * f
    raw = {"w_gate": r.standard_normal((E, d, f)) / 8,
           "w_up": r.standard_normal((E, d, f)) / 8,
           "w_down": r.standard_normal((E, f, d)) / 6,
           "shared": {"w_gate": r.standard_normal((d, fs)) / 8,
                      "w_up": r.standard_normal((d, fs)) / 8,
                      "w_down": r.standard_normal((fs, d)) / 8}}
    router = r.standard_normal((d, E)) / 2
    jp = {k: _pair(v, dt)[0] for k, v in raw.items() if k != "shared"}
    tp = {k: _pair(v, dt)[1] for k, v in raw.items() if k != "shared"}
    jp["shared"] = {k: _pair(v, dt)[0] for k, v in raw["shared"].items()}
    tp["shared"] = {k: _pair(v, dt)[1] for k, v in raw["shared"].items()}
    jp["router"] = jnp.asarray(router, jnp.float32)       # float32 always
    tp["router"] = torch.from_numpy(np.asarray(router, np.float32))
    x = r.standard_normal((2, 7, d))
    return jp, tp, x


def _close(j, t, dt):
    tol = DTYPES[dt][2]
    np.testing.assert_allclose(np.asarray(t.float()),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_route_matches_jax(dt):
    cj, ct = _cfgs()
    jp, tp, x = _params(0, dt, ct)
    jx, tx = _pair(x.reshape(-1, ct.d_model), dt)
    j_idx, j_prob, _ = JM._route(jp, cj, jx)
    t_idx, t_prob = TM._route(tp, ct, tx)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_prob.numpy(), np.asarray(j_prob),
                               atol=1e-6, rtol=1e-6)
    assert t_prob.dtype == torch.float32


@pytest.mark.parametrize("dt", list(DTYPES))
def test_shared_expert_matches_jax(dt):
    cj, ct = _cfgs()
    jp, tp, x = _params(1, dt, ct)
    jx, tx = _pair(x, dt)
    _close(JM._shared_expert(jp, jx), TM._shared_expert(tp, tx), dt)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("S,cf", [(1, None), (7, None), (7, 0.5)])
def test_moe_sort_local_matches_jax(dt, S, cf):
    """Decode-like (1 token per row) and prefill-like (7) batches, dropless
    and at capacity factor 0.5 (capacity 4 for 28 routed slots: the
    busiest expert drops a token, as in the reference); every moe_impl
    the port serves runs this path."""
    cj, ct = _cfgs(cf)
    jp, tp, x = _params(2 + S, dt, ct)
    jx, tx = _pair(x[:, :S], dt)
    if cf is not None:
        idx, _ = TM._route(tp, ct, tx.reshape(-1, ct.d_model))
        cap = TM._capacity(idx.shape[0], ct.moe_top_k, ct.n_experts, cf)
        assert int(torch.bincount(idx.reshape(-1)).max()) > cap
    ref, _ = JM.moe_sort_local(jp, cj, jx)
    for impl in TM.SORT_IMPLS:
        _close(ref, TM.moe_apply(tp, ct, tx, impl), dt)


def test_dropless_output_is_the_routed_sum():
    """At capacity factor E/k nothing is dropped: each token's output is
    the sum of its k experts' SwiGLU outputs weighted by the renormalised
    router probabilities, plus the shared experts (float32)."""
    cj, ct = _cfgs()
    _, tp, x = _params(4, "float32", ct)
    tx = torch.from_numpy(np.asarray(x, np.float32))
    out = TM.moe_sort_local(tp, ct, tx).reshape(-1, ct.d_model)
    xf = tx.reshape(-1, ct.d_model)
    idx, prob = TM._route(tp, ct, xf)
    want = TM._shared_expert(tp, tx).reshape(-1, ct.d_model).clone()
    for n in range(xf.shape[0]):
        for e, w in zip(idx[n].tolist(), prob[n].tolist()):
            h = torch.nn.functional.silu(xf[n] @ tp["w_gate"][e]) * \
                (xf[n] @ tp["w_up"][e])
            want[n] += w * (h @ tp["w_down"][e])
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("n,k,E,cf", [(16, 2, 8, 4.0), (479, 6, 160, 160 / 6),
                                      (8, 6, 160, 160 / 6), (1, 2, 8, 1.25),
                                      (333, 6, 160, 160 / 6)])
def test_capacity_rounds_like_reference(n, k, E, cf):
    assert TM._capacity(n, k, E, cf) == JM._capacity(n, k, E, cf)


def test_combine_is_deterministic_bitwise():
    """Repeated calls give bitwise-identical outputs (the combine adds each
    token's k expert rows in a fixed order, never by atomics)."""
    _, ct = _cfgs()
    _, tp, x = _params(5, "bfloat16", ct)
    tx = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    first = TM.moe_sort_local(tp, ct, tx)
    for _ in range(3):
        assert torch.equal(TM.moe_sort_local(tp, ct, tx), first)


def test_unported_impls_raise():
    _, ct = _cfgs()
    _, tp, x = _params(6, "float32", ct)
    tx = torch.from_numpy(np.asarray(x, np.float32))
    with pytest.raises(NotImplementedError, match="gshard"):
        TM.moe_apply(tp, ct, tx, "gshard")
    with pytest.raises(ValueError, match="unknown moe impl"):
        TM.moe_apply(tp, ct, tx, "bogus")
