"""Engine lint plane of the port (``repro_torch.analysis.op_lint``), case
for case with the reference's ``tests/test_analysis_lint.py``: the lint
passes themselves (positive and negative), then applied to the real hot
paths — the decision gate, the paged decode / verify kernels' wrappers
(GQA and MLA) and the reduced models' decode steps — then the recompile
guard, which watches the one place the port compiles: the kernel build
(``kernels._build``: ``nvcc`` and the library load, stubbed here so it
runs without ``nvcc``).

A kernel wrapper's call is one opaque region (``kernels.observed``): on
the CPU its plain version gathers the ``(B, max_blocks * block_tokens)``
view, but that is the kernel's own business, as a ``pallas_call`` is one
primitive of a jaxpr.  The ``xla`` decode path builds the same view in
the model (``models.model._paged_view``) and is flagged for it.
"""

import sys

import numpy as np
import pytest
import torch

from repro_torch.analysis import (RecompileGuard, build_counters,
                                  jit_cache_size, lint_fn)
from repro_torch.analysis.op_lint import OpLint, _to_host
from repro_torch.configs import get_reduced
from repro_torch.core.decision import and_, build_decision_gate, leaf, not_
from repro_torch.core.types import Decision, ModelRef
from repro_torch.kernels import _build
from repro_torch.models import model as MD
from repro_torch.roofline import steps as ST

L = lambda i: leaf("keyword", f"s{i}")          # noqa: E731


def _gate_and_batch(B=4):
    ds = [Decision("a", and_(L(0), L(1)), [ModelRef("m1")], priority=9),
          Decision("b", not_(L(0)), [ModelRef("m2")], priority=5),
          Decision("c", L(2), [ModelRef("m3")], priority=5)]
    gate, keys = build_decision_gate(ds, device="cpu")
    N = len(keys)
    rng = np.random.default_rng(0)
    match = torch.from_numpy((rng.random((B, N)) > 0.5).astype(np.float32))
    conf = torch.from_numpy(rng.random((B, N)).astype(np.float32))
    return gate, match, conf


# ---------------------------------------------------------------------------
# the lint passes themselves (positive + negative)
# ---------------------------------------------------------------------------

def test_lint_sees_nested_calls_and_the_backward():
    """What the reference's jaxpr walk finds inside cond branches and
    nested jaxprs, the dispatch mode sees as the ops run: a helper's ops
    and an autograd backward's."""
    def inner(v):
        return v.exp()

    def f(x):
        y = inner(x) * 2.0
        y.sum().backward()
        return x.grad

    with OpLint() as lint:
        f(torch.ones(3, requires_grad=True))
    assert lint.findings == []
    seen = []

    class Seen(OpLint):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func.overloadpacket))
            return super().__torch_dispatch__(func, types, args, kwargs)
    with Seen():
        f(torch.ones(3, requires_grad=True))
    assert {"aten.exp", "aten.mul"} <= set(seen)


def test_lint_flags_host_sync():
    def noisy(x):
        _ = x.sum().item()                       # .item(): a host sync
        return x * 2

    findings = lint_fn(noisy, torch.ones(4))
    assert [f.op for f in findings] == ["aten._local_scalar_dense"]
    assert all(f.rule == "host-sync" for f in findings)
    data_sized = lint_fn(lambda x: (x.nonzero(), x[x > 0], bool(x.any())),
                         torch.ones(4))
    assert {f.op for f in data_sized} >= {"aten.nonzero",
                                          "aten._local_scalar_dense"}
    assert lint_fn(lambda x: x * 2, torch.ones(4)) == []
    assert lint_fn(noisy, torch.ones(4), forbid_host_syncs=False) == []
    # a copy to the host from a device (here: the meta device)
    m = torch.empty(3, device="meta")
    assert _to_host("aten._to_copy", (m,), {}, torch.empty(3))
    assert not _to_host("aten._to_copy", (torch.empty(3),), {},
                        torch.empty(3))
    assert _to_host("aten.copy_", (torch.empty(3), m), {}, None)


def test_lint_flags_materialized_intermediate():
    def blowup(x):                       # (8,) -> (8, 8, 8) intermediate
        y = x[:, None, None] * x[None, :, None] * x[None, None, :]
        return y.sum()

    findings = lint_fn(blowup, torch.ones(8), max_intermediate_elems=64)
    assert any(f.rule == "materialized-intermediate" and f.shape == (8, 8, 8)
               for f in findings)
    assert lint_fn(blowup, torch.ones(8),
                   max_intermediate_elems=1024) == []


def test_lint_flags_banned_leading_shape():
    def gathered(tbl, pool):             # (B, S, d): the paged anti-pattern
        return pool[tbl].sum(dim=1)

    B, S, d = 3, 64, 8
    tbl = torch.zeros((B, S), dtype=torch.long)
    pool = torch.zeros((100, d))
    findings = lint_fn(gathered, tbl, pool, banned_leading_shapes=[(B, S)])
    assert any(f.rule == "banned-shape" for f in findings)


# ---------------------------------------------------------------------------
# applied to the real hot paths
# ---------------------------------------------------------------------------

def test_decision_gate_is_lint_clean():
    gate, match, conf = _gate_and_batch()
    findings = lint_fn(gate, match, conf, max_intermediate_elems=1 << 16)
    assert findings == [], [str(f) for f in findings]


def test_decide_batch_has_one_documented_host_transfer():
    """``RouterProgram.decide_batch`` brings the gate's four outputs to
    the host as one block: on the CPU that copy is a no-op, so the lint
    of the whole call is clean (the card's test counts exactly one
    host-sync there: ``tests/test_torch_cuda.py``)."""
    from repro_torch.core.program import compile_router_program
    with open("examples/policies/cost.vsr") as f:
        prog = compile_router_program(f.read(), device="cpu")
    N = len(prog.keys)
    rng = np.random.default_rng(1)
    match = (rng.random((4, N)) > 0.5).astype(np.float32)
    conf = rng.random((4, N)).astype(np.float32)
    assert lint_fn(prog.decide_batch, match, conf) == []


def _paged(B=3, nb=10, max_blocks=4, blk=16, Hq=8, Hkv=2, hd=64, W=None):
    q = torch.zeros((B,) + ((W,) if W else ()) + (Hq, hd))
    kpool = torch.zeros((nb, blk, Hkv, hd))
    tbl = torch.zeros((B, max_blocks), dtype=torch.int32)
    kv_len = torch.full((B,), 8 if W else 0, dtype=torch.int32)
    return q, kpool, tbl, kv_len


def test_paged_flash_decode_kernels_are_lint_clean():
    from repro_torch.kernels.flash_decode.ops import (paged_flash_decode,
                                                      paged_flash_decode_mla)
    B, S = 3, 64
    q, kpool, tbl, kv_len = _paged()
    findings = lint_fn(paged_flash_decode, q, kpool, kpool.clone(), tbl,
                       kv_len, banned_leading_shapes=[(B, S), (B * 2, S)])
    assert findings == [], [str(f) for f in findings]
    ql, qr = torch.zeros((B, 8, 64)), torch.zeros((B, 8, 32))
    ckv, kr = torch.zeros((10, 16, 64)), torch.zeros((10, 16, 32))
    findings = lint_fn(paged_flash_decode_mla, ql, qr, ckv, kr, tbl, kv_len,
                       banned_leading_shapes=[(B, S), (B * 2, S)],
                       scale=1.0 / np.sqrt(96.0))
    assert findings == [], [str(f) for f in findings]


def test_paged_flash_verify_kernels_are_lint_clean():
    """The speculative-verify kernels inherit the decode kernels'
    contract: no gathered (B, max_blocks*block_tokens, ...) KV copy and
    no host sync — W rides the q tile, not extra KV traffic."""
    from repro_torch.kernels.flash_decode.ops import (paged_flash_verify,
                                                      paged_flash_verify_mla)
    B, S, W = 3, 64, 5
    q, kpool, tbl, kv_len = _paged(W=W)
    findings = lint_fn(paged_flash_verify, q, kpool, kpool.clone(), tbl,
                       kv_len, banned_leading_shapes=[(B, S), (B * 2, S)])
    assert findings == [], [str(f) for f in findings]
    ql, qr = torch.zeros((B, W, 8, 64)), torch.zeros((B, W, 8, 32))
    ckv, kr = torch.zeros((10, 16, 64)), torch.zeros((10, 16, 32))
    findings = lint_fn(paged_flash_verify_mla, ql, qr, ckv, kr, tbl, kv_len,
                       banned_leading_shapes=[(B, S), (B * 2, S)],
                       scale=1.0 / np.sqrt(96.0))
    assert findings == [], [str(f) for f in findings]


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-236b"])
def test_model_decode_step_never_materializes_gathered_kv(arch):
    """The reduced member's whole decode step (4 slots, max_seq 112 — no
    width of the reduced configs — the fleet's paged cache): under
    ``flash_paged`` no (B, S) or (2B, S) shape and no host sync outside
    the kernel regions; the ``xla`` path is flagged for ``_paged_view``'s
    gather."""
    B, S = 4, 112
    for impl in ("flash_paged", "xla"):
        cfg = get_reduced(arch).replace(dtype="float32", decode_impl=impl)
        gen = torch.Generator().manual_seed(0)
        params = MD.init_params(cfg, gen, "cpu")
        cache = ST.paged_cache(cfg, B, S, 16, "cpu")
        ST.fill(cfg, params, cache, [5, 17, 33, 9], gen)
        step = ST.decode(cfg, params, cache,
                         torch.zeros((B, 1), dtype=torch.int32))
        findings = lint_fn(step.run, banned_leading_shapes=[(B, S),
                                                            (2 * B, S)])
        if impl == "flash_paged":
            assert findings == [], [str(f) for f in findings]
        else:
            assert findings and all(f.rule == "banned-shape"
                                    for f in findings)
            assert "aten.index" in {f.op for f in findings}


# ---------------------------------------------------------------------------
# recompile accounting: a warmed path never builds or loads a kernel
# ---------------------------------------------------------------------------

@pytest.fixture
def stub_build(tmp_path, monkeypatch):
    """``kernels._build`` with a fake ``nvcc`` (writes its ``-o`` file)
    and a stub loader, over an empty build directory."""
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys\n"
                    "a = sys.argv\nopen(a[a.index('-o') + 1], 'w').close()\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(_build, "_libs", {})
    return _build


def test_jit_cache_size_probe(stub_build):
    probes = build_counters()
    assert set(probes) == {"kernels.builds", "kernels.loads"}
    start = {k: jit_cache_size(p) for k, p in probes.items()}
    stub_build.load("paged_decode")
    assert jit_cache_size(probes["kernels.builds"]) == \
        start["kernels.builds"] + 1
    assert jit_cache_size(probes["kernels.loads"]) == \
        start["kernels.loads"] + 1
    stub_build.load("paged_decode")              # loaded: no new entry
    assert jit_cache_size(probes["kernels.loads"]) == \
        start["kernels.loads"] + 1
    assert jit_cache_size(lambda x: x) == -1     # plain fn: no cache


def test_recompile_guard_detects_miss(stub_build):
    stub_build.load("flash_attention")
    guard = RecompileGuard(build_counters())
    stub_build.load("flash_attention")          # warmed: nothing new
    guard.assert_no_recompiles()
    stub_build.load("multi_lora")               # a cold kernel: a miss
    assert guard.misses() == {"kernels.builds": 1, "kernels.loads": 1}
    with pytest.raises(AssertionError, match="unexpected recompiles"):
        guard.assert_no_recompiles()


def test_decision_gate_no_recompile_across_warm_buckets(stub_build):
    gate, match, conf = _gate_and_batch(B=4)
    _, match8, conf8 = _gate_and_batch(B=8)
    want = (gate(match, conf), gate(match8, conf8))
    guard = RecompileGuard(build_counters())
    for _ in range(3):                   # replay: zero builds, same gates
        got = (gate(match, conf), gate(match8, conf8))
        for a, b in zip(want, got):
            for x, y in zip(a, b):
                assert torch.equal(x, y)
    guard.assert_no_recompiles()
    assert jit_cache_size(gate) == -1


def test_verify_kernels_no_recompile_across_warm_width_buckets(stub_build):
    """Replayed verify widths (the adaptive scheduler only issues W in
    {1, k+1}) never build or load a kernel once warmed."""
    from repro_torch.kernels.flash_decode.ops import (paged_flash_verify,
                                                      paged_flash_verify_mla)
    B = 2
    kpool = torch.zeros((6, 16, 2, 64))
    ckv, kr = torch.zeros((6, 16, 64)), torch.zeros((6, 16, 32))
    tbl = torch.zeros((B, 2), dtype=torch.int32)
    kv_len = torch.full((B,), 8, dtype=torch.int32)

    def both(W):
        paged_flash_verify(torch.zeros((B, W, 8, 64)), kpool, kpool, tbl,
                           kv_len)
        paged_flash_verify_mla(torch.zeros((B, W, 8, 64)),
                               torch.zeros((B, W, 8, 32)), ckv, kr, tbl,
                               kv_len, scale=0.1)
    for W in (1, 5):                     # warm both width buckets
        both(W)
    guard = RecompileGuard(build_counters())
    for _ in range(3):
        for W in (1, 5):
            both(W)
    guard.assert_no_recompiles()


def test_mlp_select_many_no_recompile_per_batch(stub_build):
    """The ``mlp`` selector trains its SGD loop once per batch in torch
    autograd (no compile): repeated batches take no kernel build and give
    the same picks."""
    from repro_torch.classifiers.backend import HashBackend
    from repro_torch.core.selection import SelectionContext, select_many
    from repro_torch.core.selection.algorithms import RoutingRecord, \
        _mlp_many
    from repro_torch.core.types import ModelProfile

    be = HashBackend()
    ctx = SelectionContext(profiles={
        "cheap": ModelProfile("cheap", quality=0.4),
        "big": ModelProfile("big", quality=0.9)}, device="cpu")
    for i, e in enumerate(be.embed([f"solve equation {i} algebra"
                                    for i in range(8)])):
        ctx.add_record(RoutingRecord(e, 0, "big", 0.9))
        ctx.add_record(RoutingRecord(e, 0, "cheap", 0.2))
    E_q = np.asarray(be.embed(["solve equation 99", "debug function 99"]))
    zs = [0, 1]
    cfg = {"steps": 4}

    want = select_many("mlp", E_q, zs, ["cheap", "big"], ctx, cfg)   # warm
    assert jit_cache_size(_mlp_many) == -1
    guard = RecompileGuard(build_counters())
    for _ in range(3):                   # identical record shapes
        assert select_many("mlp", E_q, zs, ["cheap", "big"], ctx,
                           cfg) == want
    guard.assert_no_recompiles()
