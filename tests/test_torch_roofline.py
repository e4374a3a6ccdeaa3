"""The port's roofline plane: H100 terms, the dispatch-level cost model,
the kernels' cost functions, collective accounting, and the report /
reanalyze round trip.

* ``Roofline`` at the H100's data-sheet constants: the reference's
  ``test_roofline_terms`` redone, plus the by-dtype compute term.
* ``CostMode`` counts the same FLOPs and bytes for the same step on the
  CPU and on the meta device: reduced smollm-360m and deepseek-v2 (float32),
  the fleet's fresh paged prefill (smollm's under ``attn_impl="pallas"``:
  kernel 1's region), its ``flash_paged`` decode (kernels 2 / 4; their cost reads
  the live keys, which the meta trace carries as host values) and
  ``make_step_fn``'s train step.
* Each kernel's cost function reproduces the bound column of the kernel
  table in ``PERF.md`` at the row's shapes (the bounds ``chip_smoke.py``
  printed), and a kernel region is one opaque op: its cost is noted, its
  plain version's ops are not counted.
* ``SpecMesh``'s collectives on a 2 x 2 mesh against a hand count.
* ``dryrun.run_cell`` -> ``reanalyze`` -> ``report``.
"""

import json
import os

import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_cost)
from repro_torch.kernels.flash_decode.ops import (flash_decode_cost,
                                                  paged_attn_cost,
                                                  paged_flash_decode,
                                                  paged_mla_cost)
from repro_torch.kernels.multi_lora.ops import multi_lora, multi_lora_cost
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import SpecMesh
from repro_torch.models import model as MD
from repro_torch.roofline import analysis as A
from repro_torch.roofline import reanalyze, report
from repro_torch.roofline import steps as ST
from repro_torch.roofline.collectives import Recorder
from repro_torch.roofline.op_cost import CostMode

BF16 = torch.bfloat16


def test_roofline_terms_at_h100_constants():
    r = A.Roofline("a", "s", "16x16", 256, flops_per_device=989e12,
                   bytes_per_device=3.35e12, collective_bytes_per_device=450e9,
                   collective_breakdown={}, model_flops_total=989e12 * 256,
                   peak_memory_per_device=0)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(1.0)
    assert r.t_collective == pytest.approx(1.0)
    assert r.useful_flops_ratio == pytest.approx(1.0)
    assert r.roofline_fraction == pytest.approx(1.0)
    r2 = A.Roofline("a", "s", "16x16", 256, 1e12, 4e12, 1e9, {}, 1e12 * 256,
                    0)
    assert r2.dominant == "memory"
    # by dtype: one second of bf16 and one of float32 outside the tensor
    # cores (TF32 off) add up; the single-total record is the bf16 one
    r3 = A.Roofline("a", "s", "1", 1, 989e12 + 67e12, 0.0, 0.0, {}, 0.0, 0.0,
                    flops_by_dtype={"bfloat16": 989e12, "float32": 67e12})
    assert r3.t_compute == pytest.approx(2.0)
    assert r3.dominant == "compute"
    assert A.compute_seconds({"tf32": 495e12, "float16": 989e12}) == \
        pytest.approx(2.0)
    assert A.Roofline.from_dict(r3.to_dict()) == r3


def _state(arch):
    cfg = get_reduced(arch).replace(dtype="float32",
                                    decode_impl="flash_paged")
    if not cfg.is_mla:              # MLA's prefill has no kernel 1 path
        cfg = cfg.replace(attn_impl="pallas")
    gen = torch.Generator().manual_seed(0)
    params = MD.init_params(cfg, gen, "cpu")
    cache = ST.paged_cache(cfg, 4, 64, 16, "cpu")
    ST.fill(cfg, params, cache, [5, 17, 33, 9], gen)
    ints = {"prefill": torch.randint(0, cfg.vocab_size, (1, 20),
                                     generator=gen, dtype=torch.int32),
            "decode": torch.randint(0, cfg.vocab_size, (4, 1),
                                    generator=gen, dtype=torch.int32),
            "train": torch.randint(0, cfg.vocab_size, (2, 2, 16),
                                   generator=gen, dtype=torch.int32)}
    return cfg, params, cache, ints


def _step(kind, cfg, params, cache, ints):
    if kind == "prefill":
        return ST.prefill(cfg, params, cache, ints, row=3)
    if kind == "decode":
        return ST.decode(cfg, params, cache, ints)
    return ST.train(cfg.replace(attn_impl="einsum"), params, None, ints[0],
                    ints[1])


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-236b"])
def test_cost_mode_counts_the_same_on_cpu_and_meta(arch, kind):
    cfg, params, cache, ints = _state(arch)
    cpu = ST.trace(_step(kind, cfg, params, cache, ints[kind]), "cpu")
    values = {}
    meta = ST.trace(_step(kind, cfg, MD.Model(cfg, "meta"),
                          ST.meta_of(cache, values),
                          ST.meta_of(ints[kind], values)), "meta", values)
    a, b = cpu.totals(), meta.totals()
    assert dict(a.flops_by_dtype) == dict(b.flops_by_dtype)
    assert a.bytes == b.bytes and a.ops == b.ops
    assert a.kernels == b.kernels
    assert a.matmul_flops == b.matmul_flops > 0
    assert cpu.peak_bytes == meta.peak_bytes > 0
    kernel = {"prefill": None if cfg.is_mla else "flash_attention",
              "train": None,
              "decode": ("paged_flash_decode_mla" if cfg.is_mla else
                         "paged_flash_decode")}[kind]
    if kernel is None:
        assert not a.kernels
    else:
        assert set(a.kernels) == {kernel}
        assert a.kernels[kernel]["count"] == cfg.n_blocks


def _kv_len(total, B=8, cap=512):
    base = total // B
    return torch.tensor([base + (i < total - base * B) for i in range(B)],
                        dtype=torch.int32)


def _bound_ms(cost):
    flops, nbytes, dtype = cost
    return round(max(flops / A.peak_flops(dtype), nbytes / A.HBM_BW) * 1e3, 6)


def _meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_kernel_costs_reproduce_the_perf_table_bounds():
    """The bound column of ``PERF.md``'s kernel table (ms)."""
    tbl = torch.zeros((8, 32), dtype=torch.int32)      # max_seq 512 / 16
    for (S, hq, hkv, hd, causal), want in (
            ((479, 15, 5, 64, True), 0.000732),         # kernel 1, smollm
            ((479, 32, 2, 128, True), 0.002489),        # glm4-9b's shape
            ((1500, 6, 6, 64, False), 0.003494),        # whisper encoder
            ((479, 32, 8, 128, True), 0.002928)):       # jamba
        cost = flash_attention_cost(_meta(1, S, hq, hd), _meta(1, S, hkv, hd),
                                    _meta(1, S, hkv, hd), causal=causal)
        assert _bound_ms(cost) == want, (S, hq, hkv, hd)
    # kernel 2 (B = 8, 1404 live keys), at glm4's heads, kernel 3 (W = 5,
    # 1405 live keys at the last position)
    pool = _meta(1 + 8 * 32, 16, 5, 64)
    assert _bound_ms(paged_attn_cost(_meta(8, 15, 64), pool, pool, tbl,
                                     _kv_len(1404))) == 0.000546
    gpool = _meta(1 + 8 * 32, 16, 2, 128)
    assert _bound_ms(paged_attn_cost(_meta(8, 32, 128), gpool, gpool, tbl,
                                     _kv_len(1404))) == 0.000469
    assert _bound_ms(paged_attn_cost(_meta(8, 5, 15, 64), pool, pool, tbl,
                                     _kv_len(1405))) == 0.000583
    # kernels 4 and 5 at deepseek-v2's widths (128 heads, r 512, rh 64)
    ckv, kr = _meta(1 + 8 * 32, 16, 512), _meta(1 + 8 * 32, 16, 64)
    assert _bound_ms(paged_mla_cost(_meta(8, 128, 512), _meta(8, 128, 64),
                                    ckv, kr, tbl, _kv_len(1404))) == 0.001148
    assert _bound_ms(paged_mla_cost(_meta(8, 5, 128, 512),
                                    _meta(8, 5, 128, 64), ckv, kr, tbl,
                                    _kv_len(1405))) == 0.003809
    # kernel 6 (float32, N 30 720, 768 -> 32 -> 768, 5 tasks)
    f32 = torch.float32
    assert _bound_ms(multi_lora_cost(
        _meta(30720, 768, dtype=f32), _meta(5, 768, 32, dtype=f32),
        _meta(5, 32, 768, dtype=f32),
        _meta(30720, dtype=torch.int32))) == 0.056672
    # the contiguous flash_decode (kernel 1 with one query position)
    kv = _meta(8, 512, 5, 64)
    assert _bound_ms(flash_decode_cost(_meta(8, 15, 64), kv, kv,
                                       _kv_len(1404))) == 0.000546


def test_kernel_region_is_one_opaque_op():
    """Under ``CostMode`` a wrapper's call notes its cost function's
    numbers once, and none of its plain version's ops; nested wrappers
    (``flash_decode`` over ``flash_attention``) note once."""
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(2, 9, 4, 16, generator=gen)
    k = torch.randn(2, 9, 2, 16, generator=gen)
    with CostMode("cpu") as cm:
        flash_attention(q, k, k, causal=True)
    tot = cm.totals()
    assert tot.ops == 1 and not tot.by_op
    assert tot.kernels["flash_attention"]["flops"] == \
        flash_attention_cost(q, k, k, causal=True)[0]
    pool = torch.randn(5, 4, 2, 16, generator=gen)
    tbl = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    kv_len = torch.tensor([5, 0], dtype=torch.int32)
    qd = torch.randn(2, 4, 16, generator=gen)
    with CostMode("cpu") as cm:
        paged_flash_decode(qd, pool, pool, tbl, kv_len)
    flops, nbytes, dt = paged_attn_cost(qd, pool, pool, tbl, kv_len)
    assert cm.totals().kernels == {"paged_flash_decode": {
        "count": 1, "flops": flops, "bytes": nbytes}}
    assert flops == 4 * 4 * 16 * 5 and dt == "float32"
    x = torch.randn(6, 8, generator=gen)
    a, b = torch.randn(2, 8, 4, generator=gen), torch.randn(2, 4, 8,
                                                            generator=gen)
    w = torch.randn(8, 8, generator=gen)
    with CostMode("cpu") as cm:
        multi_lora(x, a, b, torch.tensor([0, 1, 1, 0, 5, 1],
                                         dtype=torch.int32), w)
    tot = cm.totals()
    assert set(tot.kernels) == {"multi_lora"}
    # the base product x @ w is the step's own op, outside the region
    assert tot.by_op["aten.mm.default"]["flops"] == 2 * 6 * 8 * 8


def test_spec_mesh_collectives_hand_count():
    rec = Recorder()
    mesh = SpecMesh({"data": 2, "model": 2}, rec)
    assert mesh.coords == {"data": 0, "model": 0} and mesh.rank == 0
    t = torch.ones(4, 8)                                  # 128 bytes
    assert mesh.all_reduce(t, "model") is t
    assert mesh.all_gather(t, "data", 0).shape == (8, 8)
    assert mesh.reduce_scatter(t, ("data", "model"), 0).shape == (1, 8)
    mesh.all_reduce(t, ("data", "model"), op="max")
    assert mesh.all_reduce(t, "model") is t
    x = torch.ones(4, 8, requires_grad=True)
    mesh.enter(x, "model").sum().backward()               # bwd all-reduce
    y = torch.ones(4, 8, requires_grad=True)
    mesh.gather(y, "model", 1).sum().backward()           # fwd gather, bwd
    assert y.grad.shape == (4, 8)                         # reduce-scatter
    with CostMode("cpu") as cm:                           # results unseen
        mesh.all_gather(t, "model", 1)
    assert cm.totals().ops == 0
    got = rec.result()
    assert got["all-reduce"]["count"] == 4
    assert got["all-reduce"]["bytes"] == 4 * 128
    assert got["all-gather"]["count"] == 3
    assert got["all-gather"]["bytes"] == 3 * 128
    assert got["reduce-scatter"]["count"] == 2
    assert got["reduce-scatter"]["bytes"] == 128 + 256
    ring = (3 * (2 * 1 / 2 * 128) + 2 * 3 / 4 * 128      # all-reduce
            + 3 * 128                                     # all-gather
            + 3 / 4 * 128 + 1 / 2 * 256) / A.NVLINK_BW    # reduce-scatter
    assert got["total"]["ring_time"] == pytest.approx(ring)
    assert got["total"]["count"] == 9
    # a group of one moves nothing
    SpecMesh({"data": 1, "model": 1}, rec).all_reduce(t, "model")
    assert rec.result()["total"]["count"] == 9


def test_dryrun_record_reanalyze_and_report_round_trip(tmp_path):
    rec, rl = dryrun.run_cell("smollm-360m", "decode_32k", False,
                              out_dir=str(tmp_path))
    tag = dryrun.cell_tag("smollm-360m", "decode_32k", False)
    with open(os.path.join(tmp_path, tag + ".json"), "w") as f:
        json.dump(rec, f)
    assert os.path.exists(os.path.join(tmp_path, tag + ".ops.json.gz"))
    assert rec["chips"] == 256 and rec["mesh"] == "16x16"
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["collective_counts"]["all-reduce"] > 0
    assert rec["peak_memory_per_device"] > 0
    again = reanalyze.reanalyze_file(str(tmp_path), tag)
    for k in ("flops_per_device", "bytes_per_device", "t_compute",
              "t_memory", "t_collective", "dominant", "model_flops_total",
              "flops_by_dtype", "peak_memory_per_device"):
        assert again[k] == rec[k], k
    recs = report.load(str(tmp_path))
    assert len(recs) == 1
    table = report.fmt_table(recs)
    assert "| smollm-360m | decode_32k |" in table
    assert "| smollm-360m | decode_32k | 16x16 |" in report.fmt_dryrun(recs)
    assert "baseline" in report.fmt_variants(recs, "smollm-360m",
                                             "decode_32k")
    assert "| smollm-360m | decode_32k | " in report.fmt_meshes(recs)
