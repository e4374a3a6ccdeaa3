"""Model-FLOP, kernel-roofline, MFU and idle arithmetic against values
reckoned by hand, through the metric readers on a synthetic run."""

import math

import pytest

import bench_tiny
from roofline import PEAKS, bound_s
from roofline import deepseek_v2 as FD
from roofline import glm4 as FG
from roofline.kernel_flash_prefill import launch_work
from roofline.kernel_mla_decode import fixed_work, key_work
from vsrbench import spec as S
from vsrbench.drive import RequestRecord, Run
from vsrbench.system import BatchRecord
from vsrbench.trace import DeviceEvent, TraceData


def test_bench_model_flops_by_hand():
    ds = bench_tiny.config("deepseek-v2-stage")
    # active matmul weights a token passes: 3 MLA layers of
    # 64*32 + 32*4*24 + 64*24 + 16*4*32 + 4*16*64 = 12800, the dense FFN
    # 3*64*128 = 24576, 2 MoE FFNs of (2 + 2)*3*64*32 + 64*8 = 25088
    per_token = 3 * 12800 + 24576 + 2 * 25088
    # a prompt of 10 and 4 answer tokens: 13 tokens fed, 91 (query, key)
    # pairs a layer, 4 logits rows
    want = 2 * per_token * 13 + 2 * 4 * (24 + 16) * 91 * 3 + 2 * 64 * 256 * 4
    assert FD.request_flops(ds, 10, 4) == want == 3160384
    glm = bench_tiny.config("glm4-9b")
    per_token = 2 * (64 * 64 + 2 * 64 * 32 + 64 * 64 + 3 * 64 * 128)
    want = 2 * per_token * 13 + 4 * 4 * 16 * 91 * 2 + 2 * 64 * 256 * 4
    assert FG.request_flops(glm, 10, 4) == want == 2094592


def test_bench_kernel_work_by_hand():
    # kernel 1 at glm4-9b's widths, a 4095-token prompt: 64 tiles of 64
    flops, nbytes = launch_work((64, 32, 1), kv_heads=2, head_dim=128)
    assert flops == 4 * 128 * 32 * (4096 * 4097 // 2) == 137472507904
    assert nbytes == 2 * 4096 * 128 * (2 * 32 + 2 * 2) == 71303168
    assert math.isclose(bound_s(flops, nbytes), flops / 989e12)
    # kernel 4: 64 rows of 128 heads, r 512, rh 64, 33-block tables
    f, b = fixed_work(64, 128, 512, 64, 33)
    assert f == 0 and b == 2 * 64 * 128 * 1088 + 4 * 64 * 34
    f, b = key_work(1000, 128, 512, 64)
    assert f == 1000 * 128 * (4 * 512 + 2 * 64) and b == 1000 * 2 * 576
    assert PEAKS["hbm_bytes_per_s"] == 3.35e12


def _run(cell: str, served_words, n_new: int, slots: int,
         kernel_names, grids, kernel_s: float, window=(10.0, 12.0)):
    c = S.resolve(cell)
    run = Run(cell=cell, mix=dict(c.mix), config=c.config, seed=1,
              seconds=45.0, t_process=0.0)
    run.t_open, run.t_close = 0.0, 50.0
    for i, w in enumerate(served_words):
        run.requests[i] = RequestRecord(
            index=i, text="", words=w, pii=False, due=0.0, sent=0.0,
            done=1.0, blocked=False,
            usage={"completion_tokens": n_new})
    run.batches = [BatchRecord(start=0.0, end=9.0),
                   BatchRecord(start=window[0], end=window[1],
                               indices=list(range(len(served_words))))]
    t = TraceData(window[0], window[1], 1, 1)
    step = kernel_s / len(grids)
    for j, g in enumerate(grids):
        t0 = window[0] + 0.1 + j * 2 * step
        t.events.append(DeviceEvent("kernel", f"void {kernel_names}<x>()",
                                    t0, t0 + step, g))
    run.trace = t
    return run


def test_bench_mla_roofline_reader_by_hand():
    # two requests (prompts 100 and 250 words) decoding 256 tokens in one
    # traced batch: 8 layers x 255 steps launches of 64 rows
    steps, layers = 255, 8
    grids = [(4, 1, 64)] * (layers * steps)
    run = _run("deepseek-v2-stage.decode", [100, 250], 256, 64,
               "paged_mla_kernel", grids, kernel_s=0.5)
    keys = layers * sum(steps * n + steps * 256 // 2 for n in (100, 250))
    dead = layers * steps * 64 - layers * steps * 2
    flops, nbytes = key_work(keys + dead, 128, 512, 64)
    fb = fixed_work(64, 128, 512, 64, 528 // 16)[1] * layers * steps
    want = 100 * bound_s(flops, nbytes + fb) / 0.5
    got = S.reader("mla_decode_roofline.decode")(run)
    assert math.isclose(got, want, rel_tol=1e-9)
    # the whole batch's model FLOPs over the traced 2 s at the bf16 peak
    cfg = run.config
    mfu = 100 * sum(FD.request_flops(cfg, n, 256) for n in (100, 250)) / (
        2.0 * 989e12)
    assert math.isclose(S.reader("mfu.decode")(run), mfu, rel_tol=1e-9)
    # 0.5 s of kernels in 2 s: 75% idle
    assert math.isclose(S.reader("idle_pct.decode")(run), 75.0,
                        rel_tol=1e-9)


def test_bench_flash_roofline_reader_by_hand():
    grids = [(64, 32, 1)] * 40
    run = _run("glm4-9b.rag", [3000], 16, 32, "flash_attention_tc_kernel",
               grids, kernel_s=0.02)
    want = 100 * 40 * (137472507904 / 989e12) / 0.02
    assert math.isclose(S.reader("flash_prefill_roofline.rag")(run), want,
                        rel_tol=1e-9)
    # prompts longer than the cap count at the cap
    cfg = run.config
    mfu = 100 * FG.request_flops(cfg, 3000, 16) / (2.0 * 989e12)
    assert math.isclose(S.reader("mfu.rag")(run), mfu, rel_tol=1e-9)
    run.requests[0].words = 5000
    assert math.isclose(S.reader("mfu.rag")(run),
                        100 * FG.request_flops(cfg, 4095, 16) / 1.978e15,
                        rel_tol=1e-9)


@pytest.mark.parametrize("name", ["mla_decode_roofline.decode",
                                  "flash_prefill_roofline.rag",
                                  "mfu.decode", "idle_pct.rag"])
def test_bench_device_readers_read_nothing_without_a_trace(name):
    run = _run("glm4-9b.rag", [3000], 16, 32, "other_kernel",
               [(1, 1, 1)], kernel_s=0.01)
    run.trace = None
    assert S.reader(name)(run) is None
