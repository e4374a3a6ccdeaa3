"""The whole run of each cell on the CPU at small sizes (the look for a
card skipped), sound and then with the timed path broken underneath: each
fault a serving cell can have must turn ``correct`` false."""

import math

import pytest
import torch

import bench_tiny
from vsrbench import harness as H
from vsrbench.check import verdict

SEED = 2 ** 31 + 99
CELLS = ["deepseek-v2-stage.decode", "glm4-9b.rag"]


@pytest.fixture(scope="module", params=CELLS)
def built(request):
    cell = bench_tiny.cell(request.param)
    system = H.build(cell, SEED, "cpu", encoder=bench_tiny.ENCODER)
    yield cell, system
    system.release()


def _run(cell, system, seconds=None):
    # a closed loop's window holds whole batches only: give one room to
    # finish on a loaded machine (the test run shares its cores)
    if seconds is None:
        seconds = 3.0 if cell.mix["loop"] == "closed" else 1.0
    run = H.serve(system, cell, SEED, seconds, False, 0.0)
    checks = H.judge(system, run, cell.limits, release=False)
    return run, checks


def test_bench_sound_run_is_correct(built):
    cell, system = built
    run, checks = _run(cell, system)
    assert verdict(checks), checks
    assert checks["mean_logit_gap"][0] is not None
    line = H.result_line(cell, run, checks, False, {"platform": "cpu"})
    assert line["correct"] and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(line)[-1] == "checks"
    assert sum(r.pii for r in run.requests.values()) >= 1
    served = [r for r in run.requests.values() if not r.blocked]
    assert served and all(r.model == system.model_name for r in served)
    if cell.mix["loop"] == "closed":
        assert line["metrics"]["tokens_per_s"]["value"] > 0
        assert len(run.window_batches()) >= 1
    else:
        lat = line["metrics"]
        assert 0 < lat["latency_p50_ms"]["value"] <= \
            lat["latency_p90_ms"]["value"]


def _token_altered(monkeypatch, system):
    from repro_torch.serving import serve_lib
    inner = serve_lib.greedy

    def greedy(logits, cfg=None):
        return (inner(logits, cfg) + 1) % logits.shape[-1]
    monkeypatch.setattr(serve_lib, "greedy", greedy)


def _state_unchanged(monkeypatch, system):
    from repro_torch.models import model as MD
    monkeypatch.setattr(MD, "_paged_write", lambda *a, **k: None)


def _answer_altered(monkeypatch, system):
    # the router's PII signal finds nothing: SSN-carrying requests are
    # served instead of blocked
    from repro_torch.classifiers.backend import HashBackend
    monkeypatch.setattr(HashBackend, "token_classify",
                        lambda self, texts: [[] for _ in texts])


def _half_left_out(monkeypatch, system):
    inner = system.router.route_batch

    def route_batch(reqs):
        pairs = inner(reqs)
        return pairs[:len(pairs) // 2]        # a lone request: none back
    monkeypatch.setattr(system.router, "route_batch", route_batch)


@pytest.mark.parametrize("fault,fails", [
    (_token_altered, "mean_logit_gap"),
    (_state_unchanged, "mean_logit_gap"),
    (_answer_altered, "outcome_wrong"),
    (_half_left_out, "unanswered"),
])
def test_bench_broken_path_is_not_correct(built, monkeypatch, fault, fails):
    cell, system = built
    with monkeypatch.context() as m:
        fault(m, system)
        run, checks = _run(cell, system)
    value, limit = checks[fails]
    assert value is not None and value > limit, checks
    assert not verdict(checks)


def test_bench_frontend_batches_are_recorded(built):
    cell, system = built
    run, _ = _run(cell, system, seconds=0.5)
    assert run.batches and all(b.end >= b.start for b in run.batches)
    stages = {name for b in run.batches for name, _ in b.stages}
    assert {"stage:signals", "stage:wrap"} <= stages
    idx = [i for b in run.batches for i in b.indices]
    assert sorted(idx) == sorted(run.requests)
    assert math.isfinite(run.setup_s) or run.t_process == 0.0
    assert torch.get_num_threads() >= 1
