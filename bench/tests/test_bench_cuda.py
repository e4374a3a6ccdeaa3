"""On the card, at each cell's own size and load: the program's logit
gaps stay within the cell's limits and the control's (the reference in
fp8 in the program's place) exceeds one of them, on three seeds.  Marked
``cuda``; skipped without a card.

    PYTHONPATH=src python -m pytest -q -m cuda bench/tests/test_bench_cuda.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

import bench_tiny  # noqa: F401
from vsrbench import spec as S

TOOL = Path(S.BENCH / "tools" / "readings.py")
SEEDS = "3101,3102,3103"


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in S.load_spec()
                                  ["workloads"]])
def test_bench_control_fails_where_the_program_passes(card, cell, tmp_path):
    out = tmp_path / "readings.jsonl"
    seconds = 15 if S.resolve(cell).mix["loop"] == "closed" else 20
    got = subprocess.run(
        [sys.executable, str(TOOL), "--workload", cell, "--seeds", SEEDS,
         "--control-seeds", SEEDS, "--seconds", str(seconds), "--out",
         str(out)], capture_output=True, text=True, timeout=1500)
    assert got.returncode == 0, got.stderr[-3000:]
    limits = S.resolve(cell).limits
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert len(lines) == 3
    for line in lines:
        assert not any(line["counts"].values()), line
        for number, stat in (("logit_gap", "widest"),
                             ("mean_logit_gap", "mean")):
            if number in limits:
                assert line["program"][stat] <= limits[number], line
        assert any(line["control"][stat] > limits[number]
                   for number, stat in (("logit_gap", "widest"),
                                        ("mean_logit_gap", "mean"))
                   if number in limits), line
