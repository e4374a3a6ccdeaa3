"""A fresh interpreter that imports the harness and runs a short window of
a cell at a small size loads no module of JAX or of the JAX package (whole
top-level names: ``repro_torch`` is the program); ``run.py`` without a
card exits non-zero and prints no result."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

SCRIPT = r"""
import json, sys
sys.path[:0] = [sys.argv[1]]
import bench_tiny
from vsrbench import harness as H
cell = bench_tiny.cell("deepseek-v2-stage.decode")
system = H.build(cell, 5, "cpu", encoder=bench_tiny.ENCODER)
run = H.serve(system, cell, 5, 0.3, False, 0.0)
print(json.dumps({"bad": H.forbidden_modules(), "n": len(run.requests),
                  "repro_torch": "repro_torch" in sys.modules}))
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_bench_run_loads_no_jax_module():
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(BENCH / "tests")],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "n": got["n"], "repro_torch": True}
    assert got["n"] > 0


def test_bench_run_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():       # decided here, never at import
        pytest.skip("a card is present: run.py would measure")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "glm4-9b.rag", "--seed", str(2 ** 31 + 3), "--seconds", "1",
         "--trace", "0"],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
