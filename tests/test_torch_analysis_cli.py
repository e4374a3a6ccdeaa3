"""The port's policy-lint CLI (``python -m repro_torch.analysis``)
against the reference's (``repro.analysis.__main__.main``): the same
output lines and exit codes over ``examples/policies`` with and without
``--strict`` and ``--no-demo-exempt``, for one file, and with no policy
file at all."""

import os
import subprocess
import sys

import pytest

from repro.analysis.__main__ import main as jmain
from repro_torch.analysis.__main__ import main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICIES = os.path.join(ROOT, "examples", "policies")


def _run(fn, argv, capsys):
    rc = fn(argv)
    out = capsys.readouterr()
    return rc, out.out.splitlines(), out.err.splitlines()


@pytest.mark.parametrize("flags", [[], ["--strict"], ["--no-demo-exempt"],
                                   ["--strict", "--no-demo-exempt"]])
def test_cli_matches_reference(flags, capsys):
    for paths in ([POLICIES], [os.path.join(POLICIES, "lint_demo.vsr")],
                  [os.path.join(POLICIES, "cost.vsr"),
                   os.path.join(POLICIES, "privacy.vsr")]):
        got = _run(main, paths + flags, capsys)
        want = _run(jmain, paths + flags, capsys)
        assert got == want, (paths, flags)
    rc, lines, _ = _run(main, [POLICIES] + flags, capsys)
    assert lines[-1].startswith("analysis: 3 file(s)")
    assert rc == (1 if flags == ["--strict", "--no-demo-exempt"] else 0)


def test_cli_without_policy_files(tmp_path, capsys):
    got = _run(main, [str(tmp_path)], capsys)
    assert got == _run(jmain, [str(tmp_path)], capsys)
    assert got[0] == 2 and got[2] == ["no policy files found"]


def test_module_entry_point():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                        POLICIES, "--strict", "--no-demo-exempt"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == 1
    assert "lint_demo.vsr: FAIL" in p.stdout
    assert "jax" not in p.stderr
