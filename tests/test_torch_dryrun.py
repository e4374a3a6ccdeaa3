"""The port's production-mesh dry run (``repro_torch.launch.dryrun``).

The reference compiles every cell for 512 fake devices (up to ~560 s);
that run is not repeated here.  Its record fields and last line are: a
subprocess of the port's CLI for ``whisper-tiny x decode_32k`` (a member
``check_shardable`` refuses over the model axis: ``NOT-SHARDABLE``) and
for a dense train cell ends with the reference's last line; the
``NOT-SHARDABLE`` set over every arch's ``decode_32k`` cell equals the
archs ``check_shardable`` refuses on the 16 x 16 mesh — the SSM and
cross-attention members, and the GQA members whose query heads split
over 16 while their KV heads do not — and the other cells are records;
an MoE cell's ``model_flops_total`` equals the reference's
``model_flops``.
"""

import os
import subprocess
import sys

import pytest

from repro.configs import get_config as jget_config
from repro.models.config import model_flops as jmodel_flops
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import SpecMesh
from repro_torch.models import model as MD

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFUSED = {"llama-3.2-vision-90b", "whisper-tiny", "jamba-v0.1-52b",
           "xlstm-350m", "qwen3-1.7b", "llama3.2-1b", "glm4-9b",
           "qwen3-moe-235b-a22b"}


def _cli(*args, out_dir):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--out-dir", str(out_dir)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)


def test_cli_refused_member_and_dense_train_cell(tmp_path):
    p = _cli("--arch", "whisper-tiny", "--shape", "decode_32k",
             out_dir=tmp_path)
    assert p.returncode == 0, p.stderr
    lines = p.stdout.strip().splitlines()
    assert lines[0].startswith("NOT-SHARDABLE whisper-tiny__decode_32k__"
                               "16x16: ")
    assert lines[-1] == ("all dry-run cells passed (0 recorded, 1 not "
                         "shardable)")
    p = _cli("--arch", "smollm-360m", "--shape", "train_4k",
             out_dir=tmp_path)
    assert p.returncode == 0, p.stderr
    lines = p.stdout.strip().splitlines()
    assert lines[0].startswith("OK   smollm-360m")
    assert lines[-1].startswith("all dry-run cells passed (1 recorded")
    tag = "smollm-360m__train_4k__16x16"
    assert {tag + ".json", tag + ".ops.json.gz"} <= set(os.listdir(tmp_path))


@pytest.fixture(scope="module")
def decode_cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dr")
    recs, refused = {}, {}
    for arch in list_archs():
        try:
            recs[arch] = dryrun.run_cell(arch, "decode_32k", False,
                                         keep_trace=False,
                                         out_dir=str(out))[0]
        except NotImplementedError as e:
            refused[arch] = str(e)
    return recs, refused


def test_not_shardable_set_equals_the_refused_archs(decode_cells):
    recs, refused = decode_cells
    mesh = SpecMesh.production()
    want = set()
    for arch in list_archs():
        try:
            MD.check_shardable(get_config(arch), mesh)
        except NotImplementedError:
            want.add(arch)
    assert set(refused) == want == REFUSED
    assert set(recs) == set(list_archs()) - REFUSED
    for rec in recs.values():
        assert rec["chips"] == 256 and rec["shape"] == "decode_32k"
        assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
        assert rec["peak_memory_per_device"] > 0 and rec["trace_s"] > 0
        assert rec["dominant"] in ("compute", "memory", "collective")


def test_moe_cell_model_flops_match_reference(decode_cells):
    recs, _ = decode_cells
    arch = "deepseek-v2-236b"
    assert recs[arch]["model_flops_total"] == jmodel_flops(
        jget_config(arch), 128, mode="serve")
    # expert-parallel: the rank's collectives include the experts'
    # all-reduce over "model"
    assert recs[arch]["collective_counts"]["all-reduce"] > 0
