"""Re-derive roofline records from archived op traces (no re-trace)
(``repro.roofline.reanalyze``' twin).

  PYTHONPATH=src python -m repro_torch.roofline.reanalyze [--raw experiments/raw_torch]

Reads every ``<tag>.ops.json.gz`` the dry run wrote (per op signature:
name, dtypes, input and output shapes, count; each kernel region's cost),
reruns the (possibly improved) cost model of ``roofline.op_cost`` over it,
and rewrites the matching ``<tag>.json`` roofline fields in place.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.dryrun import OUT_DIR, VARIANTS
from repro_torch.models.config import model_flops
from repro_torch.roofline.analysis import Roofline, summarize
from repro_torch.roofline.op_cost import from_archive


def reanalyze_file(raw_dir: str, tag: str) -> dict:
    with gzip.open(os.path.join(raw_dir, tag + ".ops.json.gz"), "rt") as f:
        trace = json.load(f)
    with open(os.path.join(raw_dir, tag + ".json")) as f:
        rec = json.load(f)
    tot = from_archive(trace)
    cell = SHAPES[rec["shape"]]
    n_tok = cell.global_batch * (1 if cell.kind == "decode" else
                                 cell.seq_len)
    cfg = VARIANTS[rec.get("variant", "baseline")](get_config(rec["arch"]))
    mf = model_flops(cfg, n_tok,
                     mode="train" if cell.kind == "train" else "serve")
    rl = Roofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        chips=rec["chips"], flops_per_device=tot.flops,
        bytes_per_device=float(tot.bytes),
        collective_bytes_per_device=rec["collective_bytes_per_device"],
        collective_breakdown=rec["collective_breakdown"],
        model_flops_total=mf,
        peak_memory_per_device=rec["peak_memory_per_device"],
        flops_by_dtype=dict(tot.flops_by_dtype))
    out = dict(rec)
    out.update(rl.to_dict())
    out.update(ops=tot.ops, host_ops=tot.host_ops, kernels=tot.kernels)
    with open(os.path.join(raw_dir, tag + ".json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--raw", default=OUT_DIR)
    args = ap.parse_args(argv)
    tags = sorted(fn[:-len(".ops.json.gz")] for fn in os.listdir(args.raw)
                  if fn.endswith(".ops.json.gz"))
    for tag in tags:
        rec = reanalyze_file(args.raw, tag)
        print("RE  ", summarize(Roofline.from_dict(rec)), flush=True)


if __name__ == "__main__":
    main()
