"""Production-mesh dry run (``repro.launch.dryrun``' twin): trace every
(arch x shape) cell's step as rank 0 of the 16 x 16 (or 2 x 16 x 16) mesh
on the meta device, count its FLOPs, bytes, collectives and live bytes,
and derive the H100 roofline terms.

The reference lowers and compiles each cell for 512 fake devices and
reads XLA's cost and memory analyses.  Here rank 0's step runs once on
the meta device (shapes, no storage) over a ``launch.mesh.SpecMesh``:

* ``train_4k``: ``train_lib.build_train_step`` (remat on);
* ``prefill_32k``: the prefill of ``serve_lib.build_serve_steps``;
* ``decode_32k`` / ``long_500k``: its decode, one token per row over a
  full contiguous cache (``cache["pos"]`` at its last position, a value
  the trace carries alongside the meta tensors).

The step runs under ``roofline.op_cost.CostMode`` with the live-bytes
tracker (parameters, optimizer state, cache, activations and the remat
recompute: the stand-in for ``memory_analysis()``); the mesh records its
collectives.  Each cell writes ``<tag>.json`` (the reference's record
fields, ``trace_s`` in place of ``lower_s`` / ``compile_s``) and its op
trace ``<tag>.ops.json.gz`` (``roofline.reanalyze`` re-derives the record
from it).  Every time in a record is a projection from the H100's data
sheet peaks (``roofline.analysis``), not a measurement.

Members that ``models.model.check_shardable`` refuses over a model axis
print ``NOT-SHARDABLE <tag>: <reason>`` and are counted in the last line;
they do not fail ``--all``, any other exception does.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes] [--out-dir experiments/raw_torch]
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import time
import traceback

import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES, applicable, cells
from repro_torch.device import torch_dtype
from repro_torch.launch.mesh import SpecMesh
from repro_torch.models import model as MD
from repro_torch.models.config import model_flops
from repro_torch.roofline.analysis import Roofline, summarize
from repro_torch.roofline.collectives import Recorder
from repro_torch.roofline.op_cost import CostMode
from repro_torch.serving import serve_lib
from repro_torch.training import train_lib
from repro_torch.training.optimizer import init_opt_state

OUT_DIR = "experiments/raw_torch"


def input_specs(arch: str, shape_name: str) -> dict:
    """Meta stand-ins for every step input (no storage)."""
    cfg = get_config(arch)
    cell = SHAPES[shape_name]
    B, S = cell.global_batch, cell.seq_len

    def meta(shape, dt=torch.int32):
        return torch.empty(shape, dtype=dt, device="meta")
    out = {}
    if cell.kind in ("train", "prefill"):
        out["tokens"] = meta((B, S))
        if cell.kind == "train":
            out["labels"] = meta((B, S))
        if cfg.cross_ctx_len:
            out["cross_ctx"] = meta((B, cfg.cross_ctx_len, cfg.d_model),
                                    torch_dtype(cfg.dtype))
    else:  # decode
        out["tokens"] = meta((B, 1))
    return out


def _tokens_processed(cell) -> int:
    if cell.kind == "decode":
        return cell.global_batch           # one token per sequence
    return cell.global_batch * cell.seq_len


VARIANTS = {
    "baseline": lambda cfg: cfg,
    "blocked_attn": lambda cfg: cfg.replace(attn_impl="blocked"),
    "blocked_attn_256": lambda cfg: cfg.replace(attn_impl="blocked",
                                                attn_block=256),
    "blocked_attn_1k": lambda cfg: cfg.replace(attn_impl="blocked",
                                               attn_block=1024),
    "smdec": lambda cfg: cfg.replace(decode_impl="shardmap"),
    "mla_tp": lambda cfg: cfg.replace(shard_variant="mla_tp"),
    "mla_tp+blocked": lambda cfg: cfg.replace(shard_variant="mla_tp",
                                              attn_impl="blocked"),
    "smdec+mla_tp": lambda cfg: cfg.replace(decode_impl="shardmap",
                                            shard_variant="mla_tp"),
    # weights-stationary MoE serving (gather activations, not experts)
    "smdec+moe_ws": lambda cfg: cfg.replace(decode_impl="shardmap"),
    "smdec+mla_tp+moe_ws": lambda cfg: cfg.replace(
        decode_impl="shardmap", shard_variant="mla_tp"),
}


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def cell_tag(arch: str, shape: str, multi_pod: bool,
             variant: str = "baseline") -> str:
    tag = f"{arch}__{shape}__{mesh_name(multi_pod)}"
    return tag if variant == "baseline" else f"{tag}__{variant}"


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             moe_impl: str = "ep", variant: str = "baseline",
             keep_trace: bool = True, out_dir: str = OUT_DIR):
    """Trace one cell; returns ``(record, Roofline)``.  Raises
    ``NotImplementedError`` for a member ``check_shardable`` refuses."""
    cfg = VARIANTS[variant](get_config(arch))
    if "moe_ws" in variant:
        moe_impl = "ep_serve"
    cell = SHAPES[shape_name]
    recorder = Recorder()
    mesh = SpecMesh.production(multi_pod=multi_pod, recorder=recorder)
    MD.check_shardable(cfg, mesh)
    B, S = cell.global_batch, cell.seq_len
    specs = input_specs(arch, shape_name)
    cross = specs.get("cross_ctx")

    t0 = time.perf_counter()
    params = MD.Model(cfg, "meta", mesh)
    values = {}
    if cell.kind == "train":
        step, _ = train_lib.build_train_step(cfg, mesh, batch=B,
                                             moe_impl=moe_impl, remat=True)
        opt = init_opt_state(params)
        state = [params.parameters(), opt.m, opt.v, opt.step]
        args = [params, opt, specs["tokens"], specs["labels"]]
        if cross is not None:
            args.append(cross)
    else:
        pre, dec, _ = serve_lib.build_serve_steps(cfg, mesh, B, S,
                                                  moe_impl=moe_impl)
        cache = MD.init_cache(cfg, B, S, "meta", mesh)
        state = [params.parameters(), cache]
        if cell.kind == "prefill":
            step = pre
            args = [params, specs["tokens"], cache]
            if cross is not None:
                args.append(cross)
        else:
            step = dec
            args = [params, specs["tokens"], cache]
            values[cache["pos"]] = torch.tensor(S - 1, dtype=torch.int32)
    held = [t for tree in state + args[1:] for t in _tensors(
        list(tree) if not isinstance(tree, (dict, torch.Tensor)) else tree)]
    with CostMode("meta", values=values, track_memory=True,
                  held=held) as cm:
        step(*args)
    trace_s = time.perf_counter() - t0
    tot = cm.totals()
    coll = recorder.result()
    mode = "train" if cell.kind == "train" else "serve"
    mf = model_flops(cfg, _tokens_processed(cell), mode=mode)
    rl = Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name(multi_pod),
        chips=mesh.size, flops_per_device=tot.flops,
        bytes_per_device=float(tot.bytes),
        collective_bytes_per_device=coll["total"]["bytes"],
        collective_breakdown={k: v["bytes"] for k, v in coll.items()
                              if k != "total"},
        model_flops_total=mf, peak_memory_per_device=float(cm.peak_bytes),
        flops_by_dtype=dict(tot.flops_by_dtype))
    rec = rl.to_dict()
    rec.update(variant=variant, moe_impl=moe_impl, trace_s=trace_s,
               ops=tot.ops, host_ops=tot.host_ops, kernels=tot.kernels,
               collective_ring_time=coll["total"]["ring_time"],
               collective_counts={k: v["count"] for k, v in coll.items()
                                  if k != "total"},
               collectives=coll)
    if keep_trace:
        os.makedirs(out_dir, exist_ok=True)
        tag = cell_tag(arch, shape_name, multi_pod, variant)
        with gzip.open(os.path.join(out_dir, tag + ".ops.json.gz"),
                       "wt") as f:
            json.dump(cm.archive(), f)
    return rec, rl


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--moe-impl", default="ep")
    ap.add_argument("--variant", default="baseline", choices=sorted(VARIANTS))
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    todo = []
    if args.all:
        todo = [(arch, shape) for arch, shape, _ in cells()]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        if not applicable(args.arch, args.shape):
            print(f"SKIP {args.arch} x {args.shape} (inapplicable: "
                  "long_500k runs only for sub-quadratic archs)")
            return 0
        todo.append((args.arch, args.shape))

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures, refused, done = [], [], 0
    for arch, shape in todo:
        for mp in meshes:
            tag = cell_tag(arch, shape, mp, args.variant)
            try:
                rec, rl = run_cell(arch, shape, mp, moe_impl=args.moe_impl,
                                   variant=args.variant,
                                   out_dir=args.out_dir)
            except NotImplementedError as e:
                refused.append(tag)
                print(f"NOT-SHARDABLE {tag}: {e}", flush=True)
                continue
            except Exception as e:      # the run goes on; the exit fails
                failures.append((tag, repr(e)))
                print(f"FAIL {tag}: {e}", flush=True)
                traceback.print_exc()
                continue
            with open(os.path.join(args.out_dir, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
            done += 1
            print("OK  ", summarize(rl),
                  f"trace={rec['trace_s']:.1f}s "
                  f"mem/dev={rec['peak_memory_per_device'] / 2**30:.2f}GiB",
                  flush=True)

    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e)
        return 1
    print(f"\nall dry-run cells passed ({done} recorded, {len(refused)} "
          f"not shardable)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
