"""Render the roofline tables from the dry run's records
(``repro.roofline.report``' twin).

  PYTHONPATH=src python -m repro_torch.roofline.report [--mode dryrun|meshes] [--raw experiments/raw_torch]

Every time in these tables is a projection from the H100 data sheet's
peaks (``roofline.analysis``), not a measurement.
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.dryrun import OUT_DIR


def load(raw: str = OUT_DIR):
    recs = []
    for fn in sorted(os.listdir(raw)):
        if fn.endswith(".json"):
            with open(os.path.join(raw, fn)) as f:
                recs.append(json.load(f))
    return recs


def fmt_table(recs, mesh="16x16", variant="baseline"):
    rows = [r for r in recs if r["mesh"] == mesh
            and r.get("variant", "baseline") == variant]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    out = ["| arch | shape | t_compute | t_memory | t_collective | dominant "
           "| MODEL/counted | roofline | HBM/dev |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute']*1e3:.1f}ms "
            f"| {r['t_memory']*1e3:.1f}ms | {r['t_collective']*1e3:.1f}ms "
            f"| {r['dominant']} | {r['useful_flops_ratio']:.3f} "
            f"| {r['roofline_fraction']*100:.3f}% "
            f"| {r['peak_memory_per_device']/2**30:.1f}G |")
    return "\n".join(out)


def fmt_dryrun(recs, variant="baseline"):
    rows = [r for r in recs if r.get("variant", "baseline") == variant]
    rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    out = ["| arch | shape | mesh | GFLOP/dev | HBM GB/dev | coll GB/dev"
           " | coll ops | trace s |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        nops = sum(r.get("collective_counts", {}).values())
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['flops_per_device']/1e9:.0f} "
            f"| {r['bytes_per_device']/1e9:.0f} "
            f"| {r['collective_bytes_per_device']/1e9:.2f} "
            f"| {nops:.0f} | {r.get('trace_s', 0):.0f} |")
    return "\n".join(out)


def fmt_meshes(recs, variant="baseline"):
    """One row per (arch, shape): each mesh's counts per device and its
    projected terms side by side."""
    rows = {}
    for r in recs:
        if r.get("variant", "baseline") == variant:
            rows.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    meshes = sorted({m for v in rows.values() for m in v})
    head = "| arch | shape |" + "".join(
        f" {m}: TFLOP / GB / coll GB / GiB per device | {m}: bound ms "
        f"(term) |" for m in meshes)
    out = [head, "|---|---|" + "---|---|" * len(meshes)]
    for (arch, shape), by in sorted(rows.items()):
        cells = ""
        for m in meshes:
            r = by.get(m)
            if r is None:
                cells += " – | – |"
                continue
            bound = max(r["t_compute"], r["t_memory"], r["t_collective"])
            cells += (f" {r['flops_per_device'] / 1e12:.3f} / "
                      f"{r['bytes_per_device'] / 1e9:.1f} / "
                      f"{r['collective_bytes_per_device'] / 1e9:.3f} / "
                      f"{r['peak_memory_per_device'] / 2**30:.1f} | "
                      f"{bound * 1e3:.2f} ({r['dominant']}) |")
        out.append(f"| {arch} | {shape} |{cells}")
    return "\n".join(out)


def fmt_variants(recs, arch, shape, mesh="16x16"):
    rows = [r for r in recs if r["arch"] == arch and r["shape"] == shape
            and r["mesh"] == mesh]
    order = {"baseline": 0}
    rows.sort(key=lambda r: order.get(r.get("variant", "baseline"), 1))
    out = [f"**{arch} × {shape}** ({mesh}):", "",
           "| variant | t_compute | t_memory | t_collective | dominant | "
           "roofline | HBM/dev |",
           "|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r.get('variant', 'baseline')} | {r['t_compute']*1e3:.1f}ms "
            f"| {r['t_memory']*1e3:.1f}ms | {r['t_collective']*1e3:.1f}ms "
            f"| {r['dominant']} | {r['roofline_fraction']*100:.3f}% "
            f"| {r['peak_memory_per_device']/2**30:.1f}G |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="roofline",
                    choices=["roofline", "dryrun", "meshes", "variants"])
    ap.add_argument("--raw", default=OUT_DIR)
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    args = ap.parse_args(argv)
    recs = load(args.raw)
    if args.mode == "roofline":
        print(fmt_table(recs, args.mesh, args.variant))
    elif args.mode == "dryrun":
        print(fmt_dryrun(recs, args.variant))
    elif args.mode == "meshes":
        print(fmt_meshes(recs, args.variant))
    else:
        print(fmt_variants(recs, args.arch, args.shape, args.mesh))


if __name__ == "__main__":
    main()
