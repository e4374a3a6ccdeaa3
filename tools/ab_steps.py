#!/usr/bin/env python3
"""The port's steps, this tree against another checkout, in one process.

    python3 tools/ab_steps.py <other checkout> [--blocks 16] [--kinds ...]

Two runs of one step in two processes differ by the host's state (its
clock, its neighbours) as much as by the code, so both trees run here
side by side.  The other checkout's ``src/repro_torch`` is copied into a
temporary directory as the package ``repro_torch_other`` (every import
renamed).  For each kind -- ``smollm_decode`` (smollm-360m, B = 8,
``flash_paged``), ``smollm_verify`` (the same, W = 5: the speculative
lane's k = 4), ``deepseek_decode`` (deepseek-v2 at published widths cut
to 1 dense + 3 MoE layers, B = 8, ``flash_paged``) -- both packages
build the step on the same weights over the fleet's paged cache, rows
filled to the depths below; their tokens must agree.  Then blocks of 10
steps of each package alternate (which goes first alternates too), each
block's CUDA-event median is kept, and one JSON line a kind prints the
blocks, their medians and the blocks this tree won.  It is a comparison
of two trees, not a benchmark.  It needs one NVIDIA card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import re
import shutil
import statistics
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENS = (479, 300, 200, 100, 37, 128, 250, 400)


def renamed_copy(other: str, dest: str) -> None:
    """``other``'s ``src/repro_torch`` as ``dest/repro_torch_other``."""
    pkg = os.path.join(dest, "repro_torch_other")
    shutil.copytree(os.path.join(other, "src", "repro_torch"), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for base, _, files in os.walk(pkg):
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(base, fn)
                with open(path) as f:
                    src = f.read()
                with open(path, "w") as f:
                    f.write(re.sub(r"\brepro_torch\b", "repro_torch_other",
                                   src))


def setup(pkg: str, kind: str, named=None):
    """One step of ``pkg`` on ``named``'s weights (drawn when None):
    ``smollm_decode`` (B = 8, flash_paged), ``smollm_verify`` (B = 8, W =
    5: the speculative lane's k = 4) or ``deepseek_decode`` (the router's
    cut, 1 dense + 3 MoE layers, B = 8, flash_paged)."""
    import torch
    cfgs = importlib.import_module(pkg + ".configs")
    C = importlib.import_module(pkg + ".models.config")
    MD = importlib.import_module(pkg + ".models.model")
    SL = importlib.import_module(pkg + ".serving.serve_lib")
    if kind.startswith("deepseek"):
        cfg = cfgs.get_config("deepseek-v2-236b").replace(
            groups=(C.LayerGroup((C.BlockSpec("mla", "dense"),), 1),
                    C.LayerGroup((C.BlockSpec("mla", "moe"),), 3)),
            decode_impl="flash_paged")
    else:
        cfg = cfgs.get_config("smollm-360m").replace(
            attn_impl="pallas", decode_impl="flash_paged")
    if named is None:
        params = MD.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    else:
        params = MD.Model(cfg, "meta").to_empty(device="cuda")
        params.load_state_dict(named)
    mb = 512 // 16
    cache = MD.init_paged_cache(cfg, len(LENS), 512, 1 + len(LENS) * mb, 16,
                                "cuda")
    cache["tbl"].copy_(1 + torch.arange(len(LENS) * mb, dtype=torch.int32)
                       .reshape(len(LENS), mb))
    pre = SL.make_prefill_paged_fn(cfg, fresh=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for b, n in enumerate(LENS):
        toks = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                             device="cuda", dtype=torch.int32)
        pre(params, toks, torch.tensor([n], dtype=torch.int32, device="cuda"),
            torch.zeros(1, dtype=torch.int32, device="cuda"),
            cache["tbl"][b:b + 1], cache)
    W = 5 if kind.endswith("verify") else 1
    fn = (SL.make_verify_fn if W > 1 else SL.make_decode_fn)(cfg)
    pos0 = torch.tensor(LENS, dtype=torch.int32, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (len(LENS), W), generator=gen,
                         device="cuda", dtype=torch.int32)

    def step():
        cache["pos"] = pos0
        return fn(params, toks, cache)
    return params, step


def block(step, reps: int = 10) -> float:
    import torch
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="the other checkout (its root)")
    ap.add_argument("--blocks", type=int, default=16)
    ap.add_argument("--kinds",
                    default="smollm_decode,smollm_verify,deepseek_decode")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ab_steps: no CUDA device is available", file=sys.stderr)
        return 2
    tmp = tempfile.mkdtemp(prefix="ab-decode-")
    try:
        renamed_copy(args.other, tmp)
        sys.path.insert(0, tmp)
        sys.path.insert(0, os.path.join(ROOT, "src"))
        out = {"card": torch.cuda.get_device_name(0)}
        for kind in args.kinds.split(","):
            with torch.no_grad():
                params, this = setup("repro_torch", kind)
                _, other = setup("repro_torch_other", kind,
                                 params.state_dict())
                if not torch.equal(this()[0], other()[0]):
                    print(f"ab_steps: {kind}: the two trees' tokens "
                          f"differ", file=sys.stderr)
                    return 1
                for _ in range(5):
                    this(), other()
                res = {"other": [], "this": []}
                for i in range(args.blocks):
                    order = [("other", other), ("this", this)]
                    for name, fn in (order if i % 2 == 0 else order[::-1]):
                        res[name].append(block(fn))
            del params, this, other
            import gc
            gc.collect()
            torch.cuda.empty_cache()
            wins = sum(t < o for t, o in zip(res["this"], res["other"]))
            out[kind] = {"blocks_ms": res, "this_faster_blocks": wins,
                         "median_ms": {k: statistics.median(v)
                                       for k, v in res.items()}}
            print(json.dumps({kind: out[kind]}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
