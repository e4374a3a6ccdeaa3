"""Readings that set a cell's ``logit_gap`` and ``mean_logit_gap`` limits,
on the card, in one process: the program's token gaps (widest, mean, 99th
percentile, share not the reference's first choice) on each of a dozen
seeds or more, and the control's (the reference in fp8,
``reference.common.FP8``) and a witness's (the reference's linear maps in
bf16) on some of them, each over a window of the cell's own traffic and
load and a sample as large as a run's.

    python3 bench/tools/readings.py --workload deepseek-v2-stage.decode \
        --seeds 11,12,13 --control-seeds 11,12 --witness-seeds 13 --seconds 15 \
        --out readings.jsonl

The system is built once; each seed draws its weights into it again and
serves its own traffic.  The program stays on the card while the
reference runs, so each line also gives the reference's seconds.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent.parent / "src")]


def _stats(per_request):
    """Token gaps of the sampled requests: the widest (and each request's),
    the mean, the 99th percentile, and the share of tokens that are not the
    reference's first choice."""
    import torch
    g = torch.cat(per_request).float()
    return dict(widest=float(g.max()), mean=float(g.mean()),
                p99=float(torch.quantile(g, 0.99)),
                not_first=float((g > 0).float().mean()),
                widest_each=[float(x.max()) for x in per_request])


class BF16:
    """A witness: the reference's linear maps in bf16 (inputs and weights
    rounded to bf16, products accumulated as the card's bf16 GEMMs do),
    everything else in float32."""

    name = "bf16"

    def prep(self, w):
        import torch
        return w.to(torch.bfloat16)

    def act(self, x):
        import torch
        return x.to(torch.bfloat16)

    def mm(self, x, w):
        return (self.act(x) @ self.prep(w)).float()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--witness-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    from reference.common import FP8, token_gaps
    from vsrbench import check as C
    from vsrbench import harness as H
    from vsrbench import spec as S

    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    witness = {int(s) for s in args.witness_seeds.split(",") if s}
    cell = S.resolve(args.workload)
    t0 = time.perf_counter()
    system = H.build(cell, seeds[0], "cuda")
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    out = open(args.out, "a") if args.out else None
    for seed in seeds:
        if seed != seeds[0]:
            system.load_weights(seed)
            system.served.clear()
        run = H.serve(system, cell, seed, args.seconds, False,
                      time.perf_counter())
        counts = C.judge_answers(run, dict(system.served), system.model_name)
        picked = C.sample(run, dict(system.served),
                          int(cell.mix["check_sample"]))
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        ref = C.reference_logits(system.family, system.config, seed, picked,
                                 system.device)
        line = dict(workload=args.workload, seed=seed, counts=counts,
                    requests=len(run.requests), sampled=len(picked),
                    tokens=sum(len(t) for _, t in picked),
                    reference_s=time.perf_counter() - t1)
        line["program"] = _stats([token_gaps(lg, toks)
                                  for lg, (_, toks) in zip(ref, picked)])
        for name, ar, seeds_of in (("control", FP8(), control),
                                   ("witness", BF16(), witness)):
            if seed in seeds_of:
                other = C.reference_logits(system.family, system.config,
                                           seed, picked, system.device, ar)
                line[name] = _stats([token_gaps(r, o.argmax(1).tolist())
                                     for r, o in zip(ref, other)])
                del other
        del ref
        torch.cuda.empty_cache()
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
    system.release()


if __name__ == "__main__":
    main()
