"""The rate sweep of an open-loop cell, on the card, in one process: the
cell's traffic at each rate for a window, and for each the latency
percentiles, the mean batch, and whether the queue grew (the latency of
the window's last third against its first).

    python3 bench/tools/sweep.py --workload glm4-9b.rag --seed 5 \
        --rates 2,3,4,5 --seconds 40

The highest rate whose last third's median stays within 1.25x of its
first third's is the knee (the queue does not grow); the cell's rate is
about four fifths of it.
"""

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent.parent / "src")]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    from vsrbench import check as C
    from vsrbench import harness as H
    from vsrbench import spec as S
    from vsrbench.stats import percentile

    cell = S.resolve(args.workload)
    system = H.build(cell, args.seed, "cuda")
    out = open(args.out, "a") if args.out else None
    for rate in (float(r) for r in args.rates.split(",")):
        c = dataclasses.replace(cell, mix=dict(cell.mix, rate_per_s=rate))
        system.served.clear()
        run = H.serve(system, c, args.seed, args.seconds, False,
                      time.perf_counter())
        recs = sorted(run.in_window(), key=lambda r: r.due)
        lat = [r.latency_s * 1e3 for r in recs]
        third = max(1, len(recs) // 3)
        first, last = lat[:third], lat[-third:]
        batches = [b for b in run.batches
                   if run.t_open <= b.start < run.t_close]
        line = dict(
            workload=args.workload, rate=rate, requests=len(recs),
            p50_ms=percentile(lat, 50), p90_ms=percentile(lat, 90),
            first_third_p50_ms=percentile(first, 50),
            last_third_p50_ms=percentile(last, 50),
            mean_batch=sum(len(b.indices) for b in batches) / max(
                1, len(batches)),
            lateness_s=run.lateness_s,
            counts=C.judge_answers(run, dict(system.served),
                                   system.model_name))
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
        if line["last_third_p50_ms"] > 2 * line["first_third_p50_ms"]:
            break                   # the queue grows: higher rates only more
    system.release()


if __name__ == "__main__":
    main()
