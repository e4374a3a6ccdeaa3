"""Training launcher of the port: checkpoint/restart, straggler monitor,
failure injection (``repro.launch.train``'s twin on one device).

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch llama3.2-1b --reduced --steps 8 --batch 2 --seq 32
  python -m repro_torch.launch.train --arch smollm-360m --steps 12 \\
      --batch 8 --seq 512 --ckpt-dir /tmp/ckpt --ckpt-every 6

Fault-tolerance drill: run with ``--fail-at-step N``; the process exits
with code 17 at step N, and re-running the same command resumes from the
latest complete checkpoint (``meta["next_step"]``).  The weights start
from ``init_params`` on a ``torch.Generator`` seeded 0 on the device (or
from a reference tree handed to ``main(init=...)``); the cross-attention
context of an encoder-decoder or vision config is drawn from the same
generator.  Checkpoints are the
reference's layout and keys (``checkpoint/ckpt.py``), so a run resumes
from a checkpoint of either package.  Not ported: ``--production-mesh``
(multi-GPU).
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.bridge import (opt_state_from_jax, opt_state_to_jax,
                                params_from_jax, params_to_jax, ref_tree)
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_config, get_reduced
from repro_torch.data.pipeline import TokenStream
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import model as MD
from repro_torch.training import train_lib
from repro_torch.training.optimizer import AdamWConfig, init_opt_state


class StragglerMonitor:
    """Per-step wall-time EWMA; flags steps slower than k x the EWMA — on a
    real cluster this feeds the controller that reschedules slow hosts."""

    def __init__(self, k: float = 2.0):
        self.ewma = None
        self.k = k
        self.flagged = []

    def observe(self, step: int, dt: float):
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = dt > self.k * self.ewma
        if slow:
            self.flagged.append((step, dt, self.ewma))
        self.ewma = 0.9 * self.ewma + 0.1 * dt
        return slow


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, *, init=None, stats=None):
    """Train; returns the losses of the steps this run took.  ``init``: a
    reference parameter tree to start from; ``stats``: a dict that
    receives the seconds of each step, checkpoint writes and the
    restore."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--fail-at-step", type=int, default=-1)
    ap.add_argument("--moe-impl", default="ep")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card; raises without one) or 'cpu'")
    args = ap.parse_args(argv)
    stats = {} if stats is None else stats
    stats.update(step_s=[], save_s=[], restore_s=None)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    dev = resolve_device(args.device)
    print(f"arch={cfg.name} device={dev} blocks={cfg.n_blocks}")

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(1, args.steps // 10))
    step_fn = train_lib.make_step_fn(cfg, opt_cfg, moe_impl=args.moe_impl)

    gen = torch.Generator(device=dev).manual_seed(0)
    params = MD.init_params(cfg, gen, dev)
    if init is not None:
        params.load_state_dict(params_from_jax(init))
    opt_state = init_opt_state(params)

    start = 0
    if args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            t0 = time.perf_counter()
            target = (params_to_jax(params, cfg),
                      opt_state_to_jax(opt_state, cfg))
            (ptree, otree), meta = restore_checkpoint(args.ckpt_dir, last,
                                                      target)
            params.load_state_dict(params_from_jax(ptree))
            opt_state = opt_state_from_jax(otree, dev)
            _sync(dev)
            stats["restore_s"] = time.perf_counter() - t0
            start = meta.get("next_step", last)
            print(f"restored checkpoint step={last}, resuming at {start}")

    stream = TokenStream(cfg.vocab_size, args.batch, args.seq)
    monitor = StragglerMonitor()
    cross = None
    if cfg.cross_ctx_len:
        cross = torch.randn((args.batch, cfg.cross_ctx_len, cfg.d_model),
                            generator=gen, device=dev,
                            dtype=torch.float32).to(torch_dtype(cfg.dtype))
    losses = []
    for step in range(start, args.steps):
        if step == args.fail_at_step:
            print(f"!! injected failure at step {step} — aborting "
                  "(restart resumes from last checkpoint)")
            sys.exit(17)
        toks, labels = stream.batch_at(step)
        t0 = time.perf_counter()
        fn_args = [params, opt_state, torch.from_numpy(toks),
                   torch.from_numpy(labels)]
        if cross is not None:
            fn_args.append(cross)
        params, opt_state, metrics = step_fn(*fn_args)
        loss = float(metrics["loss"])
        losses.append(loss)
        dt = time.perf_counter() - t0
        stats["step_s"].append(dt)
        if monitor.observe(step, dt):
            print(f"  [straggler] step {step} took {dt:.2f}s "
                  f"(ewma {monitor.ewma:.2f}s)")
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"dt={dt*1e3:.0f}ms")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            t0 = time.perf_counter()
            path = save_checkpoint(
                args.ckpt_dir, step + 1,
                (ref_tree(params, cfg), opt_state_to_jax(opt_state, cfg,
                                                         numpy=False)),
                {"next_step": step + 1, "loss": loss})
            stats["save_s"].append(time.perf_counter() - t0)
            print(f"  checkpoint -> {path}")
    print(f"done: first-loss={losses[0]:.4f} last-loss={losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
