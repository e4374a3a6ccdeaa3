"""Kernel 4 (paged MLA decode) against its roofline: the least time the
chip could take for the traced window's launches, over their device time
(``torch.profiler``, by the names in ``roofline/kernel_mla_decode.py``).

The work is counted from the traced batches' served requests at their real
lengths: a request of prompt n and G answer tokens reads n + t keys at
decode step t = 1..G-1 in each MLA layer.  Each launch's rows come from its
grid (its third dimension); the row-launches that no request's step
accounts for are freed slots, one key each.  Every launch is bound by
memory at these widths, so the bound is taken over the summed work."""

from roofline import bound_s
from roofline.kernel_mla_decode import NAMES, fixed_work, key_work
from vsrbench.readers import kernel_seconds, prompt_tokens, traced_requests


def read(run):
    t = run.trace
    if t is None:
        return None
    ev = t.kernels(NAMES)
    recs = traced_requests(run)
    secs = kernel_seconds(ev)
    if not ev or not recs or secs <= 0 or any(e.grid is None for e in ev):
        return None
    cfg = run.config
    H, r, rh = (cfg["num_attention_heads"], cfg["kv_lora_rank"],
                cfg["qk_rope_head_dim"])
    layers = cfg["num_hidden_layers"]
    steps = int(run.mix["answer_tokens"]) - 1
    max_blocks = int(run.mix["max_seq"]) // 16
    flops = nbytes = 0.0
    row_launches = 0
    for e in ev:
        f, b = fixed_work(e.grid[2], H, r, rh, max_blocks)
        flops, nbytes = flops + f, nbytes + b
        row_launches += e.grid[2]
    keys = live_rows = 0
    for rec in recs:
        n = prompt_tokens(run, rec)
        keys += layers * (steps * n + steps * (steps + 1) // 2)
        live_rows += layers * steps
    if live_rows > row_launches:
        return None
    f, b = key_work(keys + row_launches - live_rows, H, r, rh)
    return 100.0 * bound_s(flops + f, nbytes + b) / secs
