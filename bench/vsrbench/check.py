"""The comparison that decides ``correct``.

Every request the run submitted is judged by what it says:

* ``unanswered``: no answer came (within the drain after the window), or
  the answer is an error;
* ``outcome_wrong``: the router blocked a request with no SSN, served one
  with an SSN, or served it from another model than the configuration's;
* ``answer_wrong``: a served answer whose token count is not the mix's
  ``answer_tokens``, whose content does not show the member's tokens, or
  whose prompt, as the reference tokenizes it, is not the prompt the
  member served;
* ``logit_gap`` and ``mean_logit_gap``: over a sample drawn from the seed
  of the served requests of the window, with the longest prompt in it,
  the plain reference's forward pass over each prompt and its served
  tokens; the widest, and the mean, distance by which a served token's
  logit lies below the reference's best at its position.  A cell compares
  those its ``limits/<cell>.json`` names.

The reference runs after the window has closed and the program's state is
freed, drawing its weights again from the seed block by block.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from reference.common import Exact, as_ids, draw_block, hash_tokens, token_gaps

_CONTENT = re.compile(r"^\[(?P<arch>[^\]]+)\] (?P<n>\d+) tokens: ?(?P<toks>.*)$")


def vocab_of(config: dict) -> int:
    return int(config.get("vocab_size", config.get("padded_vocab_size", 0)))


def prompt_ids(text: str, config: dict, cap: int) -> Tuple[int, ...]:
    return tuple(hash_tokens(text, vocab_of(config), cap))


def _content_ok(content: str, tokens: List[int]) -> bool:
    m = _CONTENT.match(content)
    if m is None or int(m.group("n")) != len(tokens):
        return False
    shown = [int(t) for t in m.group("toks").split()]
    return shown == tokens[:len(shown)] and len(shown) == min(10, len(tokens))


def judge_answers(run, served: Dict[Tuple[int, ...], List[int]],
                  model_name: str) -> Dict[str, int]:
    """Counts of unanswered, wrongly routed and malformed answers over
    every request the run submitted."""
    n_new = int(run.mix["answer_tokens"])
    unanswered = outcome_wrong = answer_wrong = 0
    for rec in run.requests.values():
        if not rec.answered:
            unanswered += 1
            continue
        if rec.blocked != rec.pii or \
                (not rec.blocked and rec.model != model_name):
            outcome_wrong += 1
            continue
        if rec.blocked:
            continue
        toks = served.get(prompt_ids(rec.text, run.config, run.cap))
        if toks is None or len(toks) != n_new or \
                rec.usage.get("completion_tokens") != n_new or \
                not _content_ok(rec.content, toks):
            answer_wrong += 1
    return {"unanswered": unanswered, "outcome_wrong": outcome_wrong,
            "answer_wrong": answer_wrong}


def sample(run, served, k: int) -> List[Tuple[Tuple[int, ...], List[int]]]:
    """``k`` served requests of the window (prompt ids, served tokens): the
    one with the longest prompt, and the rest drawn from the seed."""
    cands = []
    for rec in run.in_window():
        if rec.answered and not rec.blocked:
            ids = prompt_ids(rec.text, run.config, run.cap)
            if ids in served and len(served[ids]) == int(
                    run.mix["answer_tokens"]):
                cands.append((rec.index, ids, served[ids]))
    if not cands:
        return []
    cands.sort(key=lambda c: (-len(c[1]), c[0]))
    rest = cands[1:]
    rng = np.random.default_rng([int(run.seed) % (1 << 64), 7])
    pick = [rest[i] for i in sorted(rng.choice(len(rest),
                                               size=min(k - 1, len(rest)),
                                               replace=False))] if rest else []
    return [(ids, toks) for _, ids, toks in [cands[0]] + pick]


def reference_logits(family, config: dict, seed: int, picked, device,
                     arith=None) -> List[torch.Tensor]:
    """The reference's logits at the positions that sampled each served
    token, with the weights drawn again from ``seed`` block by block."""
    blocks = family.blocks(config)
    seqs, spans = [], []
    for ids, toks in picked:
        seqs.append(as_ids(list(ids) + list(toks[:-1]), device))
        spans.append((len(ids) - 1, len(ids) - 1 + len(toks)))
    return family.forward(config,
                          lambda i: draw_block(blocks[i], seed, i, device),
                          seqs, spans, arith or Exact())


def logit_gaps(family, config: dict, seed: int, picked, device
               ) -> Dict[str, Optional[float]]:
    """Over every served token of the sample, the widest (``logit_gap``)
    and the mean (``mean_logit_gap``) distance of its logit below the
    reference's best at its position (None without a sample)."""
    if not picked:
        return {"logit_gap": None, "mean_logit_gap": None}
    logits = reference_logits(family, config, seed, picked, device)
    g = torch.cat([token_gaps(lg, toks)
                   for lg, (_, toks) in zip(logits, picked)]).float()
    return {"logit_gap": float(g.max()), "mean_logit_gap": float(g.mean())}


def verdict(checks: Dict[str, Tuple[Optional[float], float]]) -> bool:
    """Every number within its limit (a number that is missing fails)."""
    return all(v is not None and v <= lim for v, lim in checks.values())
