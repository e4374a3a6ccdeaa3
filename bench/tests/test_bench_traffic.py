"""The traffic generator: the same seed gives the same requests, seeds
change the order of the work and not its amount."""

import math

import numpy as np
import pytest

import bench_tiny  # noqa: F401
from vsrbench import spec as S
from vsrbench.traffic import (SSN_WORDS, Traffic, lexicon, prompt_cap,
                              warmup_requests)

MIXES = {m: S.load_json(S.BENCH / "mixes" / f"{m}.json")
         for m in ("decode", "rag")}
BIG = 2 ** 31 + 12345


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_bench_same_seed_same_requests(mix):
    a = Traffic(MIXES[mix], BIG).requests(70)
    b = Traffic(MIXES[mix], BIG).requests(70)
    assert a == b
    c = Traffic(MIXES[mix], BIG + 1).requests(70)
    assert [r.text for r in a] != [r.text for r in c]


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_bench_seeds_share_the_sizes(mix):
    m = MIXES[mix]
    n = m["block"] * 2
    sizes = [sorted(r.words for r in Traffic(m, s).requests(n))
             for s in (1, 2, BIG)]
    assert sizes[0] == sizes[1] == sizes[2]
    lo = m["prompt_words"]["low"] + m.get("question_words", {}).get("low", 0)
    hi = m["prompt_words"]["high"] + m.get("question_words", {}).get("high",
                                                                     0)
    assert lo <= sizes[0][0] and sizes[0][-1] <= hi


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_bench_requests_are_words_and_pii_is_one_in_a_group(mix):
    m = MIXES[mix]
    t = Traffic(m, 7)
    reqs = t.requests(m["pii_every"] * 5)
    for g in range(5):
        grp = reqs[g * m["pii_every"]:(g + 1) * m["pii_every"]]
        assert sum(r.pii for r in grp) == 1
    lex = set(lexicon())
    for r in reqs:
        words = r.text.split()
        assert len(words) == r.words
        body = words[len(SSN_WORDS):] if r.pii else words
        assert set(body) <= lex
        assert (tuple(words[:4]) == SSN_WORDS) == r.pii


def test_bench_open_loop_gaps_have_the_rate():
    m = MIXES["rag"]
    t = Traffic(m, BIG)
    n = m["block"] * 3
    due = [t.due_s(i) for i in range(n + 1)]
    assert due[0] == 0.0 and all(b > a for a, b in zip(due, due[1:]))
    assert math.isclose(due[n] / n, 1.0 / m["rate_per_s"], rel_tol=1e-9)
    assert Traffic(MIXES["decode"], 1).due_s(5) == 0.0


def test_bench_warmup_requests_and_cap():
    m = MIXES["decode"]
    w = warmup_requests(m, 3, 5)
    assert len(w) == 3 and all(r.pii and r.index < 0 for r in w)
    assert all(len(r.text.split()) == m["prompt_words"]["high"] for r in w)
    assert prompt_cap(m) == m["max_seq"] - m["answer_tokens"] - 1 == 271
    assert prompt_cap(MIXES["rag"]) == 4095
    assert m["max_seq"] % 16 == 0 and MIXES["rag"]["max_seq"] % 16 == 0


def test_bench_open_loop_gaps_are_exponential_mid_quantiles():
    m = MIXES["rag"]
    n = m["block"]
    law = -np.log1p(-(np.arange(n) + 0.5) / n)
    law = np.sort(law / law.mean() / m["rate_per_s"])
    orders = []
    for seed in (3, BIG):
        t = Traffic(m, seed)
        due = [t.due_s(i) for i in range(n + 1)]
        gaps = np.diff(due)
        assert np.allclose(np.sort(gaps), law, rtol=1e-9)
        orders.append(np.argsort(gaps))
    assert not np.array_equal(*orders)
    assert law[-1] > 10 * law[0]


def test_bench_open_loop_window_holds_the_same_requests_under_every_seed():
    """The RAG window spans whole blocks, so every seed has the same number
    of requests due in it, with the same sizes."""
    m = MIXES["rag"]
    secs = S.load_json(S.ROOT / "BENCHMARK.json")["run_seconds"]
    n = round(m["rate_per_s"] * secs)
    assert n % m["block"] == 0 and n % m["pii_every"] == 0
    sizes = []
    for seed in (1, 2, 3, BIG):
        t = Traffic(m, seed)
        assert t.due_s(n - 1) < secs <= t.due_s(n)
        sizes.append(sorted(t.prompt_words(i) for i in range(n)))
    assert all(s == sizes[0] for s in sizes)
