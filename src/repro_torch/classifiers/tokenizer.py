"""Deterministic hash tokenizer (no external vocab files), a copy of
``repro.classifiers.tokenizer``.

Word-level with hashed sub-word fallback: frequent-word ids are stable under
the hash, unknown words decompose into hashed character 4-gram pieces —
enough structure for the encoder to learn lexical tasks on synthetic data.
"""

from __future__ import annotations

import hashlib
import re
from typing import List, Tuple

import numpy as np

VOCAB = 8192
CLS, SEP, PAD, MSK = 0, 1, 2, 3
_RESERVED = 8
_WORD = re.compile(r"[\w']+|[^\w\s]")


def _h(s: str) -> int:
    d = hashlib.blake2s(s.encode(), digest_size=4).digest()
    return _RESERVED + int.from_bytes(d, "little") % (VOCAB - _RESERVED)


def encode(text: str, max_len: int = 128) -> Tuple[np.ndarray, int]:
    """Returns (ids (max_len,), true_length). [CLS] text [SEP] + PAD."""
    ids = [CLS]
    for w in _WORD.findall(text.lower()):
        if len(ids) >= max_len - 1:
            break
        if len(w) <= 8:
            ids.append(_h(w))
        else:
            for i in range(0, len(w), 4):
                ids.append(_h("##" + w[i:i + 4]))
                if len(ids) >= max_len - 1:
                    break
    ids.append(SEP)
    n = len(ids)
    ids = ids + [PAD] * (max_len - n)
    return np.asarray(ids[:max_len], np.int32), min(n, max_len)


def encode_pair(a: str, b: str, max_len: int = 128):
    """[CLS] a [SEP] b [SEP] with segment ids (NLI cross-encoder input)."""
    ia, _ = encode(a, max_len)
    la = int(np.argmax(ia == SEP)) + 1
    ids = list(ia[:la])
    seg = [0] * la
    for w in _WORD.findall(b.lower()):
        if len(ids) >= max_len - 1:
            break
        ids.append(_h(w))
        seg.append(1)
    ids.append(SEP)
    seg.append(1)
    n = len(ids)
    ids += [PAD] * (max_len - n)
    seg += [0] * (max_len - n)
    return (np.asarray(ids[:max_len], np.int32),
            np.asarray(seg[:max_len], np.int32), min(n, max_len))


def encode_batch(texts: List[str], max_len: int = 128):
    ids = np.zeros((len(texts), max_len), np.int32)
    lens = np.zeros((len(texts),), np.int32)
    for i, t in enumerate(texts):
        ids[i], lens[i] = encode(t, max_len)
    return ids, lens
