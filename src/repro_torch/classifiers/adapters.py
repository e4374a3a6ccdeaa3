"""Encoder signal-adapter training with a persistent checkpoint cache.

Closes the ROADMAP item: at startup (``serve.py --train-adapters``) the
encoder backend's LoRA signal adapters train on synthetic task data
(distilling the deterministic lexicon tier, as
``examples/train_classifiers.py`` does interactively), and the trained
adapters persist through ``checkpoint/ckpt.py`` keyed by
(task, tokenizer vocabulary, encoder dimensions) — a warm restart loads
them in milliseconds instead of re-training.

Key layout:  <cache_dir>/<task>-v<vocab>-L<layers>-d<dmodel>-r<rank>-s<len>-c<classes>/step_00000000/
The key pins everything the weights depend on, so changing the encoder
config or tokenizer silently invalidates (misses) the old entries
instead of loading incompatible arrays.

The port of ``repro.classifiers.adapters``: the checkpoints are written and
read by the port's ``checkpoint/ckpt.py`` in the reference's layout, so a
cache written by either package loads in the other.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.classifiers import tokenizer as TOK
from repro_torch.classifiers.encoder import (EncoderBackend, EncoderConfig,
                                             TASK_CLASSES, TASK_LABELS,
                                             train_adapter)
from repro_torch.data.pipeline import router_corpus

# tasks with synthetic supervision available (router_corpus classes)
TRAINABLE_TASKS = ("domain", "jailbreak", "fact_check")


def make_dataset(task: str, corpus: Dict[str, list]
                 ) -> Tuple[list, np.ndarray]:
    """Synthetic labeled texts for one signal task."""
    texts, labels = [], []
    if task == "fact_check":
        for t in corpus["factual"]:
            texts.append(t)
            labels.append(1)                      # NEEDS_FACT_CHECK
        for t in corpus["creative"]:
            texts.append(t)
            labels.append(0)
    elif task == "jailbreak":
        for t in corpus["jailbreak"]:
            texts.append(t)
            labels.append(2)                      # JAILBREAK
        for t in corpus["benign"] + corpus["math"]:
            texts.append(t)
            labels.append(0)                      # BENIGN
    elif task == "domain":
        lab = TASK_LABELS["domain"]
        for t in corpus["math"]:
            texts.append(t)
            labels.append(lab.index("math"))
        for t in corpus["code"]:
            texts.append(t)
            labels.append(lab.index("computer science"))
        for t in corpus["creative"]:
            texts.append(t)
            labels.append(lab.index("other"))
    else:
        raise KeyError(f"no synthetic dataset for task {task!r}")
    return texts, np.asarray(labels)


def adapter_cache_key(task: str, cfg: EncoderConfig) -> str:
    """Everything the adapter weights depend on: the task, the tokenizer
    vocabulary, and the encoder/LoRA dimensions."""
    return (f"{task}-v{TOK.VOCAB}-L{cfg.n_layers}-d{cfg.d_model}"
            f"-r{cfg.lora_rank}-s{cfg.max_len}-c{TASK_CLASSES[task]}")


def train_or_load_adapters(backend: EncoderBackend,
                           tasks: Sequence[str] = TRAINABLE_TASKS,
                           cache_dir: Optional[str] = None, *,
                           steps: int = 60, n_per_class: int = 24,
                           seed: int = 0) -> Dict[str, str]:
    """Train (or restore from cache) the signal adapters for ``tasks`` on
    ``backend``, marking them trained so learned signals leave the hash
    tier.  Returns {task: "trained" | "loaded"}."""
    from repro_torch.checkpoint.ckpt import (latest_step,
                                             restore_checkpoint,
                                             save_checkpoint)
    report: Dict[str, str] = {}
    corpus = None
    for task in tasks:
        ck_dir = (os.path.join(cache_dir, adapter_cache_key(task,
                                                            backend.cfg))
                  if cache_dir else None)
        step = latest_step(ck_dir) if ck_dir else None
        if step is not None:
            restored, meta = restore_checkpoint(ck_dir, step,
                                                backend.adapters[task])
            assert meta.get("task", task) == task, meta
            backend.adapters[task] = {k: v.to(backend.device)
                                      for k, v in restored.items()}
            report[task] = "loaded"
        else:
            if corpus is None:
                corpus = router_corpus(n_per_class=n_per_class, seed=seed)
            texts, labels = make_dataset(task, corpus)
            ids, lens = TOK.encode_batch(texts, backend.cfg.max_len)
            backend.adapters[task], loss = train_adapter(
                backend.cfg, backend.params, backend.adapters, task,
                torch.from_numpy(ids), torch.from_numpy(lens),
                torch.from_numpy(labels), steps=steps)
            if ck_dir:
                save_checkpoint(ck_dir, 0, backend.adapters[task],
                                meta={"task": task, "vocab": TOK.VOCAB,
                                      "loss": float(loss),
                                      "steps": steps,
                                      "n_per_class": n_per_class})
            report[task] = "trained"
        backend.trained.add(task)
    return report
