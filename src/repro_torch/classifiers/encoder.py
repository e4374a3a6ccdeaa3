"""MoM encoder substrate (§9, §11): one frozen bidirectional encoder +
per-task LoRA adapters + task heads, with *batched* multi-task inference.
The port of ``repro.classifiers.encoder`` (adapter training waits for the
training slice).

Architecture = ModernBERT-class: RoPE, GeGLU, alternating global / local
sliding-window attention (1 global : 2 local), padding masks, CLS pooling
for sequence tasks, per-token states for PII tagging, pair encoding for
NLI, and mean-pool + Matryoshka truncation for embeddings.

Batched mode folds the tasks into the batch dimension: the frozen base
runs once per *batch* instead of once per *task*, and the per-row adapter
delta on the q and v projections goes through ``kernels/multi_lora`` (the
hand-written BGMV kernel on the card, its plain version on the CPU).  The
rest keeps the reference's op order in float32: base ``h @ w`` by
``torch.matmul`` then ``+ delta``; attention as plain tensor ops with dense
(B, H, S, S) float32 logits.

Parameters are plain dicts of tensors keyed like the reference's pytree
(``params["layers"][i]["wq"]``, ``adapters[task]["a_q"]``), so the weight
bridge maps them leaf for leaf.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.classifiers import tokenizer as TOK
from repro_torch.classifiers.backend import (ClassifierBackend, DOMAIN_LABELS,
                                             PII_LABELS, HashBackend)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.multi_lora import multi_lora
from repro_torch.models.layers import apply_rope, rms_norm, rope_tables

TASKS = ("domain", "jailbreak", "fact_check", "user_feedback", "modality",
         "nli", "detector")
TASK_CLASSES = {"domain": len(DOMAIN_LABELS), "jailbreak": 3,
                "fact_check": 2, "user_feedback": 5, "modality": 4,
                "nli": 3, "detector": 2}
TASK_LABELS = {
    "domain": DOMAIN_LABELS,
    "jailbreak": ["BENIGN", "INJECTION", "JAILBREAK"],
    "fact_check": ["NO_FACT_CHECK", "NEEDS_FACT_CHECK"],
    "user_feedback": ["satisfied", "dissatisfied", "clarification",
                      "alternative", "none"],
    "modality": ["autoregressive", "diffusion", "both", "audio"],
    "nli": ["ENTAILMENT", "CONTRADICTION", "NEUTRAL"],
    "detector": ["SUPPORTED", "HALLUCINATED"],
}
PII_TAGS = ["O"] + [f"B-{l}" for l in PII_LABELS] + \
    [f"I-{l}" for l in PII_LABELS]
LORA_KEYS = ("a_q", "b_q", "a_v", "b_v")


@dataclass(frozen=True)
class EncoderConfig:
    n_layers: int = 4
    d_model: int = 128
    n_heads: int = 4
    d_ff: int = 256
    vocab: int = TOK.VOCAB
    max_len: int = 128
    local_window: int = 128
    global_every: int = 3           # ModernBERT: 1 global : 2 local
    rope_theta_global: float = 160_000.0
    rope_theta_local: float = 10_000.0
    lora_rank: int = 16
    embed_dim: int = 128            # matryoshka base dim


MODERNBERT_BASE_32K = EncoderConfig(
    n_layers=22, d_model=768, n_heads=12, d_ff=1152, max_len=32768,
    lora_rank=32, embed_dim=768)
SMALL = EncoderConfig(n_layers=2, d_model=64, n_heads=4, d_ff=128,
                      max_len=64, lora_rank=8, embed_dim=64)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _normal(gen, shape, device, scale):
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32) * scale


def _dense(gen, shape, device, scale: Optional[float] = None):
    """``layers.dense_init``'s law: N(0, 1/fan_in), or N(0, scale^2)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return _normal(gen, shape, device,
                   scale if scale is not None else 1.0 / math.sqrt(fan_in))


def init_encoder(cfg: EncoderConfig, generator: torch.Generator,
                 device: DeviceLike = "cuda") -> dict:
    """Random float32 encoder weights drawn from ``generator`` on
    ``device`` (the reference's shapes and laws, not its numbers)."""
    dev = resolve_device(device)
    d = cfg.d_model
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "norm1": torch.ones((d,), device=dev),
            "wq": _dense(generator, (d, d), dev),
            "wk": _dense(generator, (d, d), dev),
            "wv": _dense(generator, (d, d), dev),
            "wo": _dense(generator, (d, d), dev),
            "norm2": torch.ones((d,), device=dev),
            "w_in": _dense(generator, (d, 2 * cfg.d_ff), dev),
            "w_out": _dense(generator, (cfg.d_ff, d), dev),
        })
    return {
        "embed": _dense(generator, (cfg.vocab, d), dev, scale=0.02),
        "seg_embed": _dense(generator, (2, d), dev, scale=0.02),
        "layers": layers,
        "final_norm": torch.ones((d,), device=dev),
    }


def init_adapters(cfg: EncoderConfig, generator: torch.Generator,
                  device: DeviceLike = "cuda",
                  tasks: Sequence[str] = TASKS) -> dict:
    """Per-task LoRA (q and v projections, every layer) + task heads, and
    the ``pii`` token tagger.  B starts at zero, as in the reference."""
    dev = resolve_device(device)
    d, r, L = cfg.d_model, cfg.lora_rank, cfg.n_layers
    out = {}
    for t in list(tasks) + ["pii"]:
        n_out = len(PII_TAGS) if t == "pii" else TASK_CLASSES[t]
        out[t] = {
            "a_q": _normal(generator, (L, d, r), dev, 0.02),
            "b_q": torch.zeros((L, r, d), device=dev),
            "a_v": _normal(generator, (L, d, r), dev, 0.02),
            "b_v": torch.zeros((L, r, d), device=dev),
            "head": _dense(generator, (d, n_out), dev, scale=0.02),
        }
    return out


def adapter_params(cfg: EncoderConfig) -> int:
    return cfg.n_layers * 4 * cfg.d_model * cfg.lora_rank


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _attention(cfg, lp, x, lens, layer_idx, lora=None, row_ids=None):
    """``row_ids``: (B*S,) int32 task id of every token row for the
    stacked adapters (batched multi-task), or None."""
    B, S, d = x.shape
    H = cfg.n_heads
    hd = d // H
    is_global = (layer_idx % cfg.global_every) == 0
    theta = cfg.rope_theta_global if is_global else cfg.rope_theta_local

    h = rms_norm(x, lp["norm1"], 1e-6)

    def proj(w, name):
        y = h @ w
        if lora is not None and name in ("q", "v"):
            a = lora[f"a_{name}"]                    # (d,r) or (T,d,r)
            b = lora[f"b_{name}"]
            if row_ids is None:
                y = y + (h @ a) @ b
            else:  # batched multi-task: per-row adapter (kernel 6)
                y = y + multi_lora(h.reshape(B * S, d), a, b,
                                   row_ids).reshape(B, S, -1)
        return y.reshape(B, S, H, hd)

    q = proj(lp["wq"], "q")
    k = proj(lp["wk"], "k")
    v = proj(lp["wv"], "v")
    rope = rope_tables(torch.arange(S, device=x.device), hd, theta)
    q = apply_rope(q, *rope)
    k = apply_rope(k, *rope)

    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / \
        math.sqrt(hd)
    iq = torch.arange(S, device=x.device)[:, None]
    ik = torch.arange(S, device=x.device)[None, :]
    mask = ik[None] < lens[:, None, None]                      # padding
    if not is_global and cfg.local_window > 0:
        mask = mask & ((iq - ik).abs() < cfg.local_window)[None]
    logits = torch.where(mask[:, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, d)
    return x + out @ lp["wo"]


def _row_ids(row_task, S):
    """One-hot (B, T) -> the (B*S,) int32 task id of every token row; an
    all-zero row gets -1 (a zero delta, as its one-hot gives)."""
    ids = torch.where(row_task.max(dim=1).values > 0,
                      row_task.argmax(dim=1), -1)
    return ids.to(torch.int32).repeat_interleave(S).contiguous()


def encoder_forward(cfg: EncoderConfig, params, ids, lens, seg=None,
                    lora=None, row_task=None, early_exit: int = 0):
    """ids (B,S) -> hidden states (B,S,d).  ``lora``: one adapter set
    (tensors (L,d,r)) or stacked-task set (tensors (T,L,d,r)) with
    ``row_task`` one-hot (B,T).  ``early_exit``: stop after k layers
    (Matryoshka layer dimension)."""
    ids = ids.long()
    x = params["embed"][ids]
    if seg is not None:
        x = x + params["seg_embed"][seg.long()]
    S = ids.shape[1]
    row_ids = _row_ids(row_task, S) if row_task is not None else None
    n = early_exit or cfg.n_layers
    for i, lp in enumerate(params["layers"][:n]):
        ll = None
        if lora is not None:
            if row_task is not None:     # stacked (T, L, d, r) -> (T, d, r)
                ll = {k: lora[k][:, i].contiguous() for k in LORA_KEYS}
            else:                        # single task (L, d, r) -> (d, r)
                ll = {k: lora[k][i] for k in LORA_KEYS}
        x = _attention(cfg, lp, x, lens, i, lora=ll, row_ids=row_ids)
        h = rms_norm(x, lp["norm2"], 1e-6)
        gate, up = torch.chunk(h @ lp["w_in"], 2, dim=-1)
        # jax.nn.gelu defaults to the tanh approximation
        x = x + (F.gelu(gate, approximate="tanh") * up) @ lp["w_out"]
    return rms_norm(x, params["final_norm"], 1e-6)


def cls_pool(hidden):
    return hidden[:, 0, :]


def mean_pool(hidden, lens):
    mask = (torch.arange(hidden.shape[1], device=hidden.device)[None]
            < lens[:, None])[..., None]
    s = (hidden * mask).sum(1)
    return s / torch.clamp(mask.sum(1), min=1)


def matryoshka(emb, dim: int):
    """Dimension-truncated embedding, re-normalized (§11.6)."""
    e = emb[:, :dim]
    return e / torch.clamp(torch.linalg.norm(e, dim=-1, keepdim=True),
                           min=1e-9)


# ---------------------------------------------------------------------------
# multi-task batched inference (the §9.3 hot path, fused)
# ---------------------------------------------------------------------------

def multitask_logits(cfg: EncoderConfig, params, adapters: dict,
                     tasks: Sequence[str], ids, lens):
    """Run |tasks| classifications for a batch of B texts in ONE batched
    forward of B*T rows with per-row LoRA (rows sorted by task).  Returns
    {task: (B, C_t)}."""
    B = ids.shape[0]
    T = len(tasks)
    ids_rep = ids.repeat(T, 1)
    lens_rep = lens.repeat(T)
    row_task = torch.arange(T, device=ids.device).repeat_interleave(B)
    onehot = F.one_hot(row_task, T).to(torch.float32)
    stacked = {k: torch.stack([adapters[t][k] for t in tasks])
               for k in LORA_KEYS}
    hidden = encoder_forward(cfg, params, ids_rep, lens_rep,
                             lora=stacked, row_task=onehot)
    pooled = cls_pool(hidden)                       # (B*T, d)
    out = {}
    for ti, t in enumerate(tasks):
        rows = pooled[ti * B:(ti + 1) * B]
        out[t] = rows @ adapters[t]["head"]
    return out


def single_task_logits(cfg, params, adapters, task, ids, lens):
    """Paper-faithful mode: one forward pass per task (§9.3 baseline)."""
    lora = {k: adapters[task][k] for k in LORA_KEYS}
    hidden = encoder_forward(cfg, params, ids, lens, lora=lora)
    if task == "pii":
        return hidden @ adapters["pii"]["head"]     # (B, S, tags)
    return cls_pool(hidden) @ adapters[task]["head"]


# ---------------------------------------------------------------------------
# backend protocol implementation
# ---------------------------------------------------------------------------

class EncoderBackend(ClassifierBackend):
    """ClassifierBackend over the encoder.  Tasks without trained adapters
    delegate to HashBackend labels (the deterministic tier), so the system
    is usable before/without adapter training.  Runs on the device of its
    weights; results come back as numpy arrays."""

    name = "encoder"

    def __init__(self, cfg: EncoderConfig, params, adapters,
                 trained: Optional[set] = None, batched: bool = True):
        self.cfg = cfg
        self.params = params
        self.adapters = adapters
        self.trained = trained or set()
        self.batched = batched
        self.device = params["embed"].device
        self._fallback = HashBackend()

    @classmethod
    def default(cls, cfg: Optional[EncoderConfig] = None, seed: int = 0,
                device: DeviceLike = "cuda"):
        cfg = cfg or EncoderConfig()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, init_encoder(cfg, gen, dev),
                   init_adapters(cfg, gen, dev))

    @classmethod
    def small(cls, trained=(), seed: int = 0, device: DeviceLike = "cuda"):
        """Tiny instance (the reference's ``small`` widths) shared by tests
        and smoke runs."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return cls(SMALL, init_encoder(SMALL, gen, dev),
                   init_adapters(SMALL, gen, dev), trained=set(trained))

    def _encode(self, texts):
        ids, lens = TOK.encode_batch(list(texts), self.cfg.max_len)
        return (torch.from_numpy(ids).to(self.device),
                torch.from_numpy(lens).to(self.device))

    # -- embeddings ---------------------------------------------------------
    def embed(self, texts, dim: Optional[int] = None,
              early_exit: int = 0) -> np.ndarray:
        """Mean-pooled, Matryoshka-truncated embeddings.  ``early_exit`` is
        accepted and, as in the reference backend, not applied: the full
        depth always runs."""
        ids, lens = self._encode(texts)
        hidden = encoder_forward(self.cfg, self.params, ids, lens)
        emb = matryoshka(mean_pool(hidden, lens), dim or self.cfg.embed_dim)
        return emb.float().cpu().numpy()

    # -- sequence classification ------------------------------------------------
    def _probs_to_result(self, task, logits):
        probs = torch.softmax(logits.float(), dim=-1).cpu().numpy()
        return [TASK_LABELS[task][int(i)] for i in probs.argmax(1)], probs

    def classify(self, task, texts):
        if task not in self.trained:
            return self._fallback.classify(task, texts)
        ids, lens = self._encode(texts)
        logits = single_task_logits(self.cfg, self.params, self.adapters,
                                    task, ids, lens)
        return self._probs_to_result(task, logits)

    def classify_all(self, tasks, texts):
        """Fused multi-task path (beyond-paper): ONE batched forward of
        B*T rows serves every trained task, folding tasks into the batch
        dimension via per-row LoRA.  Untrained tasks delegate per-task to
        the hash fallback so results match ``classify`` exactly.  With
        ``batched=False`` (the paper's §9.3 baseline) trained tasks run
        one forward each instead."""
        out = {}
        fused = tuple(t for t in tasks if t in self.trained)
        for t in tasks:
            if t not in self.trained:
                out[t] = self._fallback.classify(t, texts)
        if not fused:
            return out
        ids, lens = self._encode(texts)
        if self.batched:
            logits = multitask_logits(self.cfg, self.params, self.adapters,
                                      fused, ids, lens)
        else:
            logits = {t: single_task_logits(self.cfg, self.params,
                                            self.adapters, t, ids, lens)
                      for t in fused}
        for t in fused:
            out[t] = self._probs_to_result(t, logits[t])
        return out

    # -- token classification (PII) ------------------------------------------------
    def token_classify(self, texts):
        if "pii" not in self.trained:
            return self._fallback.token_classify(texts)
        ids, lens = self._encode(texts)
        logits = single_task_logits(self.cfg, self.params, self.adapters,
                                    "pii", ids, lens)
        probs = torch.softmax(logits.float(), dim=-1).cpu().numpy()
        lens = lens.cpu().numpy()
        out = []
        for i, _ in enumerate(texts):
            spans = []
            tags = probs[i].argmax(-1)
            for j in range(1, int(lens[i]) - 1):
                tag = PII_TAGS[int(tags[j])]
                if tag.startswith("B-"):
                    spans.append((j, j + 1, tag[2:],
                                  float(probs[i, j].max())))
            out.append(spans)
        return out

    # -- pair cross-encoders (NLI, grounding detector) ------------------------------
    def _pair_classify(self, task, texts_a, texts_b):
        rows = [TOK.encode_pair(a, b, self.cfg.max_len)
                for a, b in zip(texts_a, texts_b)]
        dev = self.device
        ids = torch.from_numpy(np.stack([r[0] for r in rows])).to(dev)
        seg = torch.from_numpy(np.stack([r[1] for r in rows])).to(dev)
        lens = torch.tensor([r[2] for r in rows], dtype=torch.int32,
                            device=dev)
        lora = {k: self.adapters[task][k] for k in LORA_KEYS}
        hidden = encoder_forward(self.cfg, self.params, ids, lens, seg=seg,
                                 lora=lora)
        logits = cls_pool(hidden) @ self.adapters[task]["head"]
        return self._probs_to_result(task, logits)

    def nli(self, claims, evidences):
        return self._pair_classify("nli", claims, evidences)

    def detector(self, sentences, contexts):
        """Grounding check as a pair cross-encoder: (answer sentence,
        grounding context) -> SUPPORTED / HALLUCINATED."""
        return self._pair_classify("detector", sentences, contexts)
