"""Classifier backends powering the learned signals (§3.3), a copy of
``repro.classifiers.backend`` (numpy and hashlib only; the hash backend's
numbers equal the reference's exactly).

Protocol:
  embed(texts)                -> (n, dim) float32
  classify(task, texts)       -> (labels list[str], probs (n, C))
  token_classify(texts)       -> list[list[(start, end, label, conf)]]  (PII)

Backends:
  HashBackend     deterministic feature-hash embeddings + lexicon/regex
                  classifiers — zero-training reference semantics (tests,
                  examples, and the paper's "heuristic fallback" tier).
  EncoderBackend  the MoM stack: shared bidirectional encoder + LoRA
                  task heads with batched multi-task inference
                  (repro_torch.classifiers.encoder; the card's path).
"""

from __future__ import annotations

import hashlib
import re
from typing import TYPE_CHECKING, Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core import textstats as TS

if TYPE_CHECKING:
    from repro_torch.device import DeviceLike

EMBED_DIM = 256

DOMAIN_LABELS = ["math", "computer science", "physics", "chemistry",
                 "biology", "economics", "law", "health", "history",
                 "psychology", "business", "philosophy", "engineering",
                 "other"]

_DOMAIN_LEXICON = {
    "math": ["equation", "integral", "derivative", "algebra", "theorem",
             "prove", "matrix", "calculus", "polynomial", "geometry",
             "solve", "sum", "probability"],
    "computer science": ["code", "python", "function", "algorithm", "bug",
                         "compile", "api", "class", "debug", "program",
                         "software", "server", "database", "javascript"],
    "physics": ["quantum", "velocity", "energy", "momentum", "relativity",
                "particle", "force", "electron", "photon"],
    "chemistry": ["molecule", "reaction", "acid", "compound", "element",
                  "bond", "organic", "atom"],
    "biology": ["cell", "dna", "protein", "organism", "gene", "enzyme",
                "evolution", "bacteria"],
    "economics": ["market", "inflation", "gdp", "price", "demand", "supply",
                  "interest rate", "monetary", "fiscal", "investment",
                  "stock", "finance"],
    "law": ["contract", "liability", "court", "statute", "plaintiff",
            "legal", "lawsuit", "regulation"],
    "health": ["symptom", "diagnosis", "patient", "treatment", "medication",
               "doctor", "disease", "appointment", "clinic"],
    "history": ["empire", "war", "century", "revolution", "ancient",
                "dynasty", "historical"],
    "psychology": ["behavior", "cognitive", "anxiety", "therapy", "emotion",
                   "mental"],
    "business": ["startup", "revenue", "customer", "marketing", "strategy",
                 "product", "sales"],
    "philosophy": ["ethics", "metaphysics", "epistemology", "moral",
                   "existence", "consciousness"],
    "engineering": ["circuit", "voltage", "mechanical", "design load",
                    "torque", "signal processing"],
}

_JAILBREAK_PATTERNS = [
    "ignore all previous instructions", "ignore previous instructions",
    "you are now dan", "do anything now", "pretend you are",
    "disregard your guidelines", "bypass your safety",
    "jailbreak", "without any restrictions", "developer mode",
    "ignore your system prompt", "reveal your system prompt",
    "act as an unrestricted ai",
]

_FEEDBACK_LEXICON = {
    "satisfied": ["thanks", "thank you", "great", "perfect", "awesome",
                  "that worked", "exactly what i needed"],
    "dissatisfied": ["wrong", "incorrect", "that's not right", "bad answer",
                     "useless", "didn't work", "not what i asked"],
    "clarification": ["what do you mean", "can you explain", "clarify",
                      "i don't understand", "confused"],
    "alternative": ["another way", "different approach", "alternative",
                    "other option", "instead"],
}

_MODALITY_IMAGE = ["draw", "image of", "picture of", "generate an image",
                   "illustration", "render", "photo of", "sketch",
                   "painting of", "logo"]
_MODALITY_AUDIO = ["transcribe", "transcription", "audio", "speech",
                   "recording", "voice memo", "podcast", "voicemail",
                   "spoken", "dictation"]

_FACTUAL_CUES = ["who", "what year", "when did", "where is", "capital of",
                 "how many", "what is the", "define", "population of",
                 "distance", "tallest", "first president"]
_CREATIVE_CUES = ["write a poem", "write a story", "brainstorm", "imagine",
                  "fiction", "creative", "compose", "lyrics", "slogan"]

PII_LABELS = ["PERSON", "EMAIL", "PHONE", "SSN", "CREDIT_CARD", "IP",
              "IBAN", "DATE_OF_BIRTH"]

_PII_REGEX = {
    "EMAIL": re.compile(r"\b[\w.+-]+@[\w-]+\.[\w.]+\b"),
    "PHONE": re.compile(r"(?<!\d)(\+?\d{1,2}[\s.-]?)?(\(?\d{3}\)?[\s.-]?)"
                        r"\d{3}[\s.-]?\d{4}(?!\d)"),
    "SSN": re.compile(r"\b\d{3}-\d{2}-\d{4}\b"),
    "CREDIT_CARD": re.compile(r"\b(?:\d[ -]?){13,16}\b"),
    "IP": re.compile(r"\b\d{1,3}(?:\.\d{1,3}){3}\b"),
    "IBAN": re.compile(r"\b[A-Z]{2}\d{2}[A-Z0-9]{10,30}\b"),
    "DATE_OF_BIRTH": re.compile(
        r"\b(born|dob)[:\s]+\d{1,2}[/-]\d{1,2}[/-]\d{2,4}\b", re.I),
}
_NAME_RE = re.compile(r"\b(my name is|i am|i'm|this is)\s+([A-Z][a-z]+"
                      r"(?:\s+[A-Z][a-z]+)?)")


def _hash_idx(token: str, seed: int) -> int:
    h = hashlib.blake2s(f"{seed}:{token}".encode(), digest_size=4).digest()
    return int.from_bytes(h, "little") % EMBED_DIM


def _hash_sign(token: str) -> float:
    h = hashlib.blake2s(f"sign:{token}".encode(), digest_size=1).digest()
    return 1.0 if h[0] % 2 else -1.0


class ClassifierBackend:
    name = "base"

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        raise NotImplementedError

    def classify(self, task: str, texts: Sequence[str]
                 ) -> Tuple[List[str], np.ndarray]:
        raise NotImplementedError

    def classify_all(self, tasks: Sequence[str], texts: Sequence[str]
                     ) -> Dict[str, Tuple[List[str], np.ndarray]]:
        """Multi-task batch: ``{task: (labels, probs)}`` for every task
        over every text.  Base implementation loops ``classify`` per task
        (reference semantics — HashBackend works unchanged); backends
        with fused multi-task inference (EncoderBackend) override it with
        one batched forward."""
        return {t: self.classify(t, texts) for t in tasks}

    def token_classify(self, texts: Sequence[str]):
        raise NotImplementedError


class HashBackend(ClassifierBackend):
    """Deterministic reference backend: feature-hash embeddings (word +
    bigram + char-trigram features, 2 hash seeds, signed) and
    lexicon/regex classifiers."""

    name = "hash"

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), EMBED_DIM), np.float32)
        for i, t in enumerate(texts):
            words = TS.tokenize_words(t)
            feats = list(words)
            feats += [f"{a}_{b}" for a, b in zip(words, words[1:])]
            feats += list(TS.char_ngrams(t, 3))
            for f in feats:
                for seed in (0, 1):
                    out[i, _hash_idx(f, seed)] += _hash_sign(f)
            n = np.linalg.norm(out[i])
            if n > 0:
                out[i] /= n
        return out

    # ------------------------------------------------------------------
    def classify(self, task: str, texts: Sequence[str]):
        fn = {
            "domain": self._domain, "jailbreak": self._jailbreak,
            "fact_check": self._fact, "user_feedback": self._feedback,
            "modality": self._modality,
        }[task]
        labels, probs = [], []
        for t in texts:
            l, p = fn(t)
            labels.append(l)
            probs.append(p)
        return labels, np.asarray(probs, np.float32)

    def _scores_to_probs(self, scores, temp=1.0):
        s = np.asarray(scores, np.float64) / temp
        e = np.exp(s - s.max())
        return e / e.sum()

    def _domain(self, text: str):
        tl = " " + text.lower() + " "
        scores = []
        for lab in DOMAIN_LABELS[:-1]:
            lex = _DOMAIN_LEXICON.get(lab, [])
            scores.append(sum(2.0 for w in lex if f" {w}" in tl))
        scores.append(0.75)  # "other" prior
        p = self._scores_to_probs(scores)
        return DOMAIN_LABELS[int(np.argmax(p))], p

    def _jailbreak(self, text: str):
        tl = text.lower()
        n = sum(1 for pat in _JAILBREAK_PATTERNS if pat in tl)
        score = min(1.0, 0.7 * n)
        p = np.array([max(1e-3, 1.0 - score), score * 0.3, score * 0.7])
        p = p / p.sum()
        lab = "BENIGN" if score < 0.5 else \
            ("JAILBREAK" if p[2] >= p[1] else "INJECTION")
        return lab, p

    def _fact(self, text: str):
        tl = text.lower()
        f = sum(1 for c in _FACTUAL_CUES if c in tl)
        c = sum(1 for c in _CREATIVE_CUES if c in tl)
        score = 0.25 + 0.35 * f - 0.4 * c
        score = float(np.clip(score, 0.02, 0.98))
        lab = "NEEDS_FACT_CHECK" if score >= 0.5 else "NO_FACT_CHECK"
        return lab, np.array([1 - score, score])

    def _feedback(self, text: str):
        tl = text.lower()
        scores = [sum(1.5 for w in _FEEDBACK_LEXICON[k] if w in tl)
                  for k in ("satisfied", "dissatisfied", "clarification",
                            "alternative")]
        scores.append(0.5)  # none
        p = self._scores_to_probs(scores)
        labs = ["satisfied", "dissatisfied", "clarification", "alternative",
                "none"]
        return labs[int(np.argmax(p))], p

    def _modality(self, text: str):
        tl = text.lower()
        img = sum(1 for w in _MODALITY_IMAGE if w in tl)
        aud = sum(1 for w in _MODALITY_AUDIO if w in tl)
        # conjunction of an image cue with more asks ("draw X and
        # explain Y") outranks pure diffusion; word-boundary "and" only,
        # or "command"/"sandbox" would trigger it
        both = 1.0 if (img and " and " in f" {tl} ") else 0.0
        scores = [1.0, 1.8 * img, 2.4 * both, 1.8 * aud]
        p = self._scores_to_probs(scores)
        labs = ["autoregressive", "diffusion", "both", "audio"]
        return labs[int(np.argmax(p))], p

    # ------------------------------------------------------------------
    def token_classify(self, texts: Sequence[str]):
        out = []
        for t in texts:
            spans = []
            for lab, rex in _PII_REGEX.items():
                for m in rex.finditer(t):
                    conf = 0.97 if lab in ("EMAIL", "SSN") else 0.88
                    spans.append((m.start(), m.end(), lab, conf))
            for m in _NAME_RE.finditer(t):
                spans.append((m.start(2), m.end(2), "PERSON", 0.82))
            out.append(spans)
        return out


_BACKENDS: Dict[str, ClassifierBackend] = {}


def get_backend(name: str = "hash",
                device: DeviceLike = "cuda") -> ClassifierBackend:
    """The registered backend ``name``; "hash" and "encoder" are built on
    first use, the encoder on ``device`` (later calls return that one)."""
    if name not in _BACKENDS:
        if name == "hash":
            _BACKENDS[name] = HashBackend()
        elif name == "encoder":
            from repro_torch.classifiers.encoder import EncoderBackend
            _BACKENDS[name] = EncoderBackend.default(device=device)
        else:
            raise KeyError(name)
    return _BACKENDS[name]


def register_backend(name: str, backend: ClassifierBackend):
    """Install a configured backend instance (e.g. an EncoderBackend with
    trained adapters) so configs can reference it by name."""
    _BACKENDS[name] = backend
