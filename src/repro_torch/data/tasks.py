"""Synthetic SST-2 stand-in, copied from `repro.data.tasks`.

Sequences carry a latent sentiment (an excess of "positive" vs "negative"
lexicon tokens); the model must emit the verdict token at the answer
position. Purely seeded numpy, so batches are bitwise equal to the
reference's. The other tasks (squad, lm) are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

# reserved token ids (low range)
PAD, CLS, QUESTION, KEY, POS_VERDICT, NEG_VERDICT = 0, 1, 2, 3, 4, 5
N_RESERVED = 8


@dataclass
class TaskSpec:
    name: str
    vocab_size: int
    seq_len: int


def _lexicons(vocab: int):
    usable = np.arange(N_RESERVED, vocab)
    half = len(usable) // 2
    return usable[:half], usable[half:]


def sample_sst2(spec: TaskSpec, rng: np.random.Generator, n: int) -> Dict:
    """Binary sentiment: label = which lexicon dominates the sequence."""
    pos_lex, neg_lex = _lexicons(spec.vocab_size)
    s = spec.seq_len
    tokens = np.zeros((n, s), dtype=np.int32)
    targets = np.zeros((n, s), dtype=np.int32)
    mask = np.zeros((n, s), dtype=np.float32)
    labels = rng.integers(0, 2, size=n)
    for i in range(n):
        dom, sub = (pos_lex, neg_lex) if labels[i] else (neg_lex, pos_lex)
        # 70/30 lexicon mixture → learnable but non-trivial
        mix = rng.random(s - 2) < 0.7
        body = np.where(mix, rng.choice(dom, s - 2), rng.choice(sub, s - 2))
        tokens[i, 0] = CLS
        tokens[i, 1:-1] = body
        tokens[i, -1] = QUESTION
        targets[i, -1] = POS_VERDICT if labels[i] else NEG_VERDICT
        mask[i, -1] = 1.0
    return {"tokens": tokens, "targets": targets, "mask": mask,
            "labels": labels.astype(np.int32)}


def sample(task: str, spec: TaskSpec, rng: np.random.Generator,
           n: int) -> Dict:
    if task != "sst2":
        raise NotImplementedError(
            f"task {task!r} is not ported (ROADMAP A2: squad/lm tasks); "
            "only sst2")
    return sample_sst2(spec, rng, n)


def accuracy(logits: np.ndarray, batch: Dict) -> float:
    """Answer-position accuracy (SST-2 accuracy): the argmax of the logits
    at the last position against the target there."""
    pred = np.argmax(logits[:, -1], axis=-1)
    return float(np.mean(pred == batch["targets"][:, -1]))
