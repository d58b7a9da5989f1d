"""Synthetic task generators, copied from `repro.data.tasks`:

  * sst2  — binary sentiment: sequences carry an excess of "positive" or
    "negative" lexicon tokens; the model emits the verdict token at the
    answer position (accuracy);
  * squad — extraction: a KEY marker followed by an answer token; after the
    QUESTION marker the model reproduces the answer (exact match);
  * lm    — next-token modeling over a seeded order-1 Markov chain.

Purely seeded numpy, so batches are bitwise equal to the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

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


def sample_squad(spec: TaskSpec, rng: np.random.Generator, n: int) -> Dict:
    """Extraction: reproduce the token that followed the KEY marker."""
    s = spec.seq_len
    usable = np.arange(N_RESERVED, spec.vocab_size)
    tokens = rng.choice(usable, size=(n, s)).astype(np.int32)
    targets = np.zeros((n, s), dtype=np.int32)
    mask = np.zeros((n, s), dtype=np.float32)
    answers = rng.choice(usable, size=n)
    key_pos = rng.integers(1, s - 3, size=n)
    for i in range(n):
        tokens[i, key_pos[i]] = KEY
        tokens[i, key_pos[i] + 1] = answers[i]
        tokens[i, -1] = QUESTION
        targets[i, -1] = answers[i]
        mask[i, -1] = 1.0
    return {"tokens": tokens, "targets": targets, "mask": mask,
            "labels": answers.astype(np.int32)}


def sample_lm(spec: TaskSpec, rng: np.random.Generator, n: int) -> Dict:
    """Order-1 Markov stream with a per-task random transition structure."""
    v = spec.vocab_size
    s = spec.seq_len
    # sparse deterministic-ish successor table
    succ = (np.arange(v) * 31 + 7) % (v - N_RESERVED) + N_RESERVED
    tokens = np.zeros((n, s + 1), dtype=np.int32)
    tokens[:, 0] = rng.integers(N_RESERVED, v, size=n)
    noise = rng.random((n, s)) < 0.15
    rand_tok = rng.integers(N_RESERVED, v, size=(n, s))
    for t in range(s):
        nxt = succ[tokens[:, t]]
        tokens[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
    return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:],
            "mask": np.ones((n, s), dtype=np.float32),
            "labels": np.zeros(n, dtype=np.int32)}


_SAMPLERS = {"sst2": sample_sst2, "squad": sample_squad, "lm": sample_lm}


def sample(task: str, spec: TaskSpec, rng: np.random.Generator, n: int,
           client_bias: Optional[np.ndarray] = None) -> Dict:
    """`n` sequences of `task`. Every client draws from the one IID
    distribution: a per-client bias (a non-IID split) is not implemented,
    so passing one raises instead of being dropped."""
    if client_bias is not None:
        raise NotImplementedError(
            "client_bias is not implemented: the samplers draw IID batches")
    return _SAMPLERS[task](spec, rng, n)


def accuracy(logits: np.ndarray, batch: Dict) -> float:
    """Answer-position accuracy (SST-2 accuracy / SQuAD exact match): the
    argmax of the logits at the last position against the target there."""
    pred = np.argmax(logits[:, -1], axis=-1)
    return float(np.mean(pred == batch["targets"][:, -1]))
