"""Federated data pipeline, copied from `repro.data.pipeline`.

Every client owns a private stream seeded from (seed, client, round), so
batch(t) is a pure function of (seed, t, K, shape) and bitwise equal to the
reference's. Batches come out as [K, b, S] host arrays, with the stub
frontend's embeddings [K, b, P, D] under `prefix_embeds` when
`frontend_tokens` > 0 (the vlm's patches, the audio family's frames);
`eval_batch` gives the reference's held-out [n, S] batch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.data import tasks as T


@dataclass
class FederatedPipeline:
    task: str                 # sst2 | squad | lm
    spec: T.TaskSpec
    n_clients: int
    per_client_batch: int
    seed: int = 0
    frontend_tokens: int = 0  # >0 → attach stub modality embeddings
    d_model: int = 0

    def client_rng(self, client: int, t: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed * 1_000_003 + client) * 2_654_435_761 % (2 ** 63)
            + t)

    def batch(self, t: int) -> Dict[str, np.ndarray]:
        """Round-t global batch [K, b, S] (pure function of (seed, t))."""
        per = [T.sample(self.task, self.spec, self.client_rng(k, t),
                        self.per_client_batch)
               for k in range(self.n_clients)]
        out = {key: np.stack([p[key] for p in per]) for key in per[0]}
        if self.frontend_tokens > 0:
            out["prefix_embeds"] = self.prefix_embeds(t)
        return out

    def prefix_embeds(self, t: int) -> np.ndarray:
        """Round t's stub embeddings [K, b, P, D] f32: normals × 0.1 from
        the reference's seed expression as Python parses it,
        seed ^ (0xF0F0 + t)."""
        rng = np.random.default_rng(self.seed ^ 0xF0F0 + t)
        return rng.standard_normal(
            (self.n_clients, self.per_client_batch, self.frontend_tokens,
             self.d_model)).astype(np.float32) * 0.1

    def eval_batch(self, n: int, t: int = 10 ** 9) -> Dict[str, np.ndarray]:
        """Held-out batch [n, S] (a disjoint stream index range). The seed
        is the reference's expression as Python parses it:
        seed ^ (0xE7A1 + t)."""
        rng = np.random.default_rng(self.seed ^ 0xE7A1 + t)
        return T.sample(self.task, self.spec, rng, n)
