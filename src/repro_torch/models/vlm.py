"""InternVL2-style VLM (the vlm family): a vision-frontend stub and the
decoder-only backbone, ported from `repro.models.vlm`.

The frontend is a stub, as in the reference: the batch supplies
precomputed patch embeddings [B, n_img_tokens, d_model] (InternViT's output
after the mlp1 projector) under `prefix_embeds`. They are prepended to the
text embeddings and the whole sequence runs through `transformer`; the
loss is scored on the text positions only.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T

param_specs = T.param_specs
init = T.init
forward = T.forward
token_nll = T.token_nll
prefill = T.prefill
decode_step = T.decode_step
init_cache = T.init_cache


def loss_per_client(params: Dict, cfg: ModelConfig,
                    batch: Dict) -> torch.Tensor:
    assert "prefix_embeds" in batch, "vlm batches carry patch embeddings"
    return T.loss_per_client(params, cfg, batch)
