"""Modality frontend stubs: the projector only.

Counterpart of `repro.models.frontends`. The vision and audio entries give
the transformer backbone; their inputs are precomputed features (CLIP-L
patches for llava-next, conv-frame features for hubert), which this
projector maps into d_model. Feature extraction is out of scope, as in the
JAX package.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers


def init_frontend(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    f = cfg.frontend
    if f.kind == "none":
        return {}
    return {"proj": layers.truncated_normal(
        gen, (f.frontend_dim, cfg.d_model), f.frontend_dim ** -0.5, device)}


def project(params: dict, features: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """(B, N, frontend_dim) -> (B, N, d_model) in the compute dtype."""
    cdt = getattr(torch, cfg.compute_dtype)
    return features.to(cdt) @ params["proj"].to(cdt)
