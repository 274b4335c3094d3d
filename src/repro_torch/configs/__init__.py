"""Architecture registry: --arch <id> -> ModelConfig.

The port's own copy of `repro.configs` (pure data): the same ten
architectures, the same fields and the same `reduced_config` overrides.
"""

from repro_torch.configs import base
from repro_torch.configs.base import ModelConfig, SHAPES, ShapeCell, applicable_shapes  # noqa: F401

_MODULES = {
    "zamba2-1.2b": "zamba2_1p2b",
    "gemma2-9b": "gemma2_9b",
    "minitron-8b": "minitron_8b",
    "qwen1.5-0.5b": "qwen1p5_0p5b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "hubert-xlarge": "hubert_xlarge",
    "mamba2-370m": "mamba2_370m",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    import importlib
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.config()


def reduced_config(arch_id: str, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests: same layer kinds and
    wiring, small widths/depths/vocabs (per the assignment's smoke rule)."""
    import dataclasses as dc
    cfg = get_config(arch_id)
    period = cfg.period
    small = dict(
        num_layers=2 * len(period), d_model=64,
        num_heads=4, num_kv_heads=max(1, 4 * cfg.num_kv_heads // cfg.num_heads),
        head_dim=16, d_ff=128 if cfg.d_ff else 0, vocab_size=512,
        sliding_window=(32 if cfg.sliding_window else None),
        rope_theta=cfg.rope_theta,
    )
    if cfg.moe is not None:
        small["moe"] = dc.replace(cfg.moe, num_experts=8, top_k=2,
                                  num_shared_experts=1, expert_d_ff=32)
    if cfg.ssm is not None:
        small["ssm"] = dc.replace(cfg.ssm, d_state=16, headdim=16, chunk=16)
    if cfg.frontend.kind == "vision":
        small["frontend"] = dc.replace(cfg.frontend, num_patches=8,
                                       frontend_dim=32)
    if cfg.frontend.kind == "audio":
        small["frontend"] = dc.replace(cfg.frontend, frontend_dim=32)
    small.update(overrides)
    return dc.replace(cfg, **small)
