"""h2o-danube-3-4b [dense]: llama+mistral mix with sliding-window attention.

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000
[arXiv:2401.16818; unverified]. All layers SWA (window 4096) -> the arch is
sub-quadratic and runs the long_500k cell. head_dim=120.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b", family="dense",
        num_layers=24, d_model=3840, num_heads=32, num_kv_heads=8,
        d_ff=10_240, vocab_size=32_000, head_dim=120,
        period=("attn_local",),
        sliding_window=4_096,
        tie_embeddings=False,
    )
