"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention blocks.

38L d_model=2048 32H (GQA kv=32 = MHA) d_ff=8192 vocab=32000 ssm_state=64
[arXiv:2411.15242; hf]. Zamba pattern: one *shared* transformer block (same
parameters at every application point) interleaved into the Mamba2 stack --
here applied after every second Mamba2 layer (period: mamba, mamba+shared).
The shared block uses a 4096 sliding window so the hybrid stays
sub-quadratic for the long_500k cell (DESIGN.md Sec. 6).
"""

from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=8192, vocab_size=32_000,
        period=("mamba", "mamba_shared_attn"),
        sliding_window=4_096,
        ssm=SSMConfig(d_state=64, headdim=64, n_groups=1, expand=2),
        tie_embeddings=True,
    )
