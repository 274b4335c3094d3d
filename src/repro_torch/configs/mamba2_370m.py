"""mamba2-370m [ssm]: pure SSD (state-space duality) stack, attention-free.

48L d_model=1024 d_ff=0 vocab=50280 ssm_state=128 [arXiv:2405.21060;
unverified]. expand=2 -> d_inner=2048, headdim=64 -> 32 SSM heads.
Attention-free -> sub-quadratic -> runs long_500k. num_heads/kv fields are
inert for this family.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m", family="ssm",
        num_layers=48, d_model=1024, num_heads=16, num_kv_heads=16,
        d_ff=0, vocab_size=50_280,
        period=("mamba",),
        ssm=SSMConfig(d_state=128, headdim=64, n_groups=1, expand=2),
        tie_embeddings=True,
    )
