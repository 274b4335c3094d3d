"""qwen1.5-0.5b [dense]: QKV bias, large vocab, tied embeddings.

24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936
[hf:Qwen/Qwen1.5-0.5B; hf]. rope_theta=1e6 per the Qwen1.5 series.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b", family="dense",
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
        d_ff=2816, vocab_size=151_936,
        period=("attn",),
        qkv_bias=True, rope_theta=1e6,
        tie_embeddings=True,
    )
