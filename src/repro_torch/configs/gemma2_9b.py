"""gemma2-9b [dense]: local+global alternating attention, logit softcaps.

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000 [arXiv:2408.00118; hf].
head_dim=256; sliding window 4096 on local layers; attn softcap 50, final
softcap 30. Global layers are full attention -> long_500k skipped.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b", family="dense",
        num_layers=42, d_model=3584, num_heads=16, num_kv_heads=8,
        d_ff=14_336, vocab_size=256_000, head_dim=256,
        period=("attn_local", "attn"),
        sliding_window=4_096,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        tie_embeddings=True,
    )
