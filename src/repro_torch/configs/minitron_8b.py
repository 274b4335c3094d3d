"""minitron-8b [dense]: width/depth-pruned Nemotron-4.

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000
[arXiv:2407.14679; hf]. head_dim=128, squared-ReLU MLP in the original;
we use the framework's gated MLP (noted deviation), untied embeddings.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b", family="dense",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=16_384, vocab_size=256_000, head_dim=128,
        period=("attn",),
        tie_embeddings=False,
    )
