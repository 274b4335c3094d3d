"""llava-next-mistral-7b [vlm]: Mistral-7B backbone + anyres vision stub.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]. The vision tower is a
STUB per the assignment: input_specs() provides 576 precomputed patch
embeddings (anyres base tile) of dim 1024 (CLIP-L), projected into the
sequence ahead of the text tokens. Full attention -> long_500k skipped.
"""

from repro_torch.configs.base import FrontendConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b", family="vlm",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14_336, vocab_size=32_000,
        period=("attn",),
        rope_theta=1e6,
        frontend=FrontendConfig(kind="vision", num_patches=576,
                                frontend_dim=1024),
        tie_embeddings=False,
    )
