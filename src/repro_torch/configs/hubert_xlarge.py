"""hubert-xlarge [audio]: encoder-only transformer over audio frames.

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 [arXiv:2106.07447;
unverified]. The CNN waveform frontend is a STUB per the assignment:
input_specs() provides precomputed 512-dim frame embeddings, projected to
d_model. Bidirectional (causal=False); the 504-unit head predicts masked
cluster targets. Encoder-only -> decode/long shapes are skipped.
"""

from repro_torch.configs.base import FrontendConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="audio",
        num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
        d_ff=5120, vocab_size=504,
        period=("attn",),
        causal=False,
        frontend=FrontendConfig(kind="audio", frontend_dim=512),
        tie_embeddings=False,
    )
