"""moonshot-v1-16b-a3b [moe]: Moonlight-16B-A3B fine-grained MoE.

48L d_model=2048 16H (GQA kv=16) d_ff=1408/expert vocab=163840, 64 routed
experts top-6 + 2 shared [hf:moonshotai/Moonlight-16B-A3B; hf]. ~3B active
parameters per token. MoE dispatch uses the DAKC packed-tile engine
(DESIGN.md Sec. 3.1).
"""

from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe",
        num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1408, vocab_size=163_840,
        period=("moe",),
        moe=MoEConfig(num_experts=64, num_shared_experts=2, top_k=6,
                      expert_d_ff=1408),
        tie_embeddings=True,
    )
