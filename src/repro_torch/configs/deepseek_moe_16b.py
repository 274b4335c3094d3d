"""deepseek-moe-16b [moe]: fine-grained expert segmentation.

28L d_model=2048 16H (GQA kv=16) d_ff=1408/expert vocab=102400, 2 shared +
64 routed top-6 [arXiv:2401.06066; hf]. (The HF release keeps layer 0 as a
dense MLP; we use the uniform MoE stack for scan-layer economy -- noted
deviation.) Dispatch: DAKC packed tiles over the expert-parallel axis.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", family="moe",
        num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1408, vocab_size=102_400,
        period=("moe",),
        moe=MoEConfig(num_experts=64, num_shared_experts=2, top_k=6,
                      expert_d_ff=1408),
        tie_embeddings=False,
    )
