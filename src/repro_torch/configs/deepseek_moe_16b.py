"""deepseek-moe-16b [arXiv:2401.06066]: 28L d=2048 16H (kv=16) vocab=102400,
MoE: 64 routed top-6 + 2 shared, d_ff_expert=1408, first layer dense 10944."""
from .base import LoRAConfig, ModelConfig, MoEConfig
from .registry import register


@register("deepseek-moe-16b")
def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", family="moe",
        num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=10944, vocab_size=102400, rope_theta=1e4,
        moe=MoEConfig(num_experts=64, top_k=6, num_shared=2,
                      d_ff_expert=1408, first_k_dense=1, d_ff_dense=10944),
        lora=LoRAConfig(rank=16, targets=("q", "k", "v")),
        logits_chunk_vocab=12800,
    )
