"""granite-moe-3b-a800m [hf:ibm-granite]: 32L d=1536 24H (kv=8) vocab=49155,
MoE: 40 experts top-8, d_ff_expert=512."""
from .base import LoRAConfig, ModelConfig, MoEConfig
from .registry import register


@register("granite-moe-3b-a800m")
def full() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
        head_dim=64, d_ff=512, vocab_size=49155, rope_theta=1e4,
        moe=MoEConfig(num_experts=40, top_k=8, num_shared=0, d_ff_expert=512),
        lora=LoRAConfig(rank=16, targets=("q", "k", "v")),
        logits_chunk_vocab=0,
    )
