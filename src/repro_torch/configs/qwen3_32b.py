"""qwen3-32b [hf:Qwen/Qwen3 family]: 64L d=5120 64H (kv=8) d_ff=25600
vocab=151936, qk-norm, head_dim=128."""
from .base import LoRAConfig, ModelConfig
from .registry import register


@register("qwen3-32b")
def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b", family="dense",
        num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=25600, vocab_size=151936, qk_norm=True,
        lora=LoRAConfig(rank=16, targets=("q", "k", "v")),
        logits_chunk_vocab=9496 * 2,
    )
