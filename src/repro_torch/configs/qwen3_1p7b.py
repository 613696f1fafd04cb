"""qwen3-1.7b: 28L d=2048 16H (kv=8) d_ff=6144 vocab=151936, qk-norm."""
from .base import LoRAConfig, ModelConfig
from .registry import register


@register("qwen3-1.7b")
def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b", family="dense",
        num_layers=28, d_model=2048, num_heads=16, num_kv_heads=8,
        head_dim=128, d_ff=6144, vocab_size=151936, qk_norm=True,
        lora=LoRAConfig(rank=16, targets=("q", "k", "v")),
        logits_chunk_vocab=9496 * 2,
    )
