"""qwen1.5-110b [hf:Qwen/Qwen1.5 family]: 80L d=8192 64H (kv=8)
d_ff=49152 vocab=152064, QKV bias."""
from .base import LoRAConfig, ModelConfig
from .registry import register


@register("qwen1.5-110b")
def full() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b", family="dense",
        num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=49152, vocab_size=152064, qkv_bias=True,
        lora=LoRAConfig(rank=16, targets=("q", "k", "v")),
        logits_chunk_vocab=9504 * 2,
    )
