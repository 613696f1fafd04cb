"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407]:
88L d=12288 96H (kv=8) d_ff=28672 vocab=32768, head_dim=128."""
from .base import LoRAConfig, ModelConfig
from .registry import register


@register("mistral-large-123b")
def full() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b", family="dense",
        num_layers=88, d_model=12288, num_heads=96, num_kv_heads=8,
        head_dim=128, d_ff=28672, vocab_size=32768,
        lora=LoRAConfig(rank=16, targets=("q", "k", "v")),
        logits_chunk_vocab=8192,
    )
