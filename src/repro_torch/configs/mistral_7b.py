"""mistral-7b (the paper's base model, for the compression experiments):
32L d=4096 32H (kv=8) d_ff=14336 vocab=32000."""
from .base import LoRAConfig, ModelConfig
from .registry import register


@register("mistral-7b")
def full() -> ModelConfig:
    return ModelConfig(
        name="mistral-7b", family="dense",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=14336, vocab_size=32000,
        lora=LoRAConfig(rank=16, targets=("q", "k", "v")),
        logits_chunk_vocab=8000,
    )
