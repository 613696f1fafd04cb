"""pixtral-12b [hf:mistralai/Pixtral-12B-2409]: mistral-nemo backbone
40L d=5120 32H (kv=8) d_ff=14336 vocab=131072 + pixtral-ViT frontend (STUB:
input_specs supplies precomputed patch embeddings)."""
from .base import LoRAConfig, ModelConfig, VLMConfig
from .registry import register


@register("pixtral-12b")
def full() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", family="vlm",
        num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=14336, vocab_size=131072,
        vlm=VLMConfig(num_patches=1024),
        lora=LoRAConfig(rank=16, targets=("q", "k", "v")),
        logits_chunk_vocab=8192,
    )
