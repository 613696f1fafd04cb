"""whisper-small [arXiv:2212.04356]: 12L enc + 12L dec, d=768 12H d_ff=3072
vocab=51865; conv frontend STUB (input_specs supplies frame embeddings)."""
from .base import EncDecConfig, LoRAConfig, ModelConfig
from .registry import register


@register("whisper-small")
def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="audio",
        num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
        head_dim=64, d_ff=3072, vocab_size=51865,
        encdec=EncDecConfig(encoder_layers=12),
        lora=LoRAConfig(rank=16, targets=("q", "k", "v")),
        logits_chunk_vocab=0,
    )
