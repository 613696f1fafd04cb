"""mamba2-2.7b [arXiv:2405.21060]: 64L d=2560 attention-free SSD,
ssm_state=128, vocab=50280."""
from .base import LoRAConfig, ModelConfig, SSMConfig
from .registry import register


@register("mamba2-2.7b")
def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm",
        num_layers=64, d_model=2560, num_heads=0, num_kv_heads=0,
        head_dim=64, d_ff=0, vocab_size=50280,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
        lora=LoRAConfig(rank=16, targets=("ssm_in", "ssm_out")),
        logits_chunk_vocab=0,
    )
