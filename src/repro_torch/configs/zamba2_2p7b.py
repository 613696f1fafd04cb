"""zamba2-2.7b [arXiv:2411.15242]: 54 Mamba2 layers d=2560 + weight-shared
attention block (32H, kv=32, d_ff=10240) every 6 layers; ssm_state=64."""
from .base import HybridConfig, LoRAConfig, ModelConfig, SSMConfig
from .registry import register


@register("zamba2-2.7b")
def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
        head_dim=80, d_ff=10240, vocab_size=32000,
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
        hybrid=HybridConfig(period=6),
        lora=LoRAConfig(rank=16, targets=("q", "k", "v", "ssm_in", "ssm_out")),
        logits_chunk_vocab=0,
    )
