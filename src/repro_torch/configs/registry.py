"""Registry of assigned architectures (exact public configs) + smoke variants.

Every entry: ``full()`` returns the exact published config; ``smoke()`` a
reduced same-family config for CPU tests (small widths/layers/experts/vocab).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from .base import (EncDecConfig, HybridConfig, ModelConfig,
                   MoEConfig, SSMConfig, VLMConfig)

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    from . import (deepseek_moe_16b, granite_moe_3b_a800m, mamba2_2p7b,  # noqa
                   mistral_7b, mistral_large_123b, pixtral_12b, qwen1p5_110b,
                   qwen3_1p7b, qwen3_32b, whisper_small, zamba2_2p7b)
    return _REGISTRY[name]()


def list_archs():
    from . import (deepseek_moe_16b, granite_moe_3b_a800m, mamba2_2p7b,  # noqa
                   mistral_7b, mistral_large_123b, pixtral_12b, qwen1p5_110b,
                   qwen3_1p7b, qwen3_32b, whisper_small, zamba2_2p7b)
    return sorted(_REGISTRY)


ASSIGNED = [
    "deepseek-moe-16b", "granite-moe-3b-a800m", "qwen3-32b", "qwen3-1.7b",
    "mistral-large-123b", "qwen1.5-110b", "zamba2-2.7b", "pixtral-12b",
    "mamba2-2.7b", "whisper-small",
]


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: small widths, few layers/experts, tiny
    vocab.  Keeps every structural feature (GQA ratio, qk-norm, bias, shared
    experts, hybrid period, enc-dec, ...) of the full config."""
    cfg = get_config(name)
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=min(cfg.num_layers, 4),
        d_model=128,
        num_heads=4,
        num_kv_heads=max(1, 4 * cfg.num_kv_heads // max(cfg.num_heads, 1)),
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        attn_chunk_q=32,
        attn_chunk_kv=32,
        logits_chunk_vocab=0,
        scan_layers=True,
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            num_experts=8, top_k=min(cfg.moe.top_k, 2),
            num_shared=min(cfg.moe.num_shared, 1),
            d_ff_expert=64,
            first_k_dense=1 if cfg.moe.first_k_dense else 0,
            d_ff_dense=256 if cfg.moe.first_k_dense else 0)
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32,
                              n_groups=cfg.ssm.n_groups, chunk=16)
        kw["num_heads"] = 4      # unused by ssm but keep consistent
    if cfg.hybrid is not None:
        kw["hybrid"] = HybridConfig(period=2)
        kw["num_layers"] = 4
    if cfg.encdec is not None:
        kw["encdec"] = EncDecConfig(encoder_layers=2)
        kw["num_layers"] = 2
    if cfg.vlm is not None:
        kw["vlm"] = VLMConfig(num_patches=8)
    return dataclasses.replace(cfg, **kw)
