"""Architecture / run configuration dataclasses.

One ``ModelConfig`` describes any of the 10 assigned architectures; family-
specific blocks (MoE / SSM / enc-dec / hybrid) are optional sub-configs.
``smoke()`` produces a reduced same-family config for CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared: int = 0
    d_ff_expert: int = 0            # per-expert hidden dim
    first_k_dense: int = 0          # leading dense layers (deepseek-moe)
    d_ff_dense: int = 0             # their hidden dim
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """zamba2-style: shared attention+MLP block every `period` SSM layers."""
    period: int = 6


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    """whisper-style encoder-decoder; frontend is a stub (precomputed frames)."""
    encoder_layers: int = 12
    cross_attention: bool = True


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    """pixtral-style: patch embeddings (stub ViT) prepended to token stream."""
    num_patches: int = 1024


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16
    alpha: float = 32.0
    targets: Tuple[str, ...] = ("q", "k", "v")   # or ("ssm_in","ssm_out")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    sliding_window: int = 0         # 0 = full attention
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    lora: Optional[LoRAConfig] = LoRAConfig()
    # implementation knobs
    attn_chunk_q: int = 1024        # 0 = naive attention
    attn_chunk_kv: int = 2048
    remat: bool = True
    scan_layers: bool = True
    logits_chunk_vocab: int = 0     # >0: chunked cross-entropy over vocab
    # perf-iteration knobs (baseline values; see EXPERIMENTS.md §Perf)
    decode_attn: str = "gather"     # gather | seq_shard | lazy (two-part)
    attn_cp_fallback: bool = False  # context-parallel attn when heads % tp != 0
    grad_cast_bf16: bool = False    # cast layer-boundary cotangents to bf16

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        return _pad_to(self.vocab_size, 256)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def param_count(self) -> int:
        """Analytic parameter count N (embedding included once)."""
        d, hd = self.d_model, self.resolved_head_dim
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
            + self.num_heads * hd * d
        if self.qkv_bias:
            attn += (self.num_heads + 2 * self.num_kv_heads) * hd
        mlp_dense = 3 * d * self.d_ff
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        n = emb
        L = self.num_layers
        if self.family == "moe":
            m = self.moe
            per_moe = attn + 3 * d * m.d_ff_expert * (m.num_experts + m.num_shared) \
                + d * m.num_experts
            n += (L - m.first_k_dense) * per_moe
            n += m.first_k_dense * (attn + 3 * d * m.d_ff_dense)
        elif self.family == "ssm":
            n += L * self._ssm_params()
        elif self.family == "hybrid":
            n_shared_sites = L // self.hybrid.period
            n += L * self._ssm_params()
            n += attn + mlp_dense          # ONE shared block (weight-tied)
            del n_shared_sites
        elif self.family == "audio":
            enc_l = self.encdec.encoder_layers
            n += enc_l * (attn + mlp_dense)              # encoder
            n += L * (attn + attn + mlp_dense)           # decoder (self+cross)
        else:  # dense / vlm
            n += L * (attn + mlp_dense)
        n += L * 2 * d  # norms (approx)
        return int(n)

    def active_param_count(self) -> int:
        """Active params per token (MoE: shared + top_k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        m = self.moe
        hd = self.resolved_head_dim
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
            + self.num_heads * hd * d
        per_moe_active = attn + 3 * d * m.d_ff_expert * (m.top_k + m.num_shared)
        L = self.num_layers
        n = self.padded_vocab * d * 2
        n += (L - m.first_k_dense) * per_moe_active
        n += m.first_k_dense * (attn + 3 * d * m.d_ff_dense)
        return int(n)

    def _ssm_params(self) -> int:
        d = self.d_model
        s = self.ssm
        di = s.d_inner(d)
        nh = s.n_heads(d)
        in_proj = d * (2 * di + 2 * s.n_groups * s.d_state + nh)
        conv = (di + 2 * s.n_groups * s.d_state) * s.d_conv
        out_proj = di * d
        return in_proj + conv + out_proj + 3 * nh  # A_log, D, dt_bias


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def smoke_shape(kind: str = "train") -> ShapeConfig:
    return {
        "train": ShapeConfig("smoke_train", 64, 2, "train"),
        "prefill": ShapeConfig("smoke_prefill", 64, 2, "prefill"),
        "decode": ShapeConfig("smoke_decode", 64, 2, "decode"),
    }[kind]
