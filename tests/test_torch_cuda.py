"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: they skip where there is no CUDA device, and run on the
H100 with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

This file imports neither jax nor the JAX package; whether a card is
present is decided inside the ``cuda`` fixture, never at import.
"""
import pytest
import torch

from repro_torch.kernels import checks
from repro_torch.kernels import flash_decode as fd_mod
from repro_torch.kernels import fused_decode as fu_mod
from repro_torch.kernels.flash_decode import flash_decode

pytestmark = pytest.mark.gpu

SHAPES = [  # B, H, Kv, hd, s_max, bucket, kv_len
    (8, 32, 8, 128, 160, 128, 32),                     # mistral-7b decode
    (8, 32, 8, 128, 160, 128, [1, 7, 63, 64, 65, 100, 127, 128]),
    (3, 4, 1, 64, 300, 256, [200, 256, 5]),
    (2, 2, 1, 32, 64, 64, [64, 1]),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return torch.device("cuda", 0)


def _case(cuda, shape, dtype, seed=0, n=5):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    B, H, Kv, hd, s_max, bucket, kv_len = shape
    case = checks.attention_case(B, H, Kv, hd, s_max, bucket, kv_len, dtype,
                                 gen, cuda)
    case["ids"] = torch.randint(0, n, (B,), generator=gen, device=cuda,
                                dtype=torch.int32)
    return case, gen


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_decode_matches_plain(cuda, shape, dtype):
    case, _ = _case(cuda, shape, dtype)
    before = fd_mod.LAUNCHES
    checks.check_flash_decode(case)
    assert fd_mod.LAUNCHES == before + 1
    torch.cuda.synchronize()


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("shape", SHAPES[:3])
def test_fused_lora_matches_plain(cuda, shape, quant):
    case, gen = _case(cuda, shape, torch.bfloat16, n=5)
    H, hd = shape[1], shape[3]
    banks = checks.lora_banks(5, 16, H * hd, 256, torch.bfloat16, gen, cuda,
                              quant)
    before = fu_mod.LAUNCHES_LORA
    checks.check_fused_lora(case, banks)
    assert fu_mod.LAUNCHES_LORA == before + 2    # attention+shrink, expand


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("diag", [True, False])
@pytest.mark.parametrize("kcl", [1, 3])
def test_fused_jd_matches_plain(cuda, quant, diag, kcl):
    case, gen = _case(cuda, SHAPES[1], torch.bfloat16, n=6)
    banks = checks.jd_banks(kcl, 6, 16, 32 * 128, 4096, torch.bfloat16, gen,
                            cuda, quant, diag)
    before = fu_mod.LAUNCHES_JD
    checks.check_fused_jd(case, banks)
    assert fu_mod.LAUNCHES_JD == before + 2


def test_f32_queries_over_a_bf16_cache(cuda):
    """An f32 model keeps the bf16 KV cache (the JAX default)."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    case = checks.attention_case(4, 8, 2, 64, 96, 64, [3, 64, 40, 17],
                                 torch.float32, gen, cuda,
                                 kv_dtype=torch.bfloat16)
    case["ids"] = torch.tensor([0, 2, 1, 2], dtype=torch.int32, device=cuda)
    checks.check_flash_decode(case)
    checks.check_fused_lora(case, checks.lora_banks(
        3, 8, 8 * 64, 80, torch.float32, gen, cuda, True))


def test_fused_with_f32_banks_and_f32_attention(cuda):
    case, gen = _case(cuda, SHAPES[2], torch.float32, n=4)
    checks.check_fused_lora(case, checks.lora_banks(
        4, 8, 4 * 64, 96, torch.float32, gen, cuda, False))
    checks.check_fused_jd(case, checks.jd_banks(
        2, 4, 8, 4 * 64, 96, torch.float32, gen, cuda, False, False))


@pytest.mark.parametrize("shape,axis,dtype", [
    ((2, 16, 16, 4096), -1, torch.bfloat16),
    ((2, 16, 4096, 16), -1, torch.bfloat16),
    ((2, 1, 4096, 16), -2, torch.bfloat16),
    ((3, 7, 100), -1, torch.float32),
    ((3, 100, 70), -2, torch.float32),
])
def test_adapter_quantize_equals_plain(cuda, shape, axis, dtype):
    gen = torch.Generator(device=cuda).manual_seed(1)
    w = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    w.view(-1)[:6] = torch.tensor([0.5, 1.5, 2.5, -2.5, 0.0, 3.5],
                                  device=cuda, dtype=dtype)
    if axis == -1:
        w[..., -1, :] = 0
    else:
        w[..., -1] = 0
    checks.check_adapter_quantize(w, axis)


def test_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    case, _ = _case(cuda, SHAPES[0], torch.bfloat16)
    q, k, v, kl = case["q"], case["k"], case["v"], case["kv_len"]
    with pytest.raises(ValueError):
        flash_decode(q.transpose(0, 1).contiguous().transpose(0, 1), k, v, kl)
    with pytest.raises(ValueError):
        flash_decode(q, k, v, kl.long())
    with pytest.raises(TypeError):
        flash_decode(q.half(), k.half(), v.half(), kl)
    with pytest.raises(ValueError):
        flash_decode(q, k, v, kl.cpu())
