"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: they skip where there is no CUDA device, and run on the
H100 with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

This file imports neither jax nor the JAX package; whether a card is
present is decided inside the ``cuda`` fixture, never at import.
"""
import pytest
import torch

from repro_torch.kernels import adapter_quant as aq_mod
from repro_torch.kernels import checks
from repro_torch.kernels import flash_decode as fd_mod
from repro_torch.kernels import fused_decode as fu_mod
from repro_torch.kernels import jd_apply as jd_mod
from repro_torch.kernels import sgmv as sg_mod
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


# -- adapter_dequantize and the grouped kernels ------------------------------


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,axis", [((16, 16, 4096), -1),
                                        ((16, 4096, 16), -1),
                                        ((1, 4096, 16), -2),
                                        ((2, 3, 7, 100), -2)])
def test_adapter_dequantize_equals_plain(cuda, shape, axis, out_dtype):
    gen = torch.Generator(device=cuda).manual_seed(3)
    w = torch.randn(shape, generator=gen, device=cuda) * 0.05
    q, s = aq_mod.adapter_quantize(w, axis=axis)
    before = aq_mod.LAUNCHES_DEQUANT
    checks.check_adapter_dequantize(q, s, out_dtype)
    assert aq_mod.LAUNCHES_DEQUANT == before + 1


def _rand(gen, shape, std, dtype):
    return (torch.randn(shape, generator=gen, device=gen.device)
            * std).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sweep", checks.SGMV_SWEEP + [
    (4096, 4096, 4096, 32, 16, 128),            # mistral-7b width
    (40, 96, 64, 5, 12, 8), (20, 70, 33, 3, 64, 16)])
def test_sgmv_matches_plain(cuda, sweep, dtype):
    T, d_in, d_out, n, r, tile = sweep
    gen = torch.Generator(device=cuda).manual_seed(4)
    case = checks.sweep_case(T, d_in, n, tile, dtype, gen, cuda)
    A = _rand(gen, (n, r, d_in), 1 / 8, dtype)
    B = _rand(gen, (n, d_out, r), 1 / 4, dtype)
    before = (sg_mod.LAUNCHES_SHRINK, sg_mod.LAUNCHES_EXPAND)
    t = checks.check_sgmv_shrink(case, A)["out"]
    checks.check_sgmv_expand(case, t.to(dtype), B)
    assert (sg_mod.LAUNCHES_SHRINK, sg_mod.LAUNCHES_EXPAND) == \
        (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("r", [4, 16, 33])
def test_sigma_bmm_matches_plain(cuda, r, dtype):
    gen = torch.Generator(device=cuda).manual_seed(5)
    case = checks.sweep_case(48, r, 4, 8, dtype, gen, cuda)
    before = sg_mod.LAUNCHES_SIGMA
    checks.check_sigma_bmm(case, case["x"], _rand(gen, (4, r, r), 0.25,
                                                  torch.float32))
    assert sg_mod.LAUNCHES_SIGMA == before + 1


@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("kcl,d_in,tile", [(1, 192, 8), (3, 192, 8),
                                           (8, 4096, 128)])
def test_jd_shrink_scale_matches_plain(cuda, scaled, kcl, d_in, tile):
    gen = torch.Generator(device=cuda).manual_seed(6)
    n, r = 6, 16
    case = checks.sweep_case(64 if tile == 8 else 1024, d_in, n, tile,
                             torch.bfloat16, gen, cuda)
    V = _rand(gen, (kcl, d_in, r), 0.05, torch.float32)
    cluster_of = (torch.arange(n, device=cuda) % kcl).to(torch.int32)
    tile_cids = cluster_of[case["tile_ids"].long()]
    sig = _rand(gen, (n, r), 1.0, torch.float32)
    sig_tok = sig[case["ids"].long()].to(torch.bfloat16) if scaled else None
    before = jd_mod.LAUNCHES
    checks.check_jd_shrink_scale(case, V, sig_tok, tile_cids, cluster_of)
    assert jd_mod.LAUNCHES == before + 1


@pytest.mark.parametrize("diag", [True, False])
def test_ops_apply_matches_plain_chain(cuda, diag):
    """The composed entry points on mixed-adapter tokens, ragged groups."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=cuda).manual_seed(7)
    T, d_in, d_out, n, r, k = 300, 512, 384, 9, 16, 3
    x = _rand(gen, (T, d_in), 1.0, torch.bfloat16)
    ids = torch.randint(0, n, (T,), generator=gen, device=cuda,
                        dtype=torch.int32)
    A = _rand(gen, (n, r, d_in), 0.05, torch.bfloat16)
    B = _rand(gen, (n, d_out, r), 0.05, torch.bfloat16)
    y = ops.lora_apply(x, A, B, ids, tile=32, scaling=0.5)
    checks.check_chain("lora_apply", y, checks.lora_chain_plain(
        x, A, B, ids, 0.5))
    U = _rand(gen, (k, d_out, r), 0.05, torch.float32)
    V = _rand(gen, (k, d_in, r), 0.05, torch.float32)
    sig = _rand(gen, (n, r) if diag else (n, r, r), 0.5, torch.float32)
    cluster_of = (torch.arange(n, device=cuda) % k).to(torch.int32)
    y = ops.jd_apply(x, U, V, sig, cluster_of, ids, tile=32)
    checks.check_chain("jd_apply", y, checks.jd_chain_plain(
        x, U, V, sig, cluster_of, ids))


def test_grouped_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from repro_torch.kernels.jd_apply import jd_shrink_scale
    from repro_torch.kernels.sgmv import sgmv_expand, sgmv_shrink, sigma_bmm
    x = torch.zeros((16, 64), device=cuda)
    A = torch.zeros((2, 8, 64), device=cuda)
    tid = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):                     # rank above 64
        sgmv_shrink(x, torch.zeros((2, 65, 64), device=cuda), tid, block_t=8)
    with pytest.raises(ValueError):                     # tiles do not cut x
        sgmv_shrink(x, A, tid, block_t=4)
    with pytest.raises(ValueError):                     # int64 tile ids
        sgmv_shrink(x, A, tid.long(), block_t=8)
    with pytest.raises(ValueError):                     # ids on the CPU
        sgmv_shrink(x, A, tid.cpu(), block_t=8)
    with pytest.raises(TypeError):                      # fp16 activations
        sgmv_shrink(x.half(), A, tid, block_t=8)
    with pytest.raises(ValueError):                     # width mismatch
        sgmv_shrink(x[:, :32].contiguous(), A, tid, block_t=8)
    with pytest.raises(ValueError):                     # not contiguous
        sgmv_expand(torch.zeros((8, 16), device=cuda).T, A, tid, block_t=8)
    with pytest.raises(ValueError):                     # sigma not (n, r, r)
        sigma_bmm(torch.zeros((16, 8), device=cuda),
                  torch.zeros((2, 8, 4), device=cuda), tid, block_t=8)
    with pytest.raises(ValueError):                     # sigma_tok shape
        jd_shrink_scale(x, torch.zeros((1, 64, 8), device=cuda),
                        torch.zeros((16, 4), device=cuda), tid, block_t=8)
    with pytest.raises(ValueError):                     # scale shape
        aq_mod.adapter_dequantize(
            torch.zeros((2, 4, 6), dtype=torch.int8, device=cuda),
            torch.ones((2, 4, 6), device=cuda))
    with pytest.raises(TypeError):                      # not int8
        aq_mod.adapter_dequantize(torch.zeros((2, 4, 6), device=cuda),
                                  torch.ones((2, 4, 1), device=cuda))


# -- paged KV decode and KV wire quantization ---------------------------------

PAGED_SHAPES = [  # B, H, Kv, hd, s_max, bucket, kv_len
    (8, 32, 8, 128, 160, 128, [1, 7, 63, 64, 65, 100, 127, 128]),
    (8, 32, 8, 128, 2048, 2048, [1024, 1500, 2048, 1100, 1337, 2000, 1, 64]),
    (3, 4, 1, 64, 300, 256, [200, 256, 5]),
]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("page_t", [16, 128])
@pytest.mark.parametrize("shape", PAGED_SHAPES)
def test_paged_equals_contiguous_bitwise(cuda, shape, page_t, kv_dtype,
                                         quant):
    """All three paged variants against the contiguous kernels on the same
    logical content: out, l, m, the shrink's partials and delta bit for
    bit, over a permuted table in a pool with spare pages."""
    gen = torch.Generator(device=cuda).manual_seed(page_t + len(shape))
    B, H, Kv, hd, s_max, bucket, kv_len = shape
    case = checks.attention_case(B, H, Kv, hd, s_max, bucket, kv_len,
                                 torch.bfloat16, gen, cuda,
                                 kv_dtype=kv_dtype)
    case["ids"] = torch.randint(0, 5, (B,), generator=gen, device=cuda,
                                dtype=torch.int32)
    pc = checks.paged_case(case, page_t, 37, gen)
    before = (fd_mod.LAUNCHES_PAGED, fu_mod.LAUNCHES_LORA_PAGED,
              fu_mod.LAUNCHES_JD_PAGED)
    checks.check_flash_decode_paged(pc)
    lb = checks.lora_banks(5, 16, H * hd, 256, torch.bfloat16, gen, cuda,
                           quant)
    checks.check_fused_lora_paged(pc, lb)
    jb = checks.jd_banks(2, 5, 16, H * hd, 256, torch.bfloat16, gen, cuda,
                         quant, diag=False)
    checks.check_fused_jd_paged(pc, jb)
    assert (fd_mod.LAUNCHES_PAGED, fu_mod.LAUNCHES_LORA_PAGED,
            fu_mod.LAUNCHES_JD_PAGED) == (before[0] + 1, before[1] + 2,
                                          before[2] + 2)
    # the first launch's partials, paged against contiguous
    from repro_torch.kernels.flash_decode import (contiguous_launch_args,
                                                  paged_launch_args)
    dims = (B, H, Kv, hd)
    a_scale = lb["a_scale"] if quant else torch.ones(
        (5, 16, 1), device=cuda)
    common = (pc["kv_len"], pc["ids"], None, lb["A"], a_scale, 16, dims)
    _, p_part = fu_mod._attn_shrink(
        pc["q"], pc["k_pages"], pc["v_pages"], *common,
        paged_launch_args(pc["k_pages"], pc["v_pages"], pc["page_table"],
                          page_t, pc["page_table"].shape[1]))
    _, c_part = fu_mod._attn_shrink(
        pc["q"], pc["k_logical"], pc["v_logical"], *common,
        contiguous_launch_args(pc["k_logical"], pc["v_logical"]))
    assert torch.equal(p_part, c_part)
    torch.cuda.synchronize()


def test_paged_entries_past_kv_len_are_never_read(cuda):
    """Table entries past ceil(kv_len / page_t) may hold anything: the
    kernel never reads them (the TPU kernel fetches and masks them)."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    case = checks.attention_case(4, 8, 2, 64, 256, 256, [10, 256, 100, 1],
                                 torch.bfloat16, gen, cuda)
    pc = checks.paged_case(case, 16, 3, gen)
    want = _paged_run(pc)
    table = pc["page_table"].clone()
    for b, n in enumerate([10, 256, 100, 1]):
        table[b, -(-n // 16):] = 2 ** 30           # far outside the pool
    got = _paged_run(dict(pc, page_table=table))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    torch.cuda.synchronize()


def _paged_run(pc):
    from repro_torch.kernels.flash_decode import flash_decode_paged
    return flash_decode_paged(pc["q"], pc["k_pages"], pc["v_pages"],
                              pc["page_table"], pc["kv_len"])


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,C", [(128, 65536), (128, 256), (64, 131),
                                 (32, 384), (6, 33), (2, 1)])
def test_kv_quant_equals_plain(cuda, T, C, dtype, bits):
    """Packed bytes, scales and both output types bit for bit; odd C; a
    zero channel, exact halves; and the round trip within ERROR_BOUND."""
    from repro_torch.kernels import kv_quant as kq
    gen = torch.Generator(device=cuda).manual_seed(T + C)
    x = torch.randn((T, C), generator=gen, device=cuda)
    halves = torch.tensor([0.5, 1.5, -2.5, 3.5], device=cuda)
    x.view(-1)[:4] = halves[:min(4, x.numel())]
    x[:, -1] = 0
    x = x.to(dtype)
    before = (kq.LAUNCHES_QUANT, kq.LAUNCHES_DEQUANT)
    res = checks.check_kv_quantize(x, bits)
    for od in (torch.float32, torch.bfloat16):
        out = checks.check_kv_dequantize(res["packed"], res["scales"], bits,
                                         od)["out"]
    assert (kq.LAUNCHES_QUANT, kq.LAUNCHES_DEQUANT) == (before[0] + 1,
                                                        before[1] + 2)
    deq = kq.kv_dequantize(res["packed"], res["scales"], bits)
    checks.check_kv_error(x, deq, bits)
    assert out.shape == (T, C)
    torch.cuda.synchronize()


@pytest.mark.parametrize("bits", [8, 4])
def test_kv_quant_zero_block(cuda, bits):
    from repro_torch.kernels import kv_quant as kq
    x = torch.zeros((128, 300), device=cuda, dtype=torch.bfloat16)
    res = checks.check_kv_quantize(x, bits)
    assert torch.equal(res["scales"], torch.ones((1, 300), device=cuda))
    assert float(kq.kv_dequantize(res["packed"], res["scales"],
                                  bits).abs().max()) == 0.0


def test_measured_wire_ratio_on_the_card(cuda):
    from repro_torch.kernels import kv_quant as kq
    from repro_torch.serving.resources import KVCompressionConfig
    for bits, mode in ((8, "int8"), (4, "int4")):
        assert kq.measured_wire_ratio(bits) == \
            KVCompressionConfig.WIRE_RATIO[mode]


def test_paged_and_wire_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from repro_torch.kernels import kv_quant as kq
    from repro_torch.kernels.flash_decode import flash_decode_paged
    gen = torch.Generator(device=cuda).manual_seed(3)
    case = checks.attention_case(2, 8, 2, 64, 64, 64, [64, 30],
                                 torch.bfloat16, gen, cuda)
    pc = checks.paged_case(case, 16, 2, gen)
    q, kp, vp, pt, kl = (pc[x] for x in ("q", "k_pages", "v_pages",
                                         "page_table", "kv_len"))
    with pytest.raises(ValueError):                     # pool not contiguous
        flash_decode_paged(q, kp.transpose(0, 1).contiguous().transpose(
            0, 1), vp, pt, kl)
    with pytest.raises(ValueError):                     # int64 table
        flash_decode_paged(q, kp, vp, pt.long(), kl)
    with pytest.raises(ValueError):                     # table on the CPU
        flash_decode_paged(q, kp, vp, pt.cpu(), kl)
    with pytest.raises(ValueError):                     # table rows != B
        flash_decode_paged(q, kp, vp, pt[:1].contiguous(), kl)
    with pytest.raises(ValueError):                     # pools differ
        flash_decode_paged(q, kp, vp[:, :8].contiguous(), pt, kl)
    banks = checks.lora_banks(3, 8, 8 * 64, 32, torch.bfloat16, gen, cuda,
                              False)
    with pytest.raises(ValueError):
        fu_mod.fused_decode_lora_paged(q, kp, vp, pt.long(), kl,
                                       torch.zeros(2, dtype=torch.int32,
                                                   device=cuda),
                                       banks["A"], banks["B"])
    with pytest.raises(ValueError):                     # odd T under int4
        kq.kv_quantize(torch.zeros((31, 64), device=cuda), 4)
    with pytest.raises(ValueError):                     # not contiguous
        kq.kv_quantize(torch.zeros((64, 32), device=cuda).T, 8)
    with pytest.raises(TypeError):                      # fp16 block
        kq.kv_quantize(torch.zeros((32, 64), device=cuda).half(), 8)
    with pytest.raises(TypeError):                      # int8 values as int4
        kq.kv_dequantize(torch.zeros((16, 64), dtype=torch.int8,
                                     device=cuda),
                         torch.ones((1, 64), device=cuda), 4)
