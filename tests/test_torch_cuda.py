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
from repro_torch.kernels.jd_delta import jd_delta_

pytestmark = pytest.mark.gpu

SHAPES = [  # B, H, Kv, hd, s_max, bucket, kv_len
    (8, 32, 8, 128, 160, 128, 32),                     # mistral-7b decode
    (8, 32, 8, 128, 160, 128, [1, 7, 63, 64, 65, 100, 127, 128]),
    (3, 4, 1, 64, 300, 256, [200, 256, 5]),
    (2, 2, 1, 32, 64, 64, [64, 1]),
    # long context: eight chunks of 256 positions, split at and around a
    # chunk's edges, empty chunks past the shorter rows
    (8, 32, 8, 128, 2048, 2048, [1, 255, 256, 257, 1044, 1500, 1896, 2048]),
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
    assert fd_mod.LAUNCHES == before + fd_mod.attention_launches(
        case["k"].shape[1])
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
    assert fu_mod.LAUNCHES_LORA == before + fd_mod.attention_launches(
        case["k"].shape[1])            # attention, shrink and expand in one


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("diag", [True, False])
@pytest.mark.parametrize("kcl", [1, 3])
def test_fused_jd_matches_plain(cuda, quant, diag, kcl):
    case, gen = _case(cuda, SHAPES[1], torch.bfloat16, n=6)
    banks = checks.jd_banks(kcl, 6, 16, 32 * 128, 4096, torch.bfloat16, gen,
                            cuda, quant, diag)
    before = fu_mod.LAUNCHES_JD
    checks.check_fused_jd(case, banks)
    assert fu_mod.LAUNCHES_JD == before + 1


# the fused kernels' cluster over a sequence's kv heads: every Kv up to the
# cluster limit, ranks that do and do not fill 16 bytes, d_out that is not
# a multiple of Kv or of 4; each case runs every (rank, d_out) pair, one
# chunk or several as the case's index picks
CLUSTER_RANKS_DOUT = [(1, 256), (15, 4100), (16, 4096), (128, 5120)]


@pytest.mark.parametrize("mode", ["lora", "jd_diag", "jd_full"])
@pytest.mark.parametrize("bank", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("kv", [1, 2, 4, 8, 16])
def test_fused_cluster_shapes(cuda, kv, bank, mode):
    """out == flash_decode's, delta within DELTA_TOL of the plain version,
    a repeat bit for bit, and one launch (two with several chunks)."""
    gen = torch.Generator(device=cuda).manual_seed(kv * 31 + len(mode))
    H, hd, n = 4 * kv, 64, 5
    wdt = torch.float32 if bank == "f32" else torch.bfloat16
    for i, (r, d_out) in enumerate(CLUSTER_RANKS_DOUT):
        several = (i + kv) % 2 == 1
        s_max, bucket, kv_len = ((600, 600, [600, 257, 1]) if several
                                 else (160, 128, [128, 33, 1]))
        case = checks.attention_case(3, H, kv, hd, s_max, bucket, kv_len,
                                     torch.bfloat16, gen, cuda)
        case["ids"] = torch.tensor([4, 0, 2], dtype=torch.int32,
                                   device=cuda)
        q, k, v, kl, ids = (case[x] for x in ("q", "k", "v", "kv_len",
                                              "ids"))
        if mode == "lora":
            banks = checks.lora_banks(n, r, H * hd, d_out, wdt, gen, cuda,
                                      bank == "int8")
            check, fn, counter = checks.check_fused_lora, \
                fu_mod.fused_decode_lora, "LAUNCHES_LORA"
            args = (ids, banks["A"], banks["B"], banks["a_scale"],
                    banks["b_scale"])
        else:
            banks = checks.jd_banks(2, n, r, H * hd, d_out, wdt, gen, cuda,
                                    bank == "int8", mode == "jd_diag")
            check, fn, counter = checks.check_fused_jd, \
                fu_mod.fused_decode_jd, "LAUNCHES_JD"
            args = (ids, banks["U"], banks["V"], banks["sigma"],
                    banks["cluster_of"], banks["u_scale"], banks["v_scale"])
        before = getattr(fu_mod, counter)
        check(case, banks)
        assert getattr(fu_mod, counter) == before + \
            fd_mod.attention_launches(bucket)
        for a, b in zip(fn(q, k, v, kl, *args), fn(q, k, v, kl, *args)):
            assert torch.equal(a, b), (r, d_out, several)
    torch.cuda.synchronize()


def test_fused_refuses_kv_heads_past_the_cluster(cuda):
    """Kv 32 raises ValueError before any launch, in all four modes."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    case = checks.attention_case(2, 64, 32, 64, 64, 64, [64, 9],
                                 torch.bfloat16, gen, cuda)
    ids = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    pc = checks.paged_case(dict(case, ids=ids), 16, 2, gen)
    lb = checks.lora_banks(2, 8, 64 * 64, 128, torch.bfloat16, gen, cuda,
                           False)
    jb = checks.jd_banks(1, 2, 8, 64 * 64, 128, torch.bfloat16, gen, cuda,
                         False, True)
    la = (ids, lb["A"], lb["B"])
    ja = (ids, jb["U"], jb["V"], jb["sigma"], jb["cluster_of"])
    cont = (case["q"], case["k"], case["v"], case["kv_len"])
    paged = (case["q"], pc["k_pages"], pc["v_pages"], pc["page_table"],
             case["kv_len"])
    torch.cuda.synchronize()
    before = (fu_mod.LAUNCHES_LORA, fu_mod.LAUNCHES_JD,
              fu_mod.LAUNCHES_LORA_PAGED, fu_mod.LAUNCHES_JD_PAGED)
    for fn, a in ((fu_mod.fused_decode_lora, cont + la),
                  (fu_mod.fused_decode_jd, cont + ja),
                  (fu_mod.fused_decode_lora_paged, paged + la),
                  (fu_mod.fused_decode_jd_paged, paged + ja)):
        with pytest.raises(ValueError, match="at most 16"):
            fn(*a)
    assert (fu_mod.LAUNCHES_LORA, fu_mod.LAUNCHES_JD,
            fu_mod.LAUNCHES_LORA_PAGED, fu_mod.LAUNCHES_JD_PAGED) == before
    torch.cuda.synchronize()


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[-1]])
def test_attention_entry_points_repeat_bit_for_bit(cuda, shape, kv_dtype):
    """Two calls of every attention entry point on the same inputs give
    the same bits (one chunk, and eight chunks merged), and the fused
    kernels' out equals flash_decode's."""
    from repro_torch.kernels.flash_decode import flash_decode_paged
    gen = torch.Generator(device=cuda).manual_seed(12)
    B, H, Kv, hd, s_max, bucket, kv_len = shape
    case = checks.attention_case(B, H, Kv, hd, s_max, bucket, kv_len,
                                 torch.bfloat16, gen, cuda,
                                 kv_dtype=kv_dtype)
    case["ids"] = torch.randint(0, 5, (B,), generator=gen, device=cuda,
                                dtype=torch.int32)
    pc = checks.paged_case(case, 128, 5, gen)
    lb = checks.lora_banks(5, 16, H * hd, 256, torch.bfloat16, gen, cuda,
                           False)
    jb = checks.jd_banks(2, 5, 16, H * hd, 256, torch.bfloat16, gen, cuda,
                         False, diag=False)
    q, k, v, kl, ids = (case[x] for x in ("q", "k", "v", "kv_len", "ids"))
    pa = (q, pc["k_pages"], pc["v_pages"], pc["page_table"], kl)
    la = (ids, lb["A"], lb["B"])
    ja = (ids, jb["U"], jb["V"], jb["sigma"], jb["cluster_of"])
    calls = [lambda: flash_decode(q, k, v, kl),
             lambda: flash_decode_paged(*pa),
             lambda: fu_mod.fused_decode_lora(q, k, v, kl, *la),
             lambda: fu_mod.fused_decode_lora_paged(*pa, *la),
             lambda: fu_mod.fused_decode_jd(q, k, v, kl, *ja),
             lambda: fu_mod.fused_decode_jd_paged(*pa, *ja)]
    for fn in calls:
        for a, b in zip(fn(), fn()):
            assert torch.equal(a, b), "two calls on the same inputs differ"
    out = calls[0]()[0]
    for fn in calls[2:4]:
        assert torch.equal(fn()[0], out)
    torch.cuda.synchronize()


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
    ((2, 16, 16, 4096), -1, torch.bfloat16),   # long rows: 4 warps a row
    ((2, 16, 4096, 16), -1, torch.bfloat16),   # 16-wide rows: 2 lanes a row
    ((2, 1, 4096, 16), -2, torch.bfloat16),    # columns: a cluster of 4
    ((3, 7, 100), -1, torch.float32),          # 25 chunks a row: 4 warps
    ((3, 100, 70), -2, torch.float32),         # 280-byte rows: element loads
    ((2, 16, 16, 4096), -1, torch.float32),    # 4 warps, chunks re-read
    ((2, 16, 4096, 16), -1, torch.float32),    # 4 lanes a row
    ((2, 1, 4096, 16), -2, torch.float32),     # a cluster of 4, 4 chunks a row
    ((1, 12000, 16), -2, torch.bfloat16),      # past 4 blocks: element loads
    ((1, 40000, 16), -2, torch.bfloat16),      # past 4 blocks: element loads
    ((3, 9, 7), -1, torch.bfloat16),           # 14-byte rows: element loads
    ((4, 64, 48), -2, torch.float32),          # 12 chunks a row: tiles
    ((5, 8, 64), -1, torch.bfloat16),          # 8 lanes a row
])
def test_adapter_quantize_equals_plain(cuda, shape, axis, dtype):
    gen = torch.Generator(device=cuda).manual_seed(1)
    w = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    # channel 0 has absmax 127, so scale 1 and exact half-step ties (round
    # half to even); channel 1 absmax 254, scale 2, ties again
    ties = torch.tensor([0.5, 1.5, 2.5, -2.5, 0.0, 3.5, 127.0], device=cuda,
                        dtype=dtype)
    m = w.view(-1, *shape[-2:])
    if axis == -1:
        m[0, 0, :7] = ties
        m[0, 1, :5] = 2 * ties[[0, 1, 2, 3, 6]]
        w[..., -1, :] = 0
    else:
        m[0, :7, 0] = ties
        m[0, :5, 1] = 2 * ties[[0, 1, 2, 3, 6]]
        w[..., -1] = 0
    checks.check_adapter_quantize(w, axis)
    q, s = aq_mod.adapter_quantize(w, axis=axis)
    assert float(s.view(-1)[0]) == 1.0
    torch.cuda.synchronize()


@pytest.mark.parametrize("axis", [-1, -2])
def test_adapter_quantize_unaligned_bank(cuda, axis):
    """A bank 2 bytes past a 16-byte boundary takes the element-load
    kernels, exactly as well."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    shape = (2, 64, 16) if axis == -2 else (2, 16, 64)
    buf = torch.randn(2 * 64 * 16 + 1, generator=gen,
                      device=cuda).to(torch.bfloat16)
    w = buf[1:].view(shape)
    assert w.is_contiguous() and w.data_ptr() % 16 == 2
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
    with pytest.raises(ValueError):                     # head_dim above 256
        flash_decode(torch.zeros((2, 2, 264), device=cuda),
                     torch.zeros((2, 8, 1, 264), device=cuda),
                     torch.zeros((2, 8, 1, 264), device=cuda), kl[:2])
    with pytest.raises(ValueError):     # a head group past shared memory
        flash_decode(torch.zeros((1, 128, 256), device=cuda),
                     torch.zeros((1, 8, 1, 256), device=cuda),
                     torch.zeros((1, 8, 1, 256), device=cuda), kl[:1])


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


def _group_banks(cuda, seed=4):
    """Packed banks of every layout the dequantize kernel takes: rows with
    C % 16 == 0 (an A bank, 16-wide B/U and Sigma), cols with C == 16 (a V
    basis), odd widths, per-layer slices of stacked banks, banks whose
    values are not 16-byte aligned, and an empty bank."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def packed(shape, axis):
        w = torch.randn(shape, generator=gen, device=cuda) * 0.05
        return aq_mod.adapter_quantize(w, axis=axis)

    def unaligned(q, s):
        buf = torch.empty(q.numel() + 1, dtype=torch.int8, device=cuda)
        buf[1:].copy_(q.view(-1))
        return buf[1:].view(q.shape), s

    pairs = [packed((16, 16, 4096), -1), packed((16, 4096, 16), -1),
             packed((1, 4096, 16), -2), packed((16, 16, 16), -1),
             packed((3, 50, 70), -2), packed((2, 3, 7, 100), -2),
             packed((4, 64, 16), -1)]
    qa, sa = packed((3, 4, 16, 64), -1)
    qv, sv = packed((3, 1, 64, 16), -2)
    pairs += [(qa[1], sa[1]), (qv[2], sv[2]),
              unaligned(*packed((2, 16, 64), -1)),
              unaligned(*packed((2, 64, 16), -2)),
              (torch.empty((0, 16, 16), dtype=torch.int8, device=cuda),
               torch.empty((0, 16, 1), device=cuda))]
    return pairs


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_adapter_dequantize_group_equals_plain(cuda, out_dtype):
    pairs = _group_banks(cuda)
    assert len(pairs) <= aq_mod.GROUP_CAP
    before = aq_mod.LAUNCHES_DEQUANT
    checks.check_adapter_dequantize_group(pairs, out_dtype)
    assert aq_mod.LAUNCHES_DEQUANT == before + 1
    for q, s in pairs:                   # the one-bank case, same kernel
        checks.check_adapter_dequantize(q, s, out_dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("n_banks", [1, 16, 17, 40])
def test_adapter_dequantize_group_launches(cuda, n_banks):
    """One launch per GROUP_CAP banks; empty banks take none."""
    full = [p for p in _group_banks(cuda) if p[0].numel()]
    pairs = [full[i % len(full)] for i in range(n_banks)]
    empty = (torch.empty((2, 0, 16), dtype=torch.int8, device=cuda),
             torch.empty((2, 0, 1), device=cuda))
    before = aq_mod.LAUNCHES_DEQUANT
    checks.check_adapter_dequantize_group(pairs + [empty], torch.float32)
    assert aq_mod.LAUNCHES_DEQUANT == before + -(-n_banks
                                                // aq_mod.GROUP_CAP)
    before = aq_mod.LAUNCHES_DEQUANT
    assert aq_mod.adapter_dequantize_group([empty])[0].shape == (2, 0, 16)
    assert aq_mod.LAUNCHES_DEQUANT == before
    torch.cuda.synchronize()


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


# bf16 x and t: the tensor-core shrink and expand at their edges
# (T, d_in, d_out, n, r, tile): tiles of 8 and 16 rows and of 15 (a slab
# cut short), d_in / d_out not multiples of 8 (rows not 16-byte aligned),
# ranks that pad N or K, and full width; the expand's bank in bf16 and in
# f32 (split into three bf16 pieces)
TC_EDGES = [(64, 70, 33, 3, 4, 8), (48, 70, 33, 3, 12, 16),
            (64, 136, 72, 4, 16, 16), (40, 64, 33, 3, 33, 8),
            (32, 70, 40, 2, 64, 16), (45, 37, 19, 2, 16, 16),
            (256, 256, 256, 4, 33, 128), (1024, 4096, 1024, 8, 64, 128),
            (4096, 4096, 4096, 32, 16, 128)]


def _repeats(fn) -> None:
    a, b = fn(), fn()
    assert torch.equal(a, b), "two calls on the same inputs differ"


@pytest.mark.parametrize("b_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sweep", TC_EDGES)
def test_sgmv_tensor_core_edges(cuda, sweep, b_dtype):
    T, d_in, d_out, n, r, tile = sweep
    bf16 = torch.bfloat16
    gen = torch.Generator(device=cuda).manual_seed(8)
    case = checks.sweep_case(T, d_in, n, tile, bf16, gen, cuda)
    A = _rand(gen, (n, r, d_in), 1 / 8, bf16)
    B = _rand(gen, (n, d_out, r), 1 / 4, b_dtype)
    before = (sg_mod.LAUNCHES_SHRINK, sg_mod.LAUNCHES_EXPAND)
    t = checks.check_sgmv_shrink(case, A)["out"].to(bf16)
    checks.check_sgmv_expand(case, t, B)
    assert (sg_mod.LAUNCHES_SHRINK, sg_mod.LAUNCHES_EXPAND) == \
        (before[0] + 1, before[1] + 1)
    tid = case["tile_ids"]
    _repeats(lambda: sg_mod.sgmv_shrink(case["x"], A, tid, block_t=tile))
    _repeats(lambda: sg_mod.sgmv_expand(t, B, tid, block_t=tile))
    torch.cuda.synchronize()


@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_sgmv_mixed_dtypes_match_plain(cuda, x_dtype, w_dtype):
    """An f32 x or A: the CUDA-core shrink; the expand of a bf16 t with an
    f32 B runs on the tensor cores, of an f32 t on the CUDA cores."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    T, d_in, d_out, n, r, tile = 256, 512, 264, 4, 16, 128
    case = checks.sweep_case(T, d_in, n, tile, x_dtype, gen, cuda)
    t = checks.check_sgmv_shrink(case, _rand(gen, (n, r, d_in), 1 / 8,
                                              w_dtype))["out"].to(x_dtype)
    checks.check_sgmv_expand(case, t, _rand(gen, (n, d_out, r), 1 / 4,
                                            w_dtype))


def _offset(t: torch.Tensor, elems: int) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts ``elems`` elements into its
    buffer (off 16-byte alignment for bf16 and 2 <= elems < 8)."""
    buf = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    view = buf[elems:].view(t.shape)
    view.copy_(t)
    return view


def test_grouped_kernels_take_unaligned_views(cuda):
    """bf16 operands (and an f32 V) whose rows are 16-byte multiples but
    whose pointers are not: the tensor-core kernels fill their rings by
    element loads."""
    bf16 = torch.bfloat16
    gen = torch.Generator(device=cuda).manual_seed(10)
    T, d_in, d_out, n, r, tile = 64, 128, 64, 3, 16, 16
    case = checks.sweep_case(T, d_in, n, tile, bf16, gen, cuda)
    A = _rand(gen, (n, r, d_in), 1 / 8, bf16)
    ucase = dict(case, x=_offset(case["x"], 4))
    assert ucase["x"].data_ptr() % 16 and ucase["x"].is_contiguous()
    t = checks.check_sgmv_shrink(ucase, _offset(A, 2))["out"].to(bf16)
    # both fills feed the same sums in the same order
    assert torch.equal(t, checks.check_sgmv_shrink(case, A)["out"].to(bf16))
    checks.check_sgmv_expand(ucase, _offset(t, 4), _rand(
        gen, (n, d_out, r), 1 / 4, bf16))
    V = _rand(gen, (2, d_in, r), 0.05, bf16)
    cluster_of = (torch.arange(n, device=cuda) % 2).to(torch.int32)
    tile_cids = cluster_of[case["tile_ids"].long()]
    checks.check_jd_shrink_scale(ucase, _offset(V, 6), None, tile_cids,
                                 cluster_of)
    checks.check_jd_shrink_scale(ucase, _offset(V.float(), 2), None,
                                 tile_cids, cluster_of)


@pytest.mark.parametrize("v_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("r,d_in,tile", [(8, 192, 8), (12, 70, 16),
                                         (16, 4096, 128), (33, 136, 8),
                                         (64, 64, 16), (4, 100, 8)])
def test_jd_shrink_scale_tensor_cores(cuda, scaled, r, d_in, tile, v_dtype):
    """bf16 x: a bf16 V through ldmatrix.trans, an f32 V in three bf16
    pieces; aligned and unaligned rows, ranks that pad N."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    n, kcl = 6, 3
    case = checks.sweep_case(64 if tile < 128 else 1024, d_in, n, tile,
                             torch.bfloat16, gen, cuda)
    V = _rand(gen, (kcl, d_in, r), 0.05, v_dtype)
    cluster_of = (torch.arange(n, device=cuda) % kcl).to(torch.int32)
    tile_cids = cluster_of[case["tile_ids"].long()]
    sig = _rand(gen, (n, r), 1.0, torch.float32)
    sig_tok = sig[case["ids"].long()].to(torch.bfloat16) if scaled else None
    before = jd_mod.LAUNCHES
    checks.check_jd_shrink_scale(case, V, sig_tok, tile_cids, cluster_of)
    assert jd_mod.LAUNCHES == before + 1
    _repeats(lambda: jd_mod.jd_shrink_scale(case["x"], V, sig_tok,
                                            tile_cids, block_t=tile))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("r", [4, 16, 33])
def test_sigma_bmm_matches_plain(cuda, r, dtype):
    gen = torch.Generator(device=cuda).manual_seed(5)
    case = checks.sweep_case(48, r, 4, 8, dtype, gen, cuda)
    before = sg_mod.LAUNCHES_SIGMA
    checks.check_sigma_bmm(case, case["x"], _rand(gen, (4, r, r), 0.25,
                                                  torch.float32))
    assert sg_mod.LAUNCHES_SIGMA == before + 1


@pytest.mark.parametrize("t_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s_dtype", [torch.bfloat16, torch.float32])
def test_sigma_bmm_at_the_prefill_shape(cuda, t_dtype, s_dtype):
    """4096 rows in 32 tiles of 128 at rank 16 (compress_apply's prefill
    batch), aligned and from an unaligned view; two calls, same bits."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    case = checks.sweep_case(4096, 16, 32, 128, t_dtype, gen, cuda)
    sig = _rand(gen, (32, 16, 16), 0.25, s_dtype)
    before = sg_mod.LAUNCHES_SIGMA
    got = checks.check_sigma_bmm(case, case["x"], sig)["out"]
    assert sg_mod.LAUNCHES_SIGMA == before + 1
    _repeats(lambda: sg_mod.sigma_bmm(case["x"], sig, case["tile_ids"]))
    ux, us = _offset(case["x"], 2), _offset(sig, 1)
    assert ux.data_ptr() % 16 and us.data_ptr() % 16
    assert torch.equal(checks.check_sigma_bmm(case, ux, us)["out"], got)


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
    q8 = torch.zeros((2, 4, 6), dtype=torch.int8, device=cuda)
    s8 = torch.ones((2, 4, 1), device=cuda)
    with pytest.raises(ValueError):                     # a scale on the CPU
        aq_mod.adapter_dequantize_group([(q8, s8), (q8, s8.cpu())])
    with pytest.raises(ValueError):                     # a CPU bank first
        aq_mod.adapter_dequantize_group([(q8.cpu(), s8.cpu()), (q8, s8)])
    with pytest.raises(ValueError):                     # not contiguous
        aq_mod.adapter_dequantize_group(
            [(q8.transpose(1, 2), torch.ones((2, 6, 1), device=cuda))])
    with pytest.raises(TypeError):                      # fp16 out
        aq_mod.adapter_dequantize_group([(q8, s8)], out_dtype=torch.half)


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
    logical content: out, l, m and delta bit for bit, over a permuted
    table in a pool with spare pages."""
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
    n = fd_mod.attention_launches(pc["page_table"].shape[1] * page_t)
    assert (fd_mod.LAUNCHES_PAGED, fu_mod.LAUNCHES_LORA_PAGED,
            fu_mod.LAUNCHES_JD_PAGED) == (before[0] + n, before[1] + n,
                                          before[2] + n)
    # the delta, paged against contiguous (the partials stay in the kernel)
    la = (pc["ids"], lb["A"], lb["B"], lb["a_scale"], lb["b_scale"])
    _, p_delta = fu_mod.fused_decode_lora_paged(
        pc["q"], pc["k_pages"], pc["v_pages"], pc["page_table"],
        pc["kv_len"], *la)
    _, c_delta = fu_mod.fused_decode_lora(
        pc["q"], pc["k_logical"], pc["v_logical"], pc["kv_len"], *la)
    assert torch.equal(p_delta, c_delta)
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


# (T, C): each path of csrc/kv_quant.cu.  C a multiple of every lane
# width (8 quantize, 4 dequantize to f32, 8 to bf16) takes the vector
# paths; 4100 only dequantize's f32 one; 131, 33 and 1 the scalar paths.
# T up to KVQ_RESIDENT = 128 tokens is held in registers; 130 and 1024 read
# the block again chunk by chunk
KV_SHAPES = [(128, 65536), (128, 256), (64, 131), (32, 384), (6, 33), (2, 1),
             (2, 65536), (2, 33), (128, 4100), (130, 4096), (130, 131),
             (1024, 4096), (1024, 131), (1024, 1)]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,C", KV_SHAPES)
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


def _offset_by_one(shape, dtype, device):
    """A contiguous tensor whose storage offset of one element breaks
    16-byte alignment."""
    n = shape[0] * shape[1]
    t = torch.empty(n + 1, dtype=dtype, device=device)[1:].view(shape)
    assert t.is_contiguous() and t.data_ptr() % 16
    return t


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kv_quant_misaligned_equals_plain(cuda, dtype, bits):
    """x, the packed values and the scales one element off 16-byte
    alignment: the kernels take their scalar paths, bit for bit."""
    from repro_torch.kernels import kv_quant as kq
    T, C = 130, 4096
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = _offset_by_one((T, C), dtype, cuda)
    x.copy_(torch.randn((T, C), generator=gen, device=cuda))
    res = checks.check_kv_quantize(x, bits)
    packed = _offset_by_one(tuple(res["packed"].shape), res["packed"].dtype,
                            cuda)
    packed.copy_(res["packed"])
    scales = _offset_by_one((1, C), torch.float32, cuda)
    scales.copy_(res["scales"])
    before = kq.LAUNCHES_DEQUANT
    for od in (torch.float32, torch.bfloat16):
        checks.check_kv_dequantize(packed, scales, bits, od)
    assert kq.LAUNCHES_DEQUANT == before + 2
    torch.cuda.synchronize()


@pytest.mark.parametrize("bits", [8, 4])
def test_kv_quant_near_ties_equals_plain(cuda, bits):
    """Values on and one f32 ulp either side of each channel's half
    levels, (k + 1/2) * scale: where the kernel's screened level (a
    multiply by the reciprocal) must fall back to the division."""
    from repro_torch.kernels import kv_quant as kq
    T, C, qmax = 128, 4096, kq.QMAX[bits]
    gen = torch.Generator(device=cuda).manual_seed(11)
    absmax = torch.rand((1, C), generator=gen, device=cuda) * 10 + 1e-3
    scale = absmax / torch.full_like(absmax, float(qmax))
    k = torch.randint(-qmax, qmax, (T, C), generator=gen, device=cuda)
    x = (k.float() + 0.5) * scale
    step = torch.randint(-1, 2, (T, C), generator=gen, device=cuda)
    x = torch.where(step > 0, torch.nextafter(x, x + 1),
                    torch.where(step < 0, torch.nextafter(x, x - 1), x))
    x[0] = absmax[0]                    # pins each channel's scale
    for dtype in (torch.float32, torch.bfloat16):
        res = checks.check_kv_quantize(x.to(dtype), bits)
        checks.check_kv_dequantize(res["packed"], res["scales"], bits,
                                   torch.float32)
    torch.cuda.synchronize()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kv_quant_wide_scales_equal_plain(cuda, dtype, bits):
    """Channels whose absmax spans 2^-40..2^40, and a few at 1e-30 and
    1e35 (scales outside the division-free quotient's range, where the
    kernel divides), every value within its channel's absmax: bit for
    bit, 128 tokens (held) and 130 (read again)."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    C = 4096
    a = torch.exp2(torch.rand((1, C), generator=gen, device=cuda) * 80 - 40)
    a[0, :4] = torch.tensor([1e-30, 3e-31, 1e35, 2e34], device=cuda)
    for T in (128, 130):
        u = torch.rand((T, C), generator=gen, device=cuda) * 2 - 1
        x = (u * a).to(dtype)
        x[0] = a[0].to(dtype)
        bound = x[0].float().abs()
        x = torch.where(x.float().abs() > bound, x[0].expand_as(x), x)
        checks.check_kv_quantize(x, bits)
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


# -- jd_delta_: a projection group's jd delta, added in place ----------------

# Mistral-7B's projections: q/k/v read d_model, o reads the heads
QKV_OUTS, O_OUTS = [4096, 1024, 1024], [4096]
JD_SHAPES = [(1, 128), (1, 1020), (1, 4096), (1, 333), (8, 1)]


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("outs", [QKV_OUTS, O_OUTS], ids=["qkv", "o"])
@pytest.mark.parametrize("B,S", JD_SHAPES)
def test_jd_delta_matches_lora_plain(cuda, B, S, outs, diag, k):
    """The kernels against lora.apply's einsums on the card, bf16, at
    Mistral's widths; (8, 1) takes eight adapters over the clusters.
    Tolerance: checks.JD_DELTA_TOL (a rank-r stage summed in another
    order may round to the other bf16 neighbour)."""
    from repro_torch.kernels import jd_delta as jdd
    gen = torch.Generator(device=cuda).manual_seed(B * 7919 + S)
    case = checks.jd_delta_case(B, S, 4096, outs, k, 1000, 16, gen, cuda,
                                diag=diag)
    before = jdd.LAUNCHES
    r = checks.check_jd_delta(case)
    assert jdd.LAUNCHES == before + 2
    assert r["equal_share"] > 0.9


@pytest.mark.parametrize("outs", [QKV_OUTS[1:], [520]], ids=["kv", "o"])
@pytest.mark.parametrize("bank_dtype", [torch.bfloat16, torch.float32])
def test_jd_delta_banks_and_scaling(cuda, bank_dtype, outs):
    """f32 banks (the fused_q8 path's dequantized ones, rounded to bf16 as
    the einsums' casts do), a group of two, a width that no 128 columns
    divide, a scaling other than 1, int64 cluster ids."""
    gen = torch.Generator(device=cuda).manual_seed(len(outs))
    case = checks.jd_delta_case(2, 200, 4096, outs, 3, 50, 16, gen, cuda,
                                bank_dtype=bank_dtype)
    for p in case["banks"]:
        p["cluster_of"] = p["cluster_of"].long()
    checks.check_jd_delta(case, scaling=0.375)


def test_jd_delta_writes_only_y_and_repeats(cuda):
    """In place: the outputs returned are the tensors given, the memory
    around them, x and the banks keep their bits, and a second run on the
    same inputs gives the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    case = checks.jd_delta_case(1, 1020, 4096, QKV_OUTS, 8, 1000, 16, gen,
                                cuda)
    pad = 64
    bufs, ys = [], []
    for y in case["ys"]:
        buf = torch.full((y.numel() + 2 * pad,), 7.0, dtype=y.dtype,
                         device=cuda)
        view = buf[pad:pad + y.numel()].view(y.shape)
        view.copy_(y)
        bufs.append(buf)
        ys.append(view)
    x0 = case["x"].clone()
    banks0 = [{n: t.clone() for n, t in p.items()} for p in case["banks"]]
    want = checks.jd_delta_plain(case)
    got = jd_delta_(case["x"], ys, case["banks"], case["ids"])
    for g, y, buf in zip(got, ys, bufs):
        assert g is y
        assert torch.all(buf[:pad] == 7.0) and torch.all(buf[-pad:] == 7.0)
    assert torch.equal(case["x"], x0)
    for p, p0 in zip(case["banks"], banks0):
        assert all(torch.equal(p[n], p0[n]) for n in p)
    again = [y.clone() for y in case["ys"]]
    jd_delta_(case["x"], again, case["banks"], case["ids"])
    for a, g, w in zip(again, got, want):
        assert torch.equal(a, g)
        assert (a.float() - w.float()).abs().max() < 0.1


def test_jd_delta_refuses_what_the_kernels_do_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    case = checks.jd_delta_case(2, 40, 256, [64], 2, 9, 16, gen, cuda)
    x, ys, banks, ids = (case[n] for n in ("x", "ys", "banks", "ids"))
    with pytest.raises(ValueError):                     # f32 activations
        jd_delta_(x.float(), ys, banks, ids)
    with pytest.raises(ValueError):                     # rank 8
        jd_delta_(x, ys, [{**banks[0], "U": banks[0]["U"][..., :8]}], ids)
    with pytest.raises(ValueError):                     # ids on the CPU
        jd_delta_(x, ys, banks, ids.cpu())
    with pytest.raises(ValueError):                     # x not contiguous
        jd_delta_(x.transpose(0, 1).contiguous().transpose(0, 1), ys,
                  banks, ids)
    with pytest.raises(ValueError):                     # four targets
        jd_delta_(x, ys * 4, banks * 4, ids)
    with pytest.raises(ValueError):                     # V of another width
        jd_delta_(x, ys, [{**banks[0], "V": banks[0]["V"][:, :128]}], ids)
    U = banks[0]["U"]
    U1 = torch.empty(U.numel() + 1, dtype=U.dtype, device=cuda)[1:]
    with pytest.raises(ValueError):                     # U off 16 bytes
        jd_delta_(x, ys, [{**banks[0], "U": U1.view(U.shape).copy_(U)}],
                  ids)


def _shifted(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


@pytest.mark.parametrize("diag", [False, True])
def test_jd_delta_takes_indices_and_sigma_off_16_bytes(cuda, diag):
    """sigma, cluster_of and ids are read an element at a time: one
    element past a 16-byte boundary they take the kernels (not the
    einsums) and give the plain einsums' result."""
    from repro_torch.kernels import jd_delta as jdd
    gen = torch.Generator(device=cuda).manual_seed(13)
    case = checks.jd_delta_case(3, 70, 512, [64, 32], 3, 10, 16, gen, cuda,
                                diag=diag, bank_dtype=torch.float32)
    for p in case["banks"]:
        for k in ("sigma", "cluster_of"):
            p[k] = _shifted(p[k])
    case["ids"] = _shifted(case["ids"].int())
    assert jdd.takes(case["x"], case["ys"], case["banks"], case["ids"])
    before = jdd.LAUNCHES
    checks.check_jd_delta(case)
    assert jdd.LAUNCHES == before + 2


def _jd_setup(cuda, layers=2, n=40, k=4, seed=5, cluster_dtype=torch.int32):
    """Mistral-7B at full width cut to ``layers`` layers, its weights and
    jd bundles on q, k, v and o (bf16; adapter i in cluster i % k)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.param import init_params
    cfg = dataclasses.replace(get_config("mistral-7b"), num_layers=layers)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    params = init_params(tf.model_defs(cfg), gen, cuda)
    r, hd, d = 16, cfg.resolved_head_dim, cfg.d_model
    outs = {"q": cfg.num_heads * hd, "k": cfg.num_kv_heads * hd,
            "v": cfg.num_kv_heads * hd, "o": d}
    bundles = {"layers": {}}
    for t, do in outs.items():
        di = cfg.num_heads * hd if t == "o" else d
        bundles["layers"][t] = {
            "U": checks._randn((layers, k, do, r), gen, cuda, torch.bfloat16,
                               r ** -0.5),
            "V": checks._randn((layers, k, di, r), gen, cuda, torch.bfloat16,
                               di ** -0.5),
            "sigma": checks._randn((layers, n, r, r), gen, cuda,
                                   torch.bfloat16, r ** -0.5),
            "cluster_of": (torch.arange(n, device=cuda, dtype=cluster_dtype)
                           % k).expand(layers, n).contiguous()}
    return cfg, params, bundles


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


# a few bf16 roundings of adapter deltas that fall the other way, carried
# through two layers: relative L2 errors of a bf16 ulp's order (2**-8),
# far under the benchmark's limits on its reference (0.12-0.15)
MODEL_REL_TOL = 2.0 ** -6


@pytest.mark.parametrize("n,cluster_dtype", [
    (40, torch.int32), (10, torch.int32), (9, torch.int64)])
def test_prefill_launches_two_a_group(cuda, monkeypatch, n, cluster_dtype):
    """A full prefill of one sequence: every adapter delta on the kernels
    (4 launches a layer: q/k/v and o, two each), and the logits and K/V
    those of the plain einsums within MODEL_REL_TOL.  With 10 int32 or 9
    int64 cluster ids a layer, layer 1's slice of the stacked cluster_of
    starts off a 16-byte boundary, which the kernels, reading it an element
    at a time, take."""
    from repro_torch import spans
    from repro_torch.kernels import jd_delta as jdd
    from repro_torch.models import lora
    from repro_torch.models import transformer as tf
    cfg, params, bundles = _jd_setup(cuda, n=n, cluster_dtype=cluster_dtype)
    gen = torch.Generator(device=cuda).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, 1020), generator=gen,
                           device=cuda)
    ids = torch.tensor([n - 3], device=cuda)

    def run():
        cache = tf.init_cache(cfg, 1, 1024, device=cuda)
        with torch.no_grad():
            return tf.prefill(params, {"tokens": tokens}, cfg, cache,
                              lora_params=bundles,
                              lora_ctx_proto=lora.LoRAContext(
                                  "jd", None, ids))
    before = jdd.LAUNCHES
    spans.start()
    logits, cache = run()
    counters = spans.take()["counters"]
    assert jdd.LAUNCHES == before + 4 * cfg.num_layers
    assert counters == {"adapter_kernel": 4 * cfg.num_layers}
    monkeypatch.setattr(jdd, "takes", lambda *a: False)
    want, want_cache = run()
    assert jdd.LAUNCHES == before + 4 * cfg.num_layers
    assert _rel(logits, want) < MODEL_REL_TOL
    for key in ("k", "v"):
        assert _rel(cache[key], want_cache[key]) < MODEL_REL_TOL


@pytest.mark.parametrize("decode_path", ["unfused", "fused", "fused_q8"])
def test_decode_step_routes_qkv_to_the_kernels(cuda, monkeypatch,
                                                decode_path):
    """Eight slots with eight adapters over four clusters, one decode
    step: the unfused step's q/k/v and o deltas (4 launches a layer), the
    fused steps' q/k/v (2 a layer; o rides in the attention kernel; the
    int8 banks dequantized to f32 first), the logits those of the plain
    einsums within MODEL_REL_TOL."""
    import numpy as np
    from repro_torch.kernels import jd_delta as jdd
    from repro_torch.serving.real_executor import RealModelExecutor
    from repro_torch.serving.request import Request
    cfg, params, bundles = _jd_setup(cuda)

    def logits():
        ex = RealModelExecutor(cfg, params, bundles, "jd", max_batch=8,
                               s_max=160, decode_path=decode_path,
                               device=cuda)
        for slot in range(8):
            ex.prefill_request(Request(rid=slot, adapter_id=5 * slot + 1,
                                       prompt_len=40 + slot,
                                       max_new_tokens=4),
                               np.random.default_rng(slot).integers(
                                   0, cfg.vocab_size, 40 + slot))
        before = jdd.LAUNCHES
        out = ex.decode_logits()
        return out, jdd.LAUNCHES - before
    got, launches = logits()
    per_layer = 4 if decode_path == "unfused" else 2
    assert launches == per_layer * cfg.num_layers
    monkeypatch.setattr(jdd, "takes", lambda *a: False)
    want, none = logits()
    assert none == 0
    assert _rel(got, want) < MODEL_REL_TOL


def test_lora_routes_on_the_card(cuda):
    """On the card only mode jd in bf16 without a gradient takes the
    kernels: batched, a gradient, f32 activations take the einsums."""
    from repro_torch import spans
    from repro_torch.models import lora
    gen = torch.Generator(device=cuda).manual_seed(9)
    case = checks.jd_delta_case(2, 24, 256, [64, 32, 32], 2, 9, 16, gen,
                                cuda)
    x, ys, banks, ids = (case[n] for n in ("x", "ys", "banks", "ids"))
    ctx = lora.LoRAContext("jd", dict(zip("qkv", banks)), ids, 0.5)

    def counted(fn):
        spans.start()
        fn()
        return spans.take()["counters"]
    with torch.no_grad():
        assert counted(lambda: lora.apply_group(
            ctx, ("q", "k", "v"), x, [y.clone() for y in ys])) == {
            "adapter_kernel": 3}
        assert counted(lambda: lora.apply_group(
            ctx, ("q", "k", "v"), x.float(), [y.float() for y in ys])) == {
            "adapter_plain": 3}
    xg = x.clone().requires_grad_()
    assert counted(lambda: lora.apply_group(
        ctx, ("q", "k", "v"), xg, [y.clone() for y in ys])) == {
        "adapter_plain": 3}
    A = checks._randn((9, 16, 256), gen, cuda, torch.bfloat16, 0.05)
    Bm = checks._randn((9, 64, 16), gen, cuda, torch.bfloat16, 0.05)
    with torch.no_grad():
        assert counted(lambda: lora.apply(
            lora.LoRAContext("batched", {"q": {"A": A, "B": Bm}}, ids),
            "q", x, ys[0].clone())) == {"adapter_plain": 1}
