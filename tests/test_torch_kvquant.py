"""The port's KV wire quantization (``kernels/kv_quant.py``, its plain
versions on the CPU) and its wire pricing (``serving/resources.py``)
against the JAX package: the Pallas kernels in interpret mode, their
oracles in ``kernels/ref.py`` and ``KVCompressionConfig``, on the same
inputs made with numpy from a seed."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import adapter_quant as jax_aq
from repro.kernels import kv_quant as JKQ
from repro.kernels import ref as R
from repro.serving.resources import KVCompressionConfig as JKVConfig
from repro.serving.resources import kv_bytes_per_token as j_kv_bpt
from repro_torch.convert import array_to_tensor
from repro_torch.kernels import adapter_quant, checks, kv_quant, ref
from repro_torch.kernels.kv_quant import kv_dequantize, kv_quantize
from repro_torch.serving.engine import ServingHardware
from repro_torch.serving.resources import (PAGE_TOKENS, KVCompressionConfig,
                                           kv_bytes_per_token)

SWEEP = [(128, 256), (64, 128), (32, 384)]     # tests/test_kvcomp.py


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: one intra-op thread keeps torch from
    competing for the cores with the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _levels(packed: np.ndarray, bits: int) -> np.ndarray:
    """The quantization levels a packed array holds, as int32."""
    if bits == 8:
        return packed.astype(np.int32)
    return ref.unpack_int4(torch.from_numpy(np.array(packed))).numpy().astype(
        np.int32)


def _block(seed, T, C, dtype=np.float32):
    x = np.random.default_rng(seed).standard_normal((T, C)).astype(
        np.float32)
    # exact halves after division hit round-half-to-even, and a zero
    # channel takes scale 1
    x[:4, 0] = [0.5, -1.5, 2.5, 127.0]
    x[:, -1] = 0.0
    if dtype != np.float32:
        x = np.asarray(jnp.asarray(x, jnp.bfloat16))
    return x


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("T,C", SWEEP)
def test_kv_quantize_matches_jax(bits, T, C, dtype):
    x = _block(T + C + bits, T, C, np.float32 if dtype == "f32" else "bf16")
    jx, tx = jnp.asarray(x), array_to_tensor(x)
    packed, scales = kv_quantize(tx, bits)
    j_packed, j_scales = JKQ.kv_quantize(jx, bits=bits)
    assert packed.dtype == (torch.int8 if bits == 8 else torch.uint8)
    assert packed.shape == (T if bits == 8 else T // 2, C)
    assert scales.shape == (1, C) and scales.dtype == torch.float32
    # XLA may compute absmax / qmax through a reciprocal, one f32 ulp off
    # the IEEE quotient the port takes (the JAX package's own test allows
    # this rtol)
    np.testing.assert_allclose(scales.numpy(), np.asarray(j_scales),
                               rtol=1e-6, atol=0)
    if dtype == "f32":
        np.testing.assert_array_equal(packed.numpy(), np.asarray(j_packed))
    else:
        got = _levels(packed.numpy(), bits)
        want = _levels(np.asarray(j_packed), bits)
        # bf16 values put x / scale on exact halves often enough that a
        # scale one ulp off flips a rounding: the bytes are equal in every
        # channel whose scales agree, and within one level elsewhere
        same = scales.numpy()[0] == np.asarray(j_scales)[0]
        np.testing.assert_array_equal(got[:, same], want[:, same])
        assert np.abs(got - want).max() <= 1
    # dequantize the JAX artifact on both sides: the same multiply
    jp, js = array_to_tensor(np.asarray(j_packed)), array_to_tensor(
        np.asarray(j_scales))
    for od, jod in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        out = kv_dequantize(jp, js, bits, od)
        j_out = JKQ.kv_dequantize(j_packed, j_scales, bits=bits,
                                  out_dtype=jod)
        assert out.dtype == od and out.shape == (T, C)
        np.testing.assert_array_equal(out.float().numpy(),
                                      np.asarray(j_out, np.float32))
    # and the oracles
    q_ref, s_ref = R.kv_quant_ref(jx, bits)
    q, s = ref.kv_quant_ref(tx, bits)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-6)


@pytest.mark.parametrize("bits", [8, 4])
def test_roundtrip_within_error_bound_and_matches_jax(bits):
    x = _block(1, 128, 256)
    tx = array_to_tensor(x)
    packed, scales = kv_quantize(tx, bits)
    out = kv_dequantize(packed, scales, bits)
    worst = checks.check_kv_error(tx, out, bits)
    assert 0 < worst <= kv_quant.ERROR_BOUND[bits] * (1 + 1e-5)
    np.testing.assert_allclose(
        kv_quant.kv_roundtrip_ref(tx, bits).numpy(),
        np.asarray(JKQ.kv_roundtrip_ref(jnp.asarray(x), bits)),
        rtol=1e-6, atol=0)
    np.testing.assert_array_equal(kv_quant.kv_roundtrip_ref(tx, bits).numpy(),
                                  out.numpy())


@pytest.mark.parametrize("bits", [8, 4])
def test_roundtrip_exact_on_a_quantization_grid(bits):
    """tests/test_kvcomp.py's grid: a power-of-two scale round-trips
    bit-exactly."""
    qmax = kv_quant.QMAX[bits]
    k = np.random.default_rng(3).integers(-qmax, qmax + 1,
                                          size=(128, 128)).astype(np.float32)
    k[0, :] = qmax
    x = torch.from_numpy(k / 32.0)
    packed, scales = kv_quantize(x, bits)
    assert torch.equal(kv_dequantize(packed, scales, bits), x)


def test_pack_int4_is_the_kernel_packing():
    """Every int4 level in both nibbles: pack_int4 gives JAX's bytes and
    unpack_int4 sign-extends them back."""
    lv = np.arange(-7, 8, dtype=np.int8)
    q = np.stack(np.meshgrid(lv, lv, indexing="ij")).reshape(2, -1)
    # a second token pair at level 7 pins every channel's scale to 1/8
    q = np.concatenate([q, np.full_like(q, 7)])
    packed = ref.pack_int4(torch.from_numpy(q))
    assert packed.dtype == torch.uint8 and packed.shape == (2, 225)
    # the JAX kernel packs x = q / 8, whose channels' absmax is 7/8
    x = q.astype(np.float32) / 8.0
    j_packed, _ = JKQ.kv_quantize(jnp.asarray(x), bits=4)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(j_packed))
    assert torch.equal(ref.unpack_int4(packed), torch.from_numpy(q))


def test_bad_arguments_raise():
    with pytest.raises(ValueError):
        kv_quantize(torch.zeros(31, 128), 4)     # odd T cannot pack
    with pytest.raises(ValueError):
        kv_quantize(torch.zeros(32, 128), 2)
    with pytest.raises(ValueError):
        kv_quantize(torch.zeros(2, 32, 128), 8)
    packed, scales = kv_quantize(torch.zeros(32, 128), 8)
    with pytest.raises(ValueError):
        kv_dequantize(packed, scales, 3)
    with pytest.raises(TypeError):               # int8 values as int4
        kv_dequantize(packed, scales, 4)
    with pytest.raises(ValueError):
        kv_dequantize(packed, scales[:, :64], 8)
    # all-zero channels quantize to zero with a finite scale
    assert torch.equal(scales, torch.ones(1, 128))
    assert float(kv_dequantize(packed, scales).abs().max()) == 0.0


def test_constants_match_jax():
    assert kv_quant.BLOCK_T == JKQ.BLOCK_T == PAGE_TOKENS
    assert kv_quant.QMAX == JKQ.QMAX
    assert kv_quant.WIRE_RATIO == JKQ.WIRE_RATIO
    assert kv_quant.ERROR_BOUND == JKQ.ERROR_BOUND
    assert adapter_quant.ERROR_BOUND is kv_quant.ERROR_BOUND
    assert adapter_quant.QMAX is kv_quant.QMAX


@pytest.mark.parametrize("bits,mode", [(8, "int8"), (4, "int4")])
def test_sim_constants_match_measured_artifacts(bits, mode):
    """The port's wire pricing IS its kernel's packed output, and both are
    the JAX package's."""
    got = kv_quant.measured_wire_ratio(bits, device="cpu")
    assert got == JKQ.measured_wire_ratio(bits)
    assert got == KVCompressionConfig.WIRE_RATIO[mode] == \
        JKVConfig.WIRE_RATIO[mode]
    assert kv_quant.WIRE_RATIO[bits] == KVCompressionConfig.WIRE_RATIO[mode]
    assert kv_quant.ERROR_BOUND[bits] == \
        KVCompressionConfig.ERROR_BOUND[mode] == JKVConfig.ERROR_BOUND[mode]


@pytest.mark.parametrize("bits,mode", [(8, "int8"), (4, "int4")])
@pytest.mark.parametrize("T", [128, 64, 32, 6])
def test_block_wire_bytes_match_packed_artifacts(bits, mode, T):
    """Tail blocks included: the sim's wire bytes are the packed output's,
    in the port and in JAX."""
    C = 256
    packed, scales = kv_quantize(torch.randn(T, C), bits)
    raw = 2 * T * C
    wire = KVCompressionConfig(mode=mode).wire_bytes(raw,
                                                     bytes_per_token=2 * C)
    assert wire == packed.nbytes + scales.nbytes
    assert wire == JKVConfig(mode=mode).wire_bytes(raw,
                                                   bytes_per_token=2 * C)
    ratio = kv_quant.measured_wire_ratio(bits, n_tokens=T, n_channels=C,
                                         device="cpu")
    assert wire / raw == ratio == JKQ.measured_wire_ratio(
        bits, n_tokens=T, n_channels=C)
    if T < kv_quant.BLOCK_T:
        assert wire / raw > KVCompressionConfig.WIRE_RATIO[mode]


@pytest.mark.parametrize("mode", ["int8", "int4", "lowrank"])
def test_kv_compression_config_matches_jax(mode):
    port, jax_cfg = KVCompressionConfig(mode=mode), JKVConfig(mode=mode)
    assert port.wire_ratio == jax_cfg.wire_ratio
    assert port.error_bound == jax_cfg.error_bound
    for raw in (0, 1, 255, 256, 257, 4096, 65536 * 3 + 17, 10 ** 9):
        for bpt in (None, 512, 131072, 3):
            assert port.wire_bytes(raw, bpt) == jax_cfg.wire_bytes(raw, bpt)
            wire = port.wire_bytes(raw, bpt)
            want = (0.0 if raw <= 0 else
                    port.kernel_overhead + (raw + wire) / port.mem_bw)
            assert port.compress_time(raw, bpt) == want
            assert port.decompress_time(raw, bpt) == want
    for nbytes, n in ((0, 4), (100, 4), (99, 3), (24, 4), (10, 0)):
        assert kv_bytes_per_token(nbytes, n) == j_kv_bpt(nbytes, n)


def test_kv_compression_config_validation():
    with pytest.raises(ValueError):
        KVCompressionConfig(mode="fp8")
    with pytest.raises(ValueError):
        KVCompressionConfig(mode="lowrank", lowrank_ratio=0.0)
    with pytest.raises(ValueError):
        KVCompressionConfig(mem_bw=0)


def test_card_figures_replace_the_tpu_defaults():
    """The port prices the H100: one card's data-sheet HBM rate, the same
    in the cost model, the wire pricing and the kernels' bounds."""
    hw = ServingHardware()
    assert KVCompressionConfig().mem_bw == hw.hbm_bw == \
        checks.HBM_BYTES_PER_S == 3.35e12
    assert (hw.peak_flops, hw.hbm_bytes) == (989e12, 80e9)
    assert 0 < KVCompressionConfig().kernel_overhead < 1e-3
    from repro_torch.serving import engine
    assert not hasattr(engine, "REAL_DECODE_STEP_OVERHEAD_S")
    assert not hasattr(ServingHardware, "real_calibrated")


@pytest.mark.parametrize("axis", [-1, -2])
def test_int8_error_bound_matches_jax(axis):
    w = np.random.default_rng(5).standard_normal((3, 16, 40)).astype(
        np.float32)
    tw = torch.from_numpy(w)
    bound = adapter_quant.int8_error_bound(tw, axis=axis)
    np.testing.assert_allclose(
        bound.numpy(), np.asarray(jax_aq.int8_error_bound(jnp.asarray(w),
                                                          axis=axis)),
        rtol=1e-7, atol=0)
    q, s = adapter_quant.adapter_quantize(tw, axis=axis)
    err = (adapter_quant.adapter_dequantize(q, s) - tw).abs()
    assert bool((err <= bound * (1 + 1e-5)).all())
    assert math.isclose(adapter_quant.ERROR_BOUND[8], 1 / 254)


def test_wire_checks_run_on_cpu_tensors():
    """The card's wire checks, rehearsed on CPU tensors (each wrapper is
    its plain version there)."""
    x = torch.randn(64, 96).to(torch.bfloat16)
    for bits in (8, 4):
        res = checks.check_kv_quantize(x, bits)
        deq = checks.check_kv_dequantize(res["packed"], res["scales"], bits,
                                         torch.float32)["out"]
        assert checks.check_kv_error(x, deq, bits) <= \
            kv_quant.ERROR_BOUND[bits] * (1 + 1e-5)
        assert checks.kv_quant_bytes(x, bits) == \
            x.nbytes + res["packed"].nbytes + res["scales"].nbytes
        assert checks.kv_dequant_bytes(res["packed"], res["scales"], bits,
                                       torch.float32) == \
            res["packed"].nbytes + res["scales"].nbytes + 4 * x.numel()
    q, s = kv_quantize(x, 8)
    assert torch.equal(checks.library_dequant(q, s)(),
                       kv_dequantize(q, s, 8, torch.float32))
    with pytest.raises(AssertionError):
        checks.check_kv_error(x, x.float() + 1.0, 8)
