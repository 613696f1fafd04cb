"""The port's kernel modules on the CPU (their plain versions) against the
JAX package: `kernels/ref.py` and the Pallas kernels in interpret mode, on
the same inputs made with numpy from a seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro.kernels.adapter_quant import adapter_quantize as jax_quantize
from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro.kernels.fused_decode import fused_decode_jd as jax_fused_jd
from repro.kernels.fused_decode import fused_decode_lora as jax_fused_lora
from repro_torch.convert import array_to_tensor
from repro_torch.kernels import ops, ref
from repro_torch.kernels.adapter_quant import (adapter_quantize,
                                               quantized_nbytes)
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.fused_decode import (fused_decode_jd,
                                              fused_decode_lora)

# f32 inputs: the two sides sum the same products in another order, a few
# f32 ulps apart at these magnitudes
F32_TOL = dict(rtol=2e-5, atol=2e-5)
# bf16 out: one bf16 rounding (8 bits of mantissa) of values of order 1
BF16_TOL = dict(rtol=1e-2, atol=1e-2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps torch from
    competing for the cores with the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.float().numpy()


def _attn_inputs(seed, B, H, Kv, hd, S, n, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Kv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Kv, hd)).astype(np.float32)
    kv_len = rng.integers(1, S + 1, size=B).astype(np.int32)
    ids = rng.integers(0, n, size=B).astype(np.int32)
    if dtype != np.float32:
        q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16)) for x in (q, k, v))
    return q, k, v, kv_len, ids, rng


def _both(*arrays):
    """Each numpy array as a JAX array and as a CPU tensor (bit-exact)."""
    return ([jnp.asarray(a) for a in arrays],
            [array_to_tensor(a) for a in arrays])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,H,Kv,hd,S", [(4, 4, 2, 32, 128),
                                         (8, 8, 2, 64, 96),
                                         (3, 2, 1, 32, 64)])
def test_flash_decode_matches_jax(dtype, B, H, Kv, hd, S):
    npdt = np.float32 if dtype == "f32" else "bf16"
    q, k, v, kv_len, _, _ = _attn_inputs(B * H + S, B, H, Kv, hd, S, 1, npdt)
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _both(q, k, v, kv_len)
    out, l, m = flash_decode(tq, tk, tv, tl)
    assert out.dtype == tq.dtype and out.shape == (B, H, hd)
    assert l.shape == m.shape == (B, Kv, H // Kv, 1)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    np.testing.assert_allclose(_np(out), _np(R.flash_decode_ref(jq, jk, jv,
                                                                 jl)), **tol)
    p_out, p_l, p_m = jax_flash_decode(jq, jk, jv, jl, block_s=32)
    np.testing.assert_allclose(_np(out), _np(p_out), **tol)
    # the softmax stats of the online kernel: same max, same denominator
    np.testing.assert_allclose(m.numpy(), _np(p_m), **F32_TOL)
    np.testing.assert_allclose(l.numpy(), _np(p_l), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(
        _np(ops.decode_attention(tq, tk, tv, tl)), _np(out))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("B,r,n", [(4, 8, 3), (8, 16, 5)])
def test_fused_lora_matches_jax(quant, B, r, n):
    H, Kv, hd, S, d_out = 4, 2, 32, 128, 64
    q, k, v, kv_len, ids, rng = _attn_inputs(10 + B + r, B, H, Kv, hd, S, n)
    A = (rng.standard_normal((n, r, H * hd)) / 8).astype(np.float32)
    Bm = (rng.standard_normal((n, d_out, r)) / 4).astype(np.float32)
    scales = [None, None]
    if quant:   # int8 banks packed by the JAX kernel, handed to both sides
        aq, a_s = jax_quantize(jnp.asarray(A))
        bq, b_s = jax_quantize(jnp.asarray(Bm))
        A, Bm = np.asarray(aq), np.asarray(bq)
        scales = [np.asarray(a_s), np.asarray(b_s)]
    (jq, jk, jv, jl, ji, jA, jB), (tq, tk, tv, tl, ti, tA, tB) = _both(
        q, k, v, kv_len, ids, A, Bm)
    js = [None if s is None else jnp.asarray(s) for s in scales]
    ts = [None if s is None else array_to_tensor(s) for s in scales]
    out, delta = fused_decode_lora(tq, tk, tv, tl, ti, tA, tB, *ts)
    assert delta.dtype == torch.float32 and delta.shape == (B, d_out)
    o_ref, d_ref = R.fused_decode_lora_ref(jq, jk, jv, jl, ji, jA, jB, *js)
    np.testing.assert_allclose(_np(out), _np(o_ref), **F32_TOL)
    np.testing.assert_allclose(delta.numpy(), _np(d_ref), **F32_TOL)
    p_out, p_delta = jax_fused_lora(jq, jk, jv, jl, ji, jA, jB, *js,
                                    block_s=32)
    np.testing.assert_allclose(_np(out), _np(p_out), **F32_TOL)
    np.testing.assert_allclose(delta.numpy(), _np(p_delta), **F32_TOL)
    o2, d2 = ops.fused_lora_decode(tq, tk, tv, tl, ti, tA, tB, *ts)
    assert torch.equal(o2, out) and torch.equal(d2, delta)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("diag", [True, False])
@pytest.mark.parametrize("k_clusters", [1, 3])
def test_fused_jd_matches_jax(quant, diag, k_clusters):
    B, H, Kv, hd, S, n, r, d_out = 8, 4, 2, 32, 128, 6, 8, 64
    q, k, v, kv_len, ids, rng = _attn_inputs(3 if diag else 4, B, H, Kv,
                                             hd, S, n)
    U = (rng.standard_normal((k_clusters, d_out, r)) / 4).astype(np.float32)
    V = (rng.standard_normal((k_clusters, H * hd, r)) / 8).astype(np.float32)
    cluster_of = (np.arange(n) % k_clusters).astype(np.int32)
    sig = (np.abs(rng.standard_normal((n, r))) if diag
           else rng.standard_normal((n, r, r)) / 4).astype(np.float32)
    scales = [None, None]
    if quant:
        uq, u_s = jax_quantize(jnp.asarray(U))
        vq, v_s = jax_quantize(jnp.asarray(V), axis=-2)
        U, V = np.asarray(uq), np.asarray(vq)
        scales = [np.asarray(u_s), np.asarray(v_s)]
    (jq, jk, jv, jl, ji, jU, jV, jsig, jc), tens = _both(
        q, k, v, kv_len, ids, U, V, sig, cluster_of)
    js = [None if s is None else jnp.asarray(s) for s in scales]
    ts = [None if s is None else array_to_tensor(s) for s in scales]
    out, delta = fused_decode_jd(*tens, *ts)
    o_ref, d_ref = R.fused_decode_jd_ref(jq, jk, jv, jl, ji, jU, jV, jsig,
                                         jc, *js)
    np.testing.assert_allclose(_np(out), _np(o_ref), **F32_TOL)
    np.testing.assert_allclose(delta.numpy(), _np(d_ref), **F32_TOL)
    p_out, p_delta = jax_fused_jd(jq, jk, jv, jl, ji, jU, jV, jsig, jc, *js,
                                  block_s=32)
    np.testing.assert_allclose(delta.numpy(), _np(p_delta), **F32_TOL)
    o2, d2 = ops.fused_jd_decode(*tens, *ts)
    assert torch.equal(o2, out) and torch.equal(d2, delta)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape,axis", [((3, 16, 64), -1),
                                        ((2, 5, 64, 8), -2),
                                        ((2, 4, 128, 16), -1)])
def test_adapter_quantize_matches_jax(dtype, shape, axis):
    rng = np.random.default_rng(sum(shape))
    w = rng.standard_normal(shape).astype(np.float32)
    # exact halves after division hit round-half-to-even
    w.reshape(-1)[:8] = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 4.5, 127.0])
    if axis == -1:                      # all-zero channels: scale 1.0
        w[..., -1, :] = 0.0
    else:
        w[..., -1] = 0.0
    if dtype == "bf16":
        w = np.asarray(jnp.asarray(w, jnp.bfloat16))
    (jw,), (tw,) = _both(w)
    q, s = adapter_quantize(tw, axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    for jq, js in (R.adapter_quant_ref(jw, axis=axis),
                   jax_quantize(jw, axis=axis)):
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        # XLA may compute absmax / 127 through a reciprocal, one f32 ulp
        # off the IEEE quotient the port takes; the JAX package's own test
        # holds its Pallas scale to its oracle's at this rtol
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6,
                                   atol=0)
    fp32 = int(np.prod(shape)) * 4
    assert fp32 / quantized_nbytes(shape, axis=axis) > 3.0


def test_adapter_quantize_rejects_a_vector():
    with pytest.raises(ValueError):
        adapter_quantize(torch.zeros(8))
    with pytest.raises(ValueError):
        adapter_quantize(torch.zeros(2, 3, 4), axis=0)


@pytest.mark.parametrize("kind", ["lora", "jd"])
def test_f32_delta_plain_version_matches_pallas_on_bf16(kind):
    """With a bf16 cache the Pallas kernel contracts the f32 attention
    output (``_finalized_attn``), not the bf16 ``out``: the plain version
    with ``f32_delta`` does the same, and the card's checks hold the CUDA
    kernels to it at an f32 tolerance."""
    B, H, Kv, hd, S, n, r, d_out = 4, 4, 2, 32, 64, 3, 8, 48
    q, k, v, kv_len, ids, rng = _attn_inputs(21, B, H, Kv, hd, S, n, "bf16")
    U = (rng.standard_normal((n, d_out, r)) / 4).astype(np.float32)
    V = (rng.standard_normal((n, H * hd, r)) / 8).astype(np.float32)
    if kind == "lora":
        banks = (np.ascontiguousarray(V.transpose(0, 2, 1)), U)
        jax_fn, port_ref = jax_fused_lora, ref.fused_decode_lora_ref
    else:
        sig = (rng.standard_normal((n, r, r)) / 4).astype(np.float32)
        banks = (U, V, sig, np.arange(n, dtype=np.int32))
        jax_fn, port_ref = jax_fused_jd, ref.fused_decode_jd_ref
    jx, tx = _both(q, k, v, kv_len, ids, *banks)
    _, p_delta = jax_fn(*jx, block_s=32)
    _, d32 = port_ref(*tx, f32_delta=True)
    np.testing.assert_allclose(d32.numpy(), _np(p_delta), **F32_TOL)
    # the default contracts the bf16 out, as kernels/ref.py does
    _, d16 = port_ref(*tx)
    _, j16 = (R.fused_decode_lora_ref if kind == "lora"
              else R.fused_decode_jd_ref)(*jx)
    np.testing.assert_allclose(d16.numpy(), _np(j16), **F32_TOL)
    assert float(np.abs(d16.numpy() - d32.numpy()).max()) > 0


def test_card_checks_run_on_cpu_tensors():
    """The checks chip_smoke.py and the gpu tests run on the card, rehearsed
    on CPU tensors (where each wrapper is its plain version).  The fused
    checks hold the delta to the f32 attention output, which the CPU
    wrapper (the bf16-out plain version) meets only in f32."""
    from repro_torch.kernels import checks
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        case = checks.attention_case(4, 8, 2, 32, 80, 64, [1, 30, 64, 70],
                                     dtype, gen, "cpu")
        case["ids"] = torch.tensor([0, 3, 3, 1], dtype=torch.int32)
        out = checks.check_flash_decode(case)["out"]
        checks.check_library_attention(case, out)
        w = torch.randn((2, 8, 40), generator=gen).to(dtype)
        assert checks.check_adapter_quantize(w, -2)["tolerance"] == "exact"
        assert checks.quant_bytes(w, -2) > w.numel()
    for quant in (False, True):
        banks = checks.lora_banks(4, 8, 8 * 32, 48, dtype, gen, "cpu", quant)
        assert checks.check_fused_lora(case, banks)["max_abs_err"] == 0
        # the fused kernels write no l/m
        assert checks.fused_bytes(case, banks, "lora") > \
            checks.attention_bytes(case, stats=False) > 0
        assert checks.attention_bytes(case) - checks.attention_bytes(
            case, stats=False) == 2 * 4 * 4 * 8
        for diag in (True, False):
            jd = checks.jd_banks(2, 4, 8, 8 * 32, 48, dtype, gen, "cpu",
                                 quant, diag)
            assert checks.check_fused_jd(case, jd)["max_abs_err"] == 0
            assert checks.fused_flops(case, jd, "jd") > 0
    ms, by = checks.bound_ms(3.35e9, 1.0)
    assert by == "bytes" and abs(ms - 1.0) < 1e-9
