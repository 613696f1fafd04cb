"""The port's Mamba2/SSD block against `repro.models.ssm`: the causal
conv with and without a carried state, the chunked SSD scan (S a multiple
of the chunk and not, with and without an initial state), the one-token
recurrence, and the block's prefill then decode with an ``ssm_out``
adapter; and the scan against the step-by-step recurrence in the port
alone."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.models import lora as jlora
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.models.param import init_params as jax_init
from repro_torch import configs as tcfg
from repro_torch.convert import ssm_cache, to_torch
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.models.lora import LoRAContext as TCtx
from repro_torch.models.param import init_params

# f32; the two frameworks sum the chunk einsums in other orders (measured
# up to 8.5e-7 of the outputs' largest magnitude)
REL_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().numpy() - want).max()) / float(
        np.abs(want).max())


def _scan_inputs(S, seed, B=2, H=4, P=8, G=2, N=6):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((B, S, H, P)).astype(f),
            rng.standard_normal((B, S, G, N)).astype(f),
            rng.standard_normal((B, S, G, N)).astype(f),
            (0.1 + rng.random((B, S, H))).astype(f),
            -(0.2 + rng.random(H)).astype(f),
            rng.standard_normal((B, H, N, P)).astype(f))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) \
        if with_state else None
    jo, js = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                               None if st is None else jnp.asarray(st))
    to, ts = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                               None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("S,chunk", [(16, 8), (13, 8), (5, 8)])
def test_ssd_scan_matches_jax(S, chunk, init):
    """S % chunk != 0 pads with dt = 0 steps, which the scan must treat
    exactly as JAX's does; an initial state enters the first chunk."""
    xh, bg, cg, dt, A, s0 = _scan_inputs(S, seed=S + chunk)
    s0 = s0 if init else None
    jy, jf = jssm.ssd_scan(*map(jnp.asarray, (xh, bg, cg, dt, A)), chunk,
                           None if s0 is None else jnp.asarray(s0))
    ty, tf = tssm.ssd_scan(*map(torch.from_numpy, (xh, bg, cg, dt, A)),
                           chunk, None if s0 is None else torch.from_numpy(s0))
    assert ty.dtype == tf.dtype == torch.float32
    assert tuple(ty.shape) == xh.shape
    assert _rel_err(ty, jy) < REL_TOL
    assert _rel_err(tf, jf) < REL_TOL


def test_ssd_decode_step_matches_jax():
    xh, bg, cg, dt, A, s0 = _scan_inputs(1, seed=3)
    jy, js = jssm.ssd_decode_step(*map(jnp.asarray, (xh, bg, cg, dt, A, s0)))
    ty, ts = tssm.ssd_decode_step(*map(torch.from_numpy,
                                       (xh, bg, cg, dt, A, s0)))
    assert _rel_err(ty, jy) < REL_TOL
    assert _rel_err(ts, js) < REL_TOL


@pytest.mark.parametrize("S", [16, 11])
def test_scan_equals_the_recurrence(S):
    """The chunked scan over S tokens equals S one-token decode steps
    (from the same initial state), in the port alone."""
    xh, bg, cg, dt, A, s0 = map(torch.from_numpy, _scan_inputs(S, seed=7))
    y, final = tssm.ssd_scan(xh, bg, cg, dt, A, 4, s0)
    state, ys = s0, []
    for t in range(S):
        yt, state = tssm.ssd_decode_step(xh[:, t:t + 1], bg[:, t:t + 1],
                                         cg[:, t:t + 1], dt[:, t:t + 1], A,
                                         state)
        ys.append(yt)
    assert _rel_err(torch.cat(ys, 1), y.numpy()) < REL_TOL
    assert _rel_err(state, final.numpy()) < REL_TOL


@pytest.mark.parametrize("mode", ["single", "batched"])
def test_block_prefill_then_decode_matches_jax(mode):
    """ssm_block_fwd on mamba2's smoke config (S = 13, chunk 16) with an
    ssm_out adapter: prefill, then three decode steps from its cache."""
    jcfg, cfg = smoke_config("mamba2-2.7b"), tcfg.smoke_config("mamba2-2.7b")
    jp = jax_init(jssm.ssm_defs(jcfg), jax.random.PRNGKey(0),
                  dtype_override=jnp.float32)
    # a non-zero dt_bias and A_log, so both enter the comparison
    rng = np.random.default_rng(1)
    H = cfg.ssm.n_heads(cfg.d_model)
    jp = dict(jp, dt_bias=jnp.asarray(rng.standard_normal(H), jnp.float32),
              A_log=jnp.asarray(rng.standard_normal(H), jnp.float32))
    tp = to_torch(jax.tree.map(np.asarray, jp))
    di, r, n = cfg.ssm.d_inner(cfg.d_model), 4, 3
    if mode == "single":
        ad = {"a": rng.standard_normal((r, di)),
              "b": rng.standard_normal((cfg.d_model, r))}
        ids = None
    else:
        ad = {"A": rng.standard_normal((n, r, di)),
              "B": rng.standard_normal((n, cfg.d_model, r))}
        ids = np.array([2, 0], np.int32)
    ad = {"ssm_out": {k: (0.05 * v).astype(np.float32) for k, v in ad.items()}}
    jctx = jlora.LoRAContext(mode=mode, params=jax.tree.map(jnp.asarray, ad),
                             ids=None if ids is None else jnp.asarray(ids))
    tctx = TCtx(mode=mode, params=to_torch(ad),
                ids=None if ids is None else torch.from_numpy(ids).long())
    x = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    jc = jssm.SSMCache.zeros(2, jcfg, dtype=jnp.float32)
    tc = tssm.SSMCache.zeros(2, cfg, device="cpu", dtype=torch.float32)
    jy, jc = jssm.ssm_block_fwd(jp, jnp.asarray(x), jcfg, mode="prefill",
                                cache=jc, lora_ctx=jctx)
    ty, tc = tssm.ssm_block_fwd(tp, torch.from_numpy(x), cfg, mode="prefill",
                                cache=tc, lora_ctx=tctx)
    assert _rel_err(ty, jy) < REL_TOL
    got = ssm_cache(jc)
    assert tc.index == got.index == 13
    assert _rel_err(tc.conv, got.conv.numpy()) < REL_TOL
    assert _rel_err(tc.state, got.state.numpy()) < REL_TOL
    for t in range(3):
        x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jc = jssm.ssm_block_fwd(jp, jnp.asarray(x1), jcfg, mode="decode",
                                    cache=jc, lora_ctx=jctx)
        ty, tc = tssm.ssm_block_fwd(tp, torch.from_numpy(x1), cfg,
                                    mode="decode", cache=tc, lora_ctx=tctx)
        assert _rel_err(ty, jy) < REL_TOL
        assert tc.index == int(jc.index) == 14 + t
    assert _rel_err(tc.state, jc.state) < REL_TOL
    assert tc.conv.dtype == torch.float32 and tc.state.dtype == torch.float32


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_ssm_in_adapter_is_refused(arch):
    """lora.target_dims("ssm_in") is the whole in-projection's width, but
    the delta is added to the x branch alone: JAX fails to reshape it (in
    ``_project``); the port raises a ValueError that names both widths,
    for the config's own adapter tree."""
    jcfg, cfg = smoke_config(arch), tcfg.smoke_config(arch)
    rng = np.random.default_rng(0)
    lora = jax.tree.map(
        lambda d: (0.05 * rng.standard_normal(d.shape)).astype(np.float32),
        jtf.lora_defs_tree(jcfg), is_leaf=lambda x: hasattr(x, "shape"))
    layer0 = jax.tree.map(lambda a: a.reshape((-1,) + a.shape[-2:])[0],
                          lora["layers"])
    assert "ssm_in" in layer0
    jp = jax_init(jssm.ssm_defs(jcfg), jax.random.PRNGKey(0),
                  dtype_override=jnp.float32)
    x = np.zeros((2, 4, cfg.d_model), np.float32)
    with pytest.raises(Exception, match="reshape"):
        jssm._project(jp, jnp.asarray(x), jcfg, jlora.LoRAContext(
            mode="single", params=layer0))
    params = init_params(ttf.model_defs(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    di = cfg.ssm.d_inner(cfg.d_model)
    with pytest.raises(ValueError, match=f"width {di}"):
        ttf.forward(params, cfg, tokens=torch.zeros((2, 4), dtype=torch.long),
                    mode="train", lora_params=to_torch(lora),
                    lora_ctx_proto=TCtx(mode="single", params=None))
