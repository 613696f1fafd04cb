"""The port's MoE block against `repro.models.moe`: routing (weights,
experts, aux loss), the static-capacity dispatch/combine and the expert
FFN, the dense oracle and `moe_fwd` with shared experts; and the checks of
tests/test_moe.py (round trip, capacity, offset window, dense against a
per-token loop) on the port alone."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.models import moe as jmoe
from repro.models.param import init_params as jax_init
from repro_torch import configs as tcfg
from repro_torch.convert import to_torch
from repro_torch.distributed.sharding import use_mesh
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe as tmoe

# f32; the two frameworks sum the expert products in other orders, on
# outputs up to ~50 in magnitude (measured: up to 2.6e-5 apart, where
# large products cancel): 1e-6 of the largest
ATOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch, T=24, seed=0):
    jcfg, cfg = smoke_config(arch), tcfg.smoke_config(arch)
    jp = jax_init(jmoe.moe_defs(jcfg), jax.random.PRNGKey(seed),
                  dtype_override=jnp.float32)
    x = np.random.default_rng(seed).standard_normal(
        (T, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, to_torch(jax.tree.map(np.asarray, jp)), x


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "granite-moe-3b-a800m"])
def test_route_matches_jax(arch):
    jcfg, cfg, jp, tp, x = _setup(arch)
    jw, ji, jaux = jmoe._route(jp, jnp.asarray(x), jcfg)
    tw, ti, taux = tmoe._route(tp, torch.from_numpy(x), cfg)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, atol=1e-6)
    assert abs(float(taux) - float(jaux)) < 1e-6


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "granite-moe-3b-a800m"])
def test_moe_fwd_and_dense_match_jax(arch):
    jcfg, cfg, jp, tp, x = _setup(arch, seed=1)
    x3 = x.reshape(2, 12, -1)
    jy, jaux = jmoe.moe_fwd(jp, jnp.asarray(x3), jcfg)
    ty, taux = tmoe.moe_fwd(tp, torch.from_numpy(x3), cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    assert abs(float(taux) - float(jaux)) < 1e-6
    assert bool(cfg.moe.num_shared) == ("shared" in tp)
    jw, ji, _ = jmoe._route(jp, jnp.asarray(x), jcfg)
    tw, ti, _ = tmoe._route(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(
        tmoe._moe_dense(tp, torch.from_numpy(x), tw, ti, cfg).numpy(),
        np.asarray(jmoe._moe_dense(jp, jnp.asarray(x), jw, ji, jcfg)),
        atol=ATOL)


@pytest.mark.parametrize("offset,n_buckets,capacity", [
    (0, 8, 6), (0, 8, 2), (4, 2, 3), (2, 4, 16)])
def test_dispatch_combine_expert_ffn_match_jax(offset, n_buckets, capacity):
    """Tight capacities drop tokens (trash slot), an offset window sends
    the other experts' choices to the trash bucket: every output equals
    JAX's, including the per-choice eid/slot/valid."""
    rng = np.random.default_rng(2)
    T, k, d, f = 20, 2, 16, 8
    x = rng.standard_normal((T, d)).astype(np.float32)
    topi = rng.integers(0, 8, (T, k)).astype(np.int32)
    topw = rng.random((T, k)).astype(np.float32)
    w = [rng.standard_normal(s).astype(np.float32) * 0.3
         for s in ((n_buckets, d, f), (n_buckets, d, f), (n_buckets, f, d))]
    jb, je, js, jv = jmoe._dispatch(jnp.asarray(x), jnp.asarray(topi),
                                    capacity, n_buckets, offset)
    tb, te, ts, tv = tmoe._dispatch(torch.from_numpy(x),
                                    torch.from_numpy(topi), capacity,
                                    n_buckets, offset)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    for got, want in ((te, je), (ts, js), (tv, jv)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jy = jmoe._expert_ffn(jb, *map(jnp.asarray, w))
    ty = tmoe._expert_ffn(tb, *map(torch.from_numpy, w))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(
        tmoe._combine(ty, te, ts, tv, torch.from_numpy(topw)).numpy(),
        np.asarray(jmoe._combine(jy, je, js, jv, jnp.asarray(topw))),
        atol=ATOL)


def test_dispatch_combine_roundtrip():
    """dispatch -> identity expert -> combine == weighted passthrough."""
    g = torch.Generator().manual_seed(0)
    T, d, E, k, C = 32, 16, 4, 2, 24
    x = torch.randn((T, d), generator=g)
    topi = torch.randint(0, E, (T, k), generator=g)
    buf, eid, slot, valid = tmoe._dispatch(x, topi, C, E)
    y = tmoe._combine(buf, eid, slot, valid, torch.full((T, k), 1.0 / k))
    # capacity is ample => every choice kept => y == x (sum_k w_k x = x)
    np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=1e-5, atol=1e-5)


def test_dispatch_respects_capacity():
    T, d, E, cap = 64, 8, 2, 16
    buf, eid, slot, valid = tmoe._dispatch(
        torch.ones((T, d)), torch.zeros((T, 1), dtype=torch.int32), cap, E)
    assert int(valid.sum()) == cap
    assert float(buf[0].sum()) == cap * d


def test_dispatch_offset_window():
    """Only experts inside [offset, offset+n_local) are bucketed."""
    T, d = 16, 4
    topi = torch.arange(8, dtype=torch.int32)[:, None].repeat(2, 1)
    buf, eid, slot, valid = tmoe._dispatch(torch.ones((T, d)), topi, 4, 2,
                                           bucket_offset=4)
    assert int(valid.sum()) == 4            # experts 4 and 5, two each
    assert float(buf.sum()) == 4 * d


def test_moe_dense_matches_manual():
    cfg = tcfg.smoke_config("deepseek-moe-16b")
    g = torch.Generator().manual_seed(0)
    from repro_torch.models.param import init_params
    p = init_params(tmoe.moe_defs(cfg), g, "cpu",
                    dtype_override=torch.float32)
    x = torch.randn((12, cfg.d_model), generator=g)
    topw, topi, aux = tmoe._route(p, x, cfg)
    y = tmoe._moe_dense(p, x, topw, topi, cfg)
    y_ref = torch.zeros_like(y)
    for t in range(12):
        for j in range(cfg.moe.top_k):
            e = int(topi[t, j])
            h = torch.nn.functional.silu(x[t] @ p["w_gate"][e]) \
                * (x[t] @ p["w_up"][e])
            y_ref[t] += topw[t, j] * (h @ p["w_down"][e])
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), rtol=2e-4,
                               atol=2e-4)
    assert torch.isfinite(aux)


def test_moe_fwd_refuses_a_process_group(monkeypatch):
    """A process group alone does not change moe_fwd's path: without a
    mesh it runs the dense path under any world size (as the JAX module
    does without a mesh); under a mesh with a model axis it runs the
    expert-parallel path, which on a (1, 1) mesh is the plain
    dispatch/combine, and which refuses expert weights that are neither
    whole nor this rank's shard."""
    _, cfg, _, tp, x = _setup("granite-moe-3b-a800m")
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    xt = torch.from_numpy(x)
    w, i, _ = tmoe._route(tp, xt, cfg)
    y, _ = tmoe.moe_fwd(tp, xt[None], cfg)
    assert torch.equal(y[0], tmoe._moe_dense(tp, xt, w, i, cfg))
    m = cfg.moe
    cap = max(int(xt.shape[0] * m.top_k / m.num_experts
                  * m.capacity_factor) + 1, 4)
    buf, eid, slot, valid = tmoe._dispatch(xt, i, cap, m.num_experts)
    plain = tmoe._combine(tmoe._expert_ffn(buf, tp["w_gate"], tp["w_up"],
                                           tp["w_down"]), eid, slot, valid, w)
    one = make_mesh((1, 1), ("data", "model"))
    with use_mesh(one):
        y1, _ = tmoe.moe_fwd(tp, xt[None], cfg)
        assert torch.equal(y1[0], plain)
        with pytest.raises(ValueError, match="neither"):
            tmoe.moe_fwd(dict(tp, w_gate=tp["w_gate"][:, :, :5]), xt[None],
                         cfg)


def test_record_routes_logs_choices_and_margins():
    """Inside record_routes, _route logs each call's experts and how far
    each token's choice is from flipping; outside it logs nothing and its
    outputs are the same."""
    _, cfg, _, tp, x = _setup("granite-moe-3b-a800m", seed=2)
    xt = torch.from_numpy(x)
    with tmoe.record_routes() as routes:
        w, i, aux = tmoe._route(tp, xt, cfg)
    assert tmoe._ROUTES is None and len(routes) == 1
    topi, margin = routes[0]
    assert torch.equal(topi, i)
    probs = torch.softmax(xt @ tp["router"], dim=-1)
    k = cfg.moe.top_k
    kth = probs.gather(1, i[:, -1:].long())[:, 0]
    left = probs.scatter(1, i.long(), -1.0).max(-1).values
    torch.testing.assert_close(margin, kth - left, rtol=0, atol=1e-7)
    assert (margin >= 0).all() and margin.shape == (x.shape[0],) and k > 1
    w2, i2, aux2 = tmoe._route(tp, xt, cfg)
    assert torch.equal(w, w2) and torch.equal(i, i2) and aux == aux2
