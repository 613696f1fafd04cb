"""The port's serving control plane (``repro_torch.serving``: router,
prefill, autoscaler, lifecycle, migration, simulator and the rest of
resources) against the JAX package's, scenario by scenario.

Each case builds one scenario behind a committed baseline
(``benchmarks/baselines/BENCH_{serving,fleet,disagg,joint,churn,migrate,
hetero,adaptive}.json``, at its ``--quick`` size or smaller) twice: once
from the JAX modules and once from the port's, with the JAX package's
``ServingHardware``, ``KVCompressionConfig`` and
``AdaptiveCompressionConfig`` figures passed to the port explicitly (the
port's defaults are one H100's).  The two copies run the same Python float
arithmetic in the same order, so their stats must be equal exactly.
"""
import dataclasses
import json
import math
import sys
import types

import numpy as np
import pytest

from repro import configs as j_configs
from repro.serving import autoscaler as j_autoscaler
from repro.serving import engine as j_engine
from repro.serving import lifecycle as j_lifecycle
from repro.serving import migration as j_migration
from repro.serving import prefill as j_prefill
from repro.serving import resources as j_resources
from repro.serving import router as j_router
from repro.serving import simulator as j_simulator
from repro.serving import workload as j_workload
from repro_torch import configs as t_configs
from repro_torch.kernels import sgmv as t_sgmv
from repro_torch.serving import autoscaler as t_autoscaler
from repro_torch.serving import engine as t_engine
from repro_torch.serving import lifecycle as t_lifecycle
from repro_torch.serving import migration as t_migration
from repro_torch.serving import prefill as t_prefill
from repro_torch.serving import resources as t_resources
from repro_torch.serving import router as t_router
from repro_torch.serving import simulator as t_simulator
from repro_torch.serving import workload as t_workload

JAX = types.SimpleNamespace(
    name="jax", configs=j_configs, autoscaler=j_autoscaler, engine=j_engine,
    lifecycle=j_lifecycle, migration=j_migration, prefill=j_prefill,
    resources=j_resources, router=j_router, simulator=j_simulator,
    workload=j_workload)
PORT = types.SimpleNamespace(
    name="port", configs=t_configs, autoscaler=t_autoscaler, engine=t_engine,
    lifecycle=t_lifecycle, migration=t_migration, prefill=t_prefill,
    resources=t_resources, router=t_router, simulator=t_simulator,
    workload=t_workload)


# -- the JAX package's figures, in either package's classes -----------------


def _as(cls, jax_obj):
    return cls(**{f.name: getattr(jax_obj, f.name)
                  for f in dataclasses.fields(jax_obj)})


def hw(p):
    return _as(p.engine.ServingHardware, j_engine.ServingHardware())


def kvc(p, **kw):
    return _as(p.resources.KVCompressionConfig,
               j_resources.KVCompressionConfig(**kw))


def acc(p, **kw):
    return _as(p.resources.AdaptiveCompressionConfig,
               j_resources.AdaptiveCompressionConfig(**kw))


def cfg(p):
    return p.configs.get_config("mistral-7b")


def copies(reqs):
    return [dataclasses.replace(r) for r in reqs]


# -- the scenarios (benchmarks/*.py, each package's own modules) ------------


def throughput(p, n_adapters):
    """serving_throughput.py, and the paper's study at one N."""
    return p.simulator.run_throughput_study(
        cfg(p), [n_adapters], p.workload.WorkloadSpec(n_requests=300,
                                                      new_tokens=10),
        hw=hw(p))[0]


def fleet(p, skew, policy, mode):
    """fleet_throughput.py: 256 adapters, 4 replicas, saturating load."""
    alpha = 0.0 if skew == "uniform" else 1.0
    setting, cluster_of, budget = p.simulator.memory_matched_setup(cfg(p),
                                                                   256)
    fl = p.simulator.build_fleet(
        cfg(p), mode, 256, budget,
        p.router.FleetConfig(n_replicas=4, policy=policy), hw(p),
        cluster_of, setting)
    fl.submit(p.workload.make_workload(p.workload.WorkloadSpec(
        n_requests=600, n_adapters=256, new_tokens=10,
        popularity=skew, zipf_alpha=alpha,
        arrival="poisson", arrival_rate=2000.0)))
    return fl.run().to_dict()


def _bursty(p):
    return p.workload.make_workload(p.workload.WorkloadSpec(
        n_requests=600, n_adapters=256, new_tokens=32, popularity="zipf",
        zipf_alpha=1.0, arrival="gamma", arrival_rate=400.0, burst_cv=4.0))


def disagg(p, auto):
    """disagg_throughput.py: p2d4 fixed, or p4 with an autoscaled decode
    tier under a 350 ms TTFT SLO."""
    if not auto:
        st = p.simulator.run_elastic_study(
            cfg(p), "jd", 256, _bursty(p),
            p.router.FleetConfig(n_replicas=4, policy="cluster_affinity"),
            hw=hw(p), prefill_cfg=p.prefill.PrefillConfig(n_workers=2))
    else:
        st = p.simulator.run_elastic_study(
            cfg(p), "jd", 256, _bursty(p),
            p.router.FleetConfig(n_replicas=2, policy="cluster_affinity"),
            hw=hw(p), prefill_cfg=p.prefill.PrefillConfig(n_workers=4),
            autoscaler_cfg=p.autoscaler.AutoscalerConfig(
                min_replicas=2, max_replicas=12, decision_interval=0.05,
                cooldown_intervals=1, max_step=2),
            slo=p.autoscaler.SLOConfig(ttft_p95=0.35))
    return st.to_dict()


def _phase_shift(p, n=700):
    """joint_budget.py's prompt-heavy then decode-heavy stream."""
    W = p.workload
    base = W.WorkloadSpec(n_adapters=256, popularity="zipf", zipf_alpha=1.0,
                          arrival="gamma", burst_cv=4.0, seed=0)
    a = W.make_workload(dataclasses.replace(
        base, n_requests=600, arrival_rate=220.0, prompt_len_mean=512,
        prompt_len_std=64, new_tokens=4))
    b = W.make_workload(dataclasses.replace(
        base, n_requests=900, arrival_rate=320.0, prompt_len_mean=64,
        prompt_len_std=16, new_tokens=48, seed=1))
    t0 = a[-1].arrival_time
    for r in b:
        r.rid += len(a)
        r.arrival_time += t0
    return (a + b)[:n]


def _report(rep):
    out = {"stats": rep.stats.to_dict(), "metrics": rep.metrics()}
    for k in ("decisions", "wire_by_mode", "migration", "lifecycle",
              "budget"):
        v = getattr(rep, k)
        out[k] = ([dataclasses.asdict(x) for x in v]
                  if k == "decisions" and v is not None else v)
    return out


def joint(p, auto, fabric=None):
    """joint_budget.py at a budget of 6: the static 3x3 split, or the
    jointly autoscaled tiers."""
    reqs = copies(_phase_shift(p))
    fab = fabric(p) if fabric else None
    if not auto:
        rep = p.simulator.run_elastic_study(
            cfg(p), "jd", 256, reqs,
            p.router.FleetConfig(n_replicas=3, policy="cluster_affinity"),
            hw=hw(p), prefill_cfg=p.prefill.PrefillConfig(n_workers=3,
                                                          fabric=fab),
            report=True)
    else:
        rep = p.simulator.run_elastic_study(
            cfg(p), "jd", 256, reqs,
            p.router.FleetConfig(n_replicas=2, policy="cluster_affinity"),
            hw=hw(p), prefill_cfg=p.prefill.PrefillConfig(n_workers=2,
                                                          fabric=fab),
            slo=p.autoscaler.SLOConfig(ttft_p95=0.4),
            budget_cfg=p.resources.BudgetConfig(total_accelerators=6),
            joint_cfg=p.autoscaler.JointAutoscalerConfig(
                decision_interval=0.05, cooldown_intervals=0),
            report=True)
    return _report(rep)


def churn(p, rate):
    """adapter_churn.py's churn_cell: 128 adapters, 3 replicas, Zipf load,
    a Poisson stream of registrations at `rate` per second."""
    S = p.simulator
    setting, cluster_of, budget = S.memory_matched_setup(cfg(p), 128)
    fp_lora = S.serving_footprint(cfg(p), "lora", 128, setting)
    budget += 6 * fp_lora.lora_bytes_per_adapter
    fl = S.build_fleet(cfg(p), "jd", 128, budget,
                       p.router.FleetConfig(n_replicas=3,
                                            policy="cluster_affinity",
                                            spill_requests=1e9),
                       hw(p), cluster_of, setting)
    lc = p.lifecycle.AdapterLifecycle(
        fl, p.lifecycle.LifecycleConfig(refresh_interval=2.0),
        assign_fn=lambda aid: aid % setting["clusters"])
    spec = p.lifecycle.ChurnSpec(
        base=p.workload.WorkloadSpec(
            n_requests=300, n_adapters=128, popularity="zipf",
            zipf_alpha=1.0, arrival="poisson", arrival_rate=90.0,
            prompt_len_mean=256, prompt_len_std=32, new_tokens=10, seed=0),
        churn_rate=rate, lifetime=1.5, request_rate=6.0, update_prob=0.25,
        seed=1)
    reqs, events = p.lifecycle.make_churn_workload(spec)
    rep = S.run_study(fl, reqs, lifecycle=lc, events=events, window=0.25)
    out = _report(rep)
    out["lc"] = lc.stats.to_dict()
    out["states"] = {a: (st.state, st.epoch, st.cluster)
                     for a, st in lc.adapters.items()}
    out["ttft"] = [r.ttft for r in reqs]
    return out


def migrate(p, how):
    """migration.py: 6 replicas, one retired at 40% of the stream, by
    draining or by live migration with the replacement attached."""
    S, N = p.simulator, 128
    base = p.workload.make_workload(p.workload.WorkloadSpec(
        n_requests=400, n_adapters=N, popularity="zipf", zipf_alpha=1.0,
        arrival="poisson", arrival_rate=520.0, prompt_len_mean=128,
        prompt_len_std=16, new_tokens=48, seed=0))
    retire_t = 0.4 * base[-1].arrival_time
    setting, cluster_of, budget = S.memory_matched_setup(cfg(p), N)
    fabric = p.resources.FabricConfig(bandwidth=50e9, chunk_bytes=1 << 20,
                                      compression=kvc(p, mode="int8"))
    fl = S.build_fleet(cfg(p), "jd", N, budget,
                       p.router.FleetConfig(n_replicas=6,
                                            policy="least_outstanding",
                                            migration_fabric=fabric),
                       hw(p), cluster_of, setting)
    mig = how == "migrate"
    policy = (p.migration.MigrationPolicy(p.migration.MigrationConfig(
        preempt_priority=False, defrag=False)) if mig else None)
    events = [S.StudyEvent(retire_t, lambda st: st.retire_decode(
        5, migrate=mig), label="retire")]
    if mig:
        events.append(S.StudyEvent(retire_t, lambda st: st.attach_engine(
            S.build_engine(cfg(p), "jd", N, budget, hw(p), cluster_of,
                           setting)), label="reinvest"))
    reqs = copies(base)
    out = _report(S.run_study(fl, reqs, events=events, migration=policy,
                              window=0.02))
    out["generated"] = [r.generated for r in reqs]
    out["finish"] = [r.finish_time for r in reqs]
    return out


def _hetero(p):
    rng = np.random.default_rng(0)
    rank_of = {a: int(rng.choice((4, 8, 16, 48, 64))) for a in range(256)}
    reqs = p.workload.make_workload(p.workload.WorkloadSpec(
        n_adapters=256, n_requests=900, popularity="zipf", zipf_alpha=1.0,
        arrival="gamma", burst_cv=4.0, arrival_rate=800.0,
        prompt_len_mean=64, prompt_len_std=16, new_tokens=24, seed=0))
    R = p.resources
    big = R.SliceType("big", cost_units=4, prefill_speed=3.0,
                      decode_speed=3.0, sgmv_tile_rank=32)
    small = R.SliceType("small", cost_units=1, hbm_bytes=38e9,
                        sgmv_tile_rank=8)
    return rank_of, reqs[:500], big, small


def hetero(p, cell):
    """hetero_placement.py: a rank-aware typed colocated fleet, or the
    jointly autoscaled typed pool of 12 cost units."""
    rank_of, reqs, big, small = _hetero(p)
    if cell == "typed":
        rep = p.simulator.run_elastic_study(
            cfg(p), "lora", 256, copies(reqs),
            p.router.FleetConfig(n_replicas=5, policy="adapter_affinity",
                                 rank_aware=True),
            hw=hw(p), pool_bytes="slice",
            decode_slice_types=[big] + [small] * 4, rank_of=rank_of,
            report=True)
    else:
        rep = p.simulator.run_elastic_study(
            cfg(p), "jd", 256, copies(reqs),
            p.router.FleetConfig(n_replicas=2, policy="cluster_affinity"),
            hw=hw(p), prefill_cfg=p.prefill.PrefillConfig(n_workers=2),
            slo=p.autoscaler.SLOConfig(ttft_p95=0.4),
            budget_cfg=p.resources.BudgetConfig(slice_types=(big, small),
                                                total_cost_units=12),
            joint_cfg=p.autoscaler.JointAutoscalerConfig(
                decision_interval=0.05, cooldown_intervals=0),
            decode_slice_types=[small, small], prefill_slice_type=small,
            rank_of=rank_of, report=True)
    return _report(rep)


def _adaptive_reqs(p):
    return p.workload.make_workload(p.workload.WorkloadSpec(
        n_requests=300, n_adapters=256, popularity="zipf", zipf_alpha=1.0,
        arrival="gamma", arrival_rate=150.0, burst_cv=4.0,
        prompt_len_mean=256, prompt_len_std=32, new_tokens=32, seed=0))


def adaptive(p, cell):
    """adaptive_compression.py over a 2 GB/s fabric: a static int4 wire,
    the adaptive ladder (3x3 split), and the joint autoscaler's
    compression axis."""
    reqs = _adaptive_reqs(p)
    R = p.resources
    if cell == "joint_axis":
        fab = R.FabricConfig(bandwidth=2e9, chunk_bytes=1 << 24,
                             adaptive=acc(p, initial_ceiling=0))
        rep = p.simulator.run_elastic_study(
            cfg(p), "jd", 256, copies(reqs),
            p.router.FleetConfig(n_replicas=2, policy="cluster_affinity"),
            hw=hw(p), prefill_cfg=p.prefill.PrefillConfig(n_workers=2,
                                                          fabric=fab),
            slo=p.autoscaler.SLOConfig(ttft_p95=0.4),
            budget_cfg=R.BudgetConfig(total_accelerators=6),
            joint_cfg=p.autoscaler.JointAutoscalerConfig(
                decision_interval=0.05, cooldown_intervals=0),
            report=True)
        return _report(rep)
    fab = R.FabricConfig(
        bandwidth=2e9, chunk_bytes=1 << 24,
        compression=kvc(p, mode="int4") if cell == "int4" else None,
        adaptive=acc(p) if cell == "adaptive" else None)
    rep = p.simulator.run_elastic_study(
        cfg(p), "jd", 256, copies(reqs),
        p.router.FleetConfig(n_replicas=3, policy="cluster_affinity"),
        hw=hw(p), prefill_cfg=p.prefill.PrefillConfig(n_workers=3,
                                                      fabric=fab),
        report=True)
    return _report(rep)


SCENARIOS = {
    "serving_n8": lambda p: throughput(p, 8),
    "serving_n128": lambda p: throughput(p, 128),
    "serving_n1024": lambda p: throughput(p, 1024),
    "fleet_zipf_cluster_affinity_jd": lambda p: fleet(
        p, "zipf", "cluster_affinity", "jd"),
    "fleet_uniform_round_robin_lora": lambda p: fleet(
        p, "uniform", "round_robin", "lora"),
    "fleet_zipf_adapter_affinity_lora": lambda p: fleet(
        p, "zipf", "adapter_affinity", "lora"),
    "disagg_p2d4": lambda p: disagg(p, auto=False),
    "disagg_auto_slo350ms": lambda p: disagg(p, auto=True),
    "joint_static3x3": lambda p: joint(p, auto=False),
    "joint_auto_b6": lambda p: joint(p, auto=True),
    "joint_auto_b6_fab2g": lambda p: joint(
        p, auto=True, fabric=lambda q: q.resources.FabricConfig(
            bandwidth=2e9, chunk_bytes=1 << 20)),
    "churn_r1": lambda p: churn(p, 1.0),
    "churn_r0": lambda p: churn(p, 0.0),
    "migrate_drain": lambda p: migrate(p, "drain"),
    "migrate_live": lambda p: migrate(p, "migrate"),
    "hetero_typed": lambda p: hetero(p, "typed"),
    "hetero_joint_typed_b12": lambda p: hetero(p, "joint"),
    "adaptive_int4": lambda p: adaptive(p, "int4"),
    "adaptive_ladder": lambda p: adaptive(p, "adaptive"),
    "adaptive_joint_axis": lambda p: adaptive(p, "joint_axis"),
}


def assert_same(got, want, path="$"):
    """Equal, recursively; floats bit for bit (a NaN equals a NaN)."""
    if isinstance(want, float) and isinstance(got, float):
        assert got == want or (math.isnan(got) and math.isnan(want)), (
            path, got, want)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (
            path, sorted(got), sorted(want))
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_jax(name):
    want = SCENARIOS[name](JAX)
    got = SCENARIOS[name](PORT)
    assert_same(got, want)


def test_scenarios_reach_their_control_planes():
    """The cases above drive what they name: rollouts land in the churn
    cell, live migrations happen, the autoscalers act, the adaptive ladder
    switches modes."""
    ch = churn(PORT, 1.0)
    assert ch["lc"]["n_registered"] > 0 and ch["lc"]["n_refreshes"] > 0
    mig = migrate(PORT, "migrate")
    assert mig["migration"]["n_retire_migrations"] > 0
    assert all(f is not None for f in mig["finish"])
    assert disagg(PORT, auto=True)["scale_events"] > 0
    assert joint(PORT, auto=True)["decisions"]
    ad = adaptive(PORT, "adaptive")["stats"]
    assert ad.get("kv_mode_switches", 0) > 0


def test_port_defaults_are_the_h100s():
    """The port prices one H100 SXM: the (de)quantization rate of the
    adaptive ladder and the wire compression is the card's HBM rate, and
    no measured fit of the JAX executor (``real_calibrated``) came
    across."""
    hw_ = t_engine.ServingHardware()
    assert t_resources.AdaptiveCompressionConfig().mem_bw == 3.35e12
    assert t_resources.KVCompressionConfig().mem_bw == hw_.hbm_bw == 3.35e12
    assert (t_resources.AdaptiveCompressionConfig().kernel_overhead
            == t_resources.KVCompressionConfig().kernel_overhead)
    assert not hasattr(t_engine.ServingHardware, "real_calibrated")
    assert not hasattr(t_engine, "REAL_DECODE_PER_SLOT_S")
    # figures that describe no chip are the JAX package's
    assert (t_resources.FabricConfig().bandwidth
            == j_resources.FabricConfig().bandwidth == 50e9)
    assert t_resources.SliceType("x") == _as(t_resources.SliceType,
                                             j_resources.SliceType("x"))


def test_every_resources_class_is_ported():
    import inspect
    want = {n for n, v in vars(j_resources).items()
            if inspect.isclass(v) and v.__module__ == j_resources.__name__}
    got = {n for n, v in vars(t_resources).items()
           if inspect.isclass(v) and v.__module__ == t_resources.__name__}
    assert want <= got, sorted(want - got)


@pytest.mark.parametrize("tile", [1, 8, 16, 32, 128])
def test_rank_efficiency_mirrors_the_kernel_cost_model(tile):
    for rank in range(1, 130):
        want = t_sgmv.sgmv_rank_efficiency(rank, tile)
        assert t_router.rank_efficiency(rank, tile) == want
        assert j_router.rank_efficiency(rank, tile) == want


def test_study_launcher_prints_one_row_per_n(monkeypatch, capsys):
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "mistral-7b", "--study", "1,128,1024",
        "--requests", "300"])
    serve.main()
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["n_adapters"] for r in rows] == [1, 128, 1024]
    for r in rows:
        assert r["jd_frac_of_single"] > 0
        assert r["throughput_ratio_jd_vs_lora"] > 0
    # at the port's defaults, the same rows as the study itself gives
    want = t_simulator.run_throughput_study(
        t_configs.get_config("mistral-7b"), [128],
        t_workload.WorkloadSpec(n_requests=300))
    assert_same(rows[1], json.loads(json.dumps(want[0], default=str)))
