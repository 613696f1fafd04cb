"""Online adapter registration grounded on the card: the churn cell of
``benchmarks/adapter_churn.py`` with the lifecycle's hooks doing the real
work on a compressed bank at mistral-7b's q-projection width.

  # 4096 -> 4096, LoRA rank 16, 128 adapters in 7 clusters, on the card
  PYTHONPATH=src python -m repro_torch.launch.grounded_churn

  # reduced widths on the CPU
  PYTHONPATH=src python -m repro_torch.launch.grounded_churn --device cpu \\
      --width 64 --adapters 40 --rank 4 --jd-rank 4 --clusters 3

The fleet (3 decode replicas, ``cluster_affinity``, priced by the port's
H100 cost model) serves a Zipf(1.0) base load at 90 requests/s with a
Poisson stream of hot-registered, updated and retired adapters on top, and
runs the control plane of ``serving/lifecycle.py`` on the host.  Its two
hooks work on the tensors' device:

- ``assign_fn`` draws the adapter's weights (the first one off every
  family, the rest family members of the bank), places it on the serving
  bases with ``core.cluster.assign_adapter`` and appends it with
  ``add_adapter``; its cluster is held to the argmax of
  ``_assignment_scores`` over the whole grown bank and its error to
  ``clustered_reconstruction_errors`` of the grown collection.  Every raw
  adapter's tokens then go through ``ops.lora_apply``'s grouped path (the
  shrink and expand kernels) against the plain chain: an adapter serves,
  uncompressed, before its registration returns (invariant L1 of
  ``docs/lifecycle.md``).
- ``gate_fn`` solves one candidate per rollout: ``cluster_jd`` (through
  ``compress_bank``) over the members, less the drained retirements
  (dropped with ``drop_adapter``: the lazy shrink), plus the adapters the
  rollout absorbs, started from the serving bases.  Each replica's gate is
  ``refresh_gate`` plus the candidate's exported bundle through
  ``ops.jd_apply``'s grouped path (``jd_shrink_scale``, ``sigma_bmm`` with a
  full Sigma, ``sgmv_expand``) against its plain chain.

``ops.lora_apply`` and ``ops.jd_apply`` run that grouped path for a CUDA
tensor.  On the CPU the grouped path runs each kernel's plain version, with
the kernels' casts, which is what the plain chains of ``kernels/checks.py``
hold; the per-token ``ref`` functions ``ops`` takes there round otherwise.  The first rollout's candidate
  is planted bad (random orthonormal bases, zero Sigma): its gate must
  refuse it and the rollout must roll back (invariant L3).

A newly absorbed adapter may fit no worse than the worst adapter the fleet
already serves compressed (``max_new_rel_err``, and the lifecycle's
``gate_max_rel_err``); the members may regress by 5% (``max_regression``).
Nothing is caught: a hook that fails ends the run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, List, Optional

import torch

from ..configs import get_config
from ..core import cluster as cl
from ..core.collection import (CompressedModule, CompressionConfig, LoRABank,
                               compress_bank, export_for_serving)
from ..device import resolve_device, synchronize
from ..kernels import checks, ops
from ..serving import lifecycle as lcm
from ..serving.engine import ServingHardware
from ..serving.router import FleetConfig
from ..serving.simulator import (build_fleet, compression_setting,
                                 memory_matched_setup, run_study,
                                 serving_footprint)
from ..serving.workload import WorkloadSpec
from .compress_apply import make_bank

N_BASE = 128                 # the churn cell's offline-compressed collection
N_REQUESTS = 300             # the churn cell at --quick
CHURN_RATE = 1.0             # the quick grid's "churn" cell: registrations/s
REFRESH_INTERVAL = 2.0       # and its basis-refresh cadence, s
TOKENS = 16                  # tokens per adapter in each agreement batch
GATE_MEMBERS = 8             # members served beside the absorbed in a gate
TILE = 128
POOL = 32                    # family members drawn for hot registrations
MAX_REGRESSION, ABS_SLACK = 0.05, 1e-3
SEED = 0


def _timed_ms(fn, dev):
    """(fn(), ms): CUDA events on the card, the host clock on the CPU."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, 1e3 * (time.perf_counter() - t0)


def _drop_rows(c: cl.ClusteredJD, order: List[int], drop) -> tuple:
    """``c`` without the rows of the adapters in ``drop``, one
    ``drop_adapter`` each; returns (collection, remaining order)."""
    order = list(order)
    for i in reversed(range(len(order))):
        if order[i] in drop:
            c = cl.drop_adapter(c, i)
            del order[i]
    return c, order


@dataclasses.dataclass
class _Pending:
    """The candidate of the rollout in flight, solved at its first gate."""
    rollout: object
    candidate: cl.ClusteredJD
    order: List[int]             # candidate rows: members, then absorbed
    n_members: int
    planted: bool
    solve_s: Optional[float] = None


class GroundedChurn:
    """The lifecycle's ``assign_fn`` and ``gate_fn`` over a real bank."""

    def __init__(self, width: int, rank: int, jd_rank: int, clusters: int,
                 n_base: int, device):
        self.dev = device
        self.ccfg = CompressionConfig(method="jd_full_eig", rank=jd_rank,
                                      n_clusters=clusters, seed=SEED)
        pool = make_bank(n_base + POOL, rank, width, width, SEED, device,
                         families=clusters)
        off = make_bank(POOL, rank, width, width, SEED + 1, device,
                        families=POOL)
        self.weights: Dict[int, tuple] = {
            a: (pool.A[a], pool.B[a]) for a in range(n_base)}
        self.family_pool = [(pool.A[i], pool.B[i])
                            for i in range(n_base, n_base + POOL)]
        self.off_pool = [(off.A[i], off.B[i]) for i in range(POOL)]
        self.n_draws = 0
        self.gen = torch.Generator(device=device).manual_seed(SEED + 2)
        self.lc: Optional[lcm.AdapterLifecycle] = None

        base = LoRABank(A=pool.A[:n_base], B=pool.B[:n_base],
                        ranks=pool.ranks[:n_base])
        synchronize(device)
        t0 = time.perf_counter()
        cm = compress_bank(base, self.ccfg)
        synchronize(device)
        self.base_solve_s = time.perf_counter() - t0
        self.serving: cl.ClusteredJD = cm.result
        self.members: List[int] = list(range(n_base))
        errs = cl.clustered_reconstruction_errors(
            base.A.float(), base.B.float(), self.serving)
        self.base_mean_rel_err = float(errs["mean_rel_err"])
        # a newly absorbed adapter may fit no worse than the worst member
        self.max_new_rel_err = float(errs["rel_err"].max())
        self.pending: Optional[_Pending] = None
        self.registrations: List[Dict] = []
        self.gates: List[Dict] = []
        self.rollouts: List[Dict] = []

    # -- helpers --------------------------------------------------------------
    def _bank(self, order: List[int]) -> LoRABank:
        A = torch.stack([self.weights[a][0] for a in order])
        B = torch.stack([self.weights[a][1] for a in order])
        return LoRABank(A=A, B=B, ranks=torch.full(
            (len(order),), A.shape[1], dtype=torch.int32, device=self.dev))

    def _raw(self) -> List[int]:
        """Live adapters the fleet serves uncompressed, registration order."""
        return [a for a, st in self.lc.adapters.items()
                if st.state in (lcm.RAW_SERVING, lcm.REFRESHING)]

    def _tokens(self, n_adapters: int):
        ids = torch.arange(n_adapters, device=self.dev).repeat_interleave(
            TOKENS).to(torch.int32)
        x = torch.randn((ids.numel(), self.weights[0][0].shape[-1]),
                        generator=self.gen, device=self.dev)
        return x.to(torch.bfloat16), ids

    def _draw(self) -> tuple:
        """The next hot adapter's weights: the first off every family."""
        pool = self.off_pool if self.n_draws == 0 else self.family_pool
        k = 0 if self.n_draws == 0 else self.n_draws - 1
        self.n_draws += 1
        if k >= len(pool):
            raise RuntimeError(f"more than {POOL} hot registrations")
        return pool[k], self.n_draws == 1

    def settle(self) -> None:
        """Take in what the control plane did since the last hook: a
        rollout that left the fleet either landed (the basis version
        moved to its own: its candidate serves) or rolled back (its
        adapters serve raw again, never cluster-assigned)."""
        p = self.pending
        if p is None or self.lc.rollout is p.rollout:
            return
        ro = p.rollout
        landed = self.lc.basis_version == ro.version
        if landed:
            # adapters updated or retired mid-rollout left it: their rows go
            kept = {a for a, _ in ro.adapters}
            drop = set(p.order[p.n_members:]) - kept
            self.serving, self.members = _drop_rows(p.candidate, p.order,
                                                    drop)
        else:
            for aid, epoch in ro.adapters:
                st = self.lc.adapters[aid]
                assert st.state != lcm.CLUSTER_ASSIGNED, (aid, st.state)
        self.rollouts.append({"version": ro.version, "planted": p.planted,
                              "landed": landed,
                              "absorbed": [a for a, _ in ro.adapters],
                              "shrinks": list(ro.shrinks)})
        self.pending = None

    # -- the lifecycle's hooks ------------------------------------------------
    def assign(self, aid: int) -> int:
        """``assign_fn``: place a registered (or updated) adapter."""
        self.settle()
        (A_i, B_i), off_family = self._draw()
        self.weights[aid] = (A_i, B_i)
        raw = [a for a in self._raw() if a != aid]
        grown, order = self.serving, list(self.members)
        for a in raw:                     # the raw overlay, as registered
            grown = cl.add_adapter(grown, self.weights[a][0].float(),
                                   self.weights[a][1].float())[0]
            order.append(a)
        A32, B32 = A_i.float(), B_i.float()
        (j, _, rel), ms = _timed_ms(
            lambda: cl.assign_adapter(A32, B32, grown), self.dev)
        grown = cl.add_adapter(grown, A32, B32)[0]
        order.append(aid)
        bank = self._bank(order)
        A_all, B_all = bank.A.float(), bank.B.float()
        scores = cl._assignment_scores(A_all, B_all, grown.U, grown.V)
        errs = cl.clustered_reconstruction_errors(A_all, B_all, grown)
        assert int(grown.assign[-1]) == j == int(scores[-1].argmax()), aid
        rel_grown = float(errs["rel_err"][-1])
        assert abs(rel - rel_grown) <= 1e-4, (aid, rel, rel_grown)

        # L1: every raw adapter serves, uncompressed, through the kernels
        served = raw + [aid]
        raw_bank = self._bank(served)
        x, ids = self._tokens(len(served))
        y = ops.lora_apply_grouped(x, raw_bank.A, raw_bank.B, ids,
                                   tile=TILE)
        err = checks.check_chain(f"raw overlay of adapter {aid}", y,
                                 checks.lora_chain_plain(x, raw_bank.A,
                                                         raw_bank.B, ids))
        self.registrations.append({
            "aid": aid, "off_family": off_family, "cluster": j,
            "rel_err": rel, "rel_err_grown": rel_grown, "assign_ms": ms,
            "raw_served": len(served), "raw_max_abs_err": err})
        return j

    def _solve(self, ro) -> _Pending:
        absorbed = [a for a, _ in ro.adapters]
        drop = set(ro.shrinks) | set(absorbed)
        members = [a for a in self.members if a not in drop]
        order = members + absorbed
        if not self.rollouts:
            # random orthonormal bases and zero Sigma: a candidate that
            # must not ship (tests/test_lifecycle.py's garbage candidate)
            k, r = self.serving.U.shape[0], self.serving.U.shape[-1]
            U = torch.linalg.qr(torch.randn(
                (k, self.serving.U.shape[1], r), generator=self.gen,
                device=self.dev))[0]
            V = torch.linalg.qr(torch.randn(
                (k, self.serving.V.shape[1], r), generator=self.gen,
                device=self.dev))[0]
            assign = torch.zeros(len(order), dtype=torch.int32,
                                 device=self.dev)
            cand = cl.ClusteredJD(U=U, V=V, sigma=torch.zeros(
                (len(order), r, r), device=self.dev), assign=assign)
            return _Pending(ro, cand, order, len(members), True)
        # warm start: one member of each serving cluster as its k-means
        # centre (any other row where a cluster kept no member), and the
        # serving bases as each cluster's start
        cluster = dict(zip(self.members, self.serving.assign.tolist()))
        k = self.serving.U.shape[0]
        centres = [next((i for i, a in enumerate(members)
                         if cluster[a] == c), None) for c in range(k)]
        free = (i for i in range(len(order)) if i not in centres)
        centres = [i if i is not None else next(free) for i in centres]
        starts = {"centroids": torch.tensor(centres, device=self.dev),
                  "clusters": [{"U0": self.serving.U[c],
                                "V0": self.serving.V[c]}
                               for c in range(len(centres))]}
        synchronize(self.dev)
        t0 = time.perf_counter()
        cm = compress_bank(self._bank(order), self.ccfg, starts=starts)
        synchronize(self.dev)
        return _Pending(ro, cm.result, order, len(members), False,
                        time.perf_counter() - t0)

    def gate(self, ro, target) -> lcm.GateResult:
        """``gate_fn``: one replica's check of the rollout's candidate."""
        self.settle()
        if self.pending is None or self.pending.rollout is not ro:
            self.pending = self._solve(ro)
        p = self.pending
        t0 = time.perf_counter()
        serving, _ = _drop_rows(self.serving, self.members,
                                set(ro.shrinks) | {a for a, _ in
                                                   ro.adapters})
        bank = self._bank(p.order)
        A_all, B_all = bank.A.float(), bank.B.float()
        g = cl.refresh_gate(A_all, B_all, serving, p.candidate,
                            max_regression=MAX_REGRESSION,
                            abs_slack=ABS_SLACK,
                            max_new_rel_err=self.max_new_rel_err)
        # the candidate's bundle through the kernels: the absorbed
        # adapters and a few members, against the plain chain
        a = export_for_serving(CompressedModule(
            result=p.candidate, norms=None, metrics={},
            method=self.ccfg.method)).arrays
        step = max(1, p.n_members // GATE_MEMBERS)
        rows = list(range(0, p.n_members, step))[:GATE_MEMBERS] + list(
            range(p.n_members, len(p.order)))
        x, local = self._tokens(len(rows))
        ids = torch.tensor(rows, dtype=torch.int32,
                           device=self.dev)[local.long()]
        y = ops.jd_apply_grouped(x, a["U"], a["V"], a["sigma"],
                                 a["cluster_of"], ids, tile=TILE)
        agree = checks.chain_agreement(y, checks.jd_chain_plain(
            x, a["U"], a["V"], a["sigma"], a["cluster_of"], ids))
        synchronize(self.dev)
        res = lcm.GateResult(ok=g["ok"], rel_err=g["new_worst_rel_err"],
                             agreement=agree["agreement"],
                             reason="planted" if p.planted else "")
        self.gates.append({
            "version": ro.version, "target": list(target),
            "planted": p.planted, "absorbed": len(p.order) - p.n_members,
            "shrinks": len(ro.shrinks),
            "solve_s": p.solve_s, **g, **agree,
            "gate_s": time.perf_counter() - t0})
        return res


def churn_fleet(n_base: int, cluster_of: Dict[int, int]):
    """The churn cell's fleet (``benchmarks/adapter_churn.py::churn_cell``)
    with the bank's own cluster assignment: 3 replicas, cluster affinity,
    the Appendix-F adapter budget plus six raw LoRAs of headroom."""
    cfg = get_config("mistral-7b")
    setting, _, budget = memory_matched_setup(cfg, n_base)
    fp_lora = serving_footprint(cfg, "lora", n_base, setting)
    budget += 6 * fp_lora.lora_bytes_per_adapter
    return build_fleet(cfg, "jd", n_base, budget,
                       FleetConfig(n_replicas=3, policy="cluster_affinity",
                                   spill_requests=1e9),
                       ServingHardware(), cluster_of, setting)


def churn_spec(n_base: int) -> lcm.ChurnSpec:
    """The churn cell's traffic over ``n_base`` offline adapters."""
    return lcm.ChurnSpec(
        base=WorkloadSpec(n_requests=N_REQUESTS, n_adapters=n_base,
                          popularity="zipf", zipf_alpha=1.0,
                          arrival="poisson", arrival_rate=90.0,
                          prompt_len_mean=256, prompt_len_std=32,
                          new_tokens=10, seed=SEED),
        churn_rate=CHURN_RATE, lifetime=1.5, request_rate=6.0,
        update_prob=0.25, seed=SEED + 1)


def run(width: int = 4096, rank: int = 16, jd_rank: Optional[int] = None,
        clusters: Optional[int] = None, n_base: int = N_BASE,
        device=None) -> Dict:
    """The grounded churn cell (see the module docstring); returns a
    JSON-able report.  ``jd_rank`` and ``clusters`` default to the paper's
    setting for ``n_base`` adapters (``simulator.compression_setting``)."""
    dev = resolve_device(device)
    setting = compression_setting(n_base)
    jd_rank = jd_rank or setting["rank"]
    clusters = clusters or setting["clusters"]
    t0 = time.perf_counter()
    g = GroundedChurn(width, rank, jd_rank, clusters, n_base, dev)
    fleet = churn_fleet(n_base, {a: int(c) for a, c in
                                 enumerate(g.serving.assign.tolist())})
    lc = lcm.AdapterLifecycle(
        fleet, lcm.LifecycleConfig(refresh_interval=REFRESH_INTERVAL,
                                   gate_max_rel_err=g.max_new_rel_err),
        assign_fn=g.assign, gate_fn=g.gate)
    g.lc = lc
    reqs, events = lcm.make_churn_workload(churn_spec(n_base))
    report = run_study(fleet, reqs, lifecycle=lc, events=events,
                       window=0.25)
    g.settle()
    synchronize(dev)
    stats = lc.stats.to_dict()
    cfg = lc.cfg
    failed = [x for x in g.gates
              if not (x["ok"] and x["agreement"] >= cfg.gate_min_agreement
                      and x["new_worst_rel_err"] <= cfg.gate_max_rel_err)]
    actions = [e.action for e in events]
    return {
        "device": str(dev), "width": width, "rank": rank,
        "jd_rank": jd_rank, "clusters": clusters, "n_base": n_base,
        "n_requests": len(reqs),
        "finished": sum(r.finish_time is not None for r in reqs),
        "events": {a: actions.count(a) for a in ("register", "update",
                                                 "retire")},
        "lifecycle": stats, "failed_gates": len(failed),
        "base_solve_s": g.base_solve_s,
        "base_mean_rel_err": g.base_mean_rel_err,
        "max_new_rel_err": g.max_new_rel_err,
        "registrations": g.registrations, "gates": g.gates,
        "rollouts": g.rollouts,
        "in_flight": (None if lc.rollout is None else
                      {"version": lc.rollout.version,
                       "next_idx": lc.rollout.next_idx}),
        "rps": report.rps, "wall_s": time.perf_counter() - t0}


def check(rep: Dict) -> None:
    """What the grounded run must show: every request finished; the
    lifecycle's counters are the event stream's and the gates'; the
    planted candidate was refused and rolled back while a real one
    landed; every gate's kernel check agreed in full."""
    st, ev = rep["lifecycle"], rep["events"]
    assert rep["finished"] == rep["n_requests"], rep["finished"]
    assert (st["n_registered"], st["n_updated"], st["n_retired"]) == (
        ev["register"], ev["update"], ev["retire"]), (st, ev)
    assert st["n_gate_checks"] == len(rep["gates"]), st
    assert st["n_gate_failures"] == rep["failed_gates"] == st[
        "n_rollbacks"], st
    ro = rep["rollouts"]
    assert st["n_refreshes"] == sum(r["landed"] for r in ro), (st, ro)
    assert st["n_rollbacks"] == sum(not r["landed"] for r in ro), (st, ro)
    planted = [r for r in ro if r["planted"]]
    assert len(planted) == 1 and not planted[0]["landed"], ro
    assert any(r["landed"] and r["absorbed"] for r in ro), ro
    assert all(x["agreement"] == 1.0 for x in rep["gates"]), rep["gates"]
    assert any(r["off_family"] for r in rep["registrations"])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=4096)
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--jd-rank", type=int, default=None)
    ap.add_argument("--clusters", type=int, default=None)
    ap.add_argument("--adapters", type=int, default=N_BASE)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    rep = run(args.width, args.rank, args.jd_rank, args.clusters,
              args.adapters, device=args.device)
    check(rep)
    print(json.dumps(rep, indent=2))


if __name__ == "__main__":
    main()
