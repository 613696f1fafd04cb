"""Workload generation for serving studies: adapter popularity models
(uniform / Zipf), arrival processes (batch / Poisson / bursty Gamma), and
CSV trace replay.

The paper's §6.4 setup (uniform popularity, asynchronous arrivals) is the
default — ``WorkloadSpec()`` with no overrides draws the *identical* request
stream the original single-replica study used, so seed numbers reproduce
bit-exactly.  Skewed popularity and bursty arrivals model what S-LoRA-style
production traces actually look like: a few hot adapters dominate and
traffic arrives in bursts, which is where fleet routing policy matters.
"""
from __future__ import annotations

import csv
import dataclasses
import warnings
from typing import List, Sequence

import numpy as np

from .request import Request


@dataclasses.dataclass
class WorkloadSpec:
    """Describes a synthetic request stream.

    popularity:
      "uniform" — every adapter equally likely (paper §6.4);
      "zipf"    — P(rank k) ∝ 1/k**zipf_alpha over the adapter set.
    arrival:
      "batch"   — everything at t=0 (arrival_rate ignored);
      "poisson" — exponential inter-arrivals at `arrival_rate` req/s;
      "gamma"   — Gamma inter-arrivals, same mean, `burst_cv` coefficient
                  of variation (>1 = bursty clumps, 1 = Poisson).
      With arrival_rate == 0 every process degenerates to "batch".
    """
    n_requests: int = 1000
    n_adapters: int = 64
    popularity: str = "uniform"      # uniform | zipf
    zipf_alpha: float = 1.0
    shuffle_ranks: bool = True       # decouple adapter id from popularity rank
    arrival: str = "poisson"         # batch | poisson | gamma
    arrival_rate: float = 0.0        # mean req/s; 0 = all at t=0
    burst_cv: float = 4.0            # gamma only
    prompt_len_mean: int = 128       # sonnet-ish prompts
    prompt_len_std: int = 32
    new_tokens: int = 10             # paper: ten tokens per request
    seed: int = 0


def zipf_pmf(n: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-alpha)
    return w / w.sum()


def make_workload(spec: WorkloadSpec) -> List[Request]:
    """Generate the request stream described by `spec`.

    RNG call order (inter-arrival, prompt length, adapter id — per request)
    matches the original uniform generator so default configs reproduce the
    seed study exactly.
    """
    rng = np.random.default_rng(spec.seed)
    pmf = None
    rank_of = None
    if spec.popularity == "zipf":
        pmf = zipf_pmf(spec.n_adapters, spec.zipf_alpha)
        rank_of = np.arange(spec.n_adapters)
        if spec.shuffle_ranks:
            # separate stream: must not perturb the per-request draws
            rank_of = np.random.default_rng(
                spec.seed + 0x5EED).permutation(spec.n_adapters)
    elif spec.popularity != "uniform":
        raise ValueError(f"unknown popularity model: {spec.popularity!r}")
    if spec.arrival not in ("batch", "poisson", "gamma"):
        raise ValueError(f"unknown arrival process: {spec.arrival!r}")

    mean_gap = 1.0 / spec.arrival_rate if spec.arrival_rate > 0 else 0.0
    if spec.arrival == "gamma":
        k = 1.0 / (spec.burst_cv ** 2)      # CV = 1/sqrt(k)
        theta = mean_gap / k if k else 0.0

    t = 0.0
    out: List[Request] = []
    for i in range(spec.n_requests):
        if mean_gap and spec.arrival == "poisson":
            t += rng.exponential(mean_gap)
        elif mean_gap and spec.arrival == "gamma":
            t += rng.gamma(k, theta)
        plen = int(np.clip(rng.normal(spec.prompt_len_mean,
                                      spec.prompt_len_std),
                           16, 4 * spec.prompt_len_mean))
        if pmf is None:
            aid = int(rng.integers(spec.n_adapters))
        else:
            aid = int(rank_of[rng.choice(spec.n_adapters, p=pmf)])
        out.append(Request(rid=i, adapter_id=aid, prompt_len=plen,
                           max_new_tokens=spec.new_tokens, arrival_time=t))
    return out


# ---------------------------------------------------------------------------
# trace replay
# ---------------------------------------------------------------------------

TRACE_COLUMNS = ("arrival_time", "adapter_id", "prompt_len", "max_new_tokens")


def load_trace(path: str) -> List[Request]:
    """Replay a CSV trace with columns arrival_time,adapter_id,prompt_len,
    max_new_tokens (header required; extra columns ignored).

    Real traces are frequently written by concurrent frontends and arrive
    with out-of-order timestamps; replaying them unsorted would produce
    negative inter-arrival gaps (and non-causal queue dynamics), so the
    loader sorts by arrival time — warning when it had to — and renumbers
    ``rid`` to the replay order."""
    out: List[Request] = []
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        missing = [c for c in TRACE_COLUMNS if c not in (reader.fieldnames or [])]
        if missing:
            raise ValueError(f"trace {path} missing columns: {missing}")
        for i, row in enumerate(reader):
            out.append(Request(
                rid=i, adapter_id=int(row["adapter_id"]),
                prompt_len=int(row["prompt_len"]),
                max_new_tokens=int(row["max_new_tokens"]),
                arrival_time=float(row["arrival_time"])))
    if any(a.arrival_time > b.arrival_time for a, b in zip(out, out[1:])):
        warnings.warn(f"trace {path} has out-of-order timestamps; "
                      "sorting by arrival_time for replay", stacklevel=2)
        out.sort(key=lambda r: r.arrival_time)
        for i, r in enumerate(out):
            r.rid = i
    return out


def save_trace(path: str, requests: Sequence[Request]) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(TRACE_COLUMNS)
        for r in requests:
            w.writerow([r.arrival_time, r.adapter_id, r.prompt_len,
                        r.max_new_tokens])
