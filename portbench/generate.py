"""The one traffic generator: every mix is a file under ``traffic/`` that
this module reads.

A mix fixes its prompt lengths and arrival times once, from its own
``schedule_seed``, so that every run of a cell serves the same work in the
same order.  The run's ``--seed`` draws everything else: the prompt tokens,
the adapter of each request (Zipf popularity over shuffled ranks) and the
weights.  Runs with other seeds then differ only in what the numbers are,
not in how much work there is, and a tail over a few hundred requests
repeats from run to run (a fresh Poisson draw per seed moves the p95 of a
queue at 0.8 load by tens of percent).

The Zipf and arrival arithmetic is a frozen copy of the port's
``serving/workload.py`` (``zipf_pmf``, exponential gaps at ``1/rate``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

ARRIVALS = ("backlog", "poisson")


def zipf_pmf(n: int, alpha: float) -> np.ndarray:
    """P(rank k) proportional to 1/k**alpha over n ranks."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-alpha)
    return w / w.sum()


@dataclasses.dataclass
class Schedule:
    """The fixed part of a mix: request ``i`` is due ``due_s[i]`` seconds
    after the window opens (0 for a backlog) and has ``lengths[i]`` prompt
    tokens."""
    due_s: np.ndarray
    lengths: np.ndarray


def schedule(traffic: dict) -> Schedule:
    """Lengths and due times of ``traffic``'s requests, drawn from its
    ``schedule_seed`` alone."""
    arrival = traffic["arrival"]
    if arrival not in ARRIVALS:
        raise ValueError(f"unknown arrival process {arrival!r}")
    pl = traffic["prompt_len"]
    if pl["dist"] != "lognormal":
        raise ValueError(f"unknown prompt length distribution {pl['dist']!r}")
    n = int(traffic["schedule_len"])
    rng = np.random.default_rng(int(traffic["schedule_seed"]))
    z = rng.standard_normal(n)
    lengths = np.clip(np.rint(pl["median"] * np.exp(pl["sigma"] * z)),
                      pl["min"], pl["max"]).astype(np.int64)
    if arrival == "poisson":
        rate = float(traffic["rate_per_s"])
        if not rate > 0:
            raise ValueError("a poisson mix needs rate_per_s > 0")
        due = np.cumsum(rng.exponential(1.0 / rate, n))
    else:
        due = np.zeros(n)
    return Schedule(due_s=due, lengths=lengths)


class Inputs:
    """The seeded part of a mix: request ``i``'s prompt tokens and adapter.

    Each request draws from its own generator, keyed by (seed, i), so any
    request can be made again (the reference does) without the others."""

    def __init__(self, traffic: dict, seed: int, n_adapters: int,
                 vocab_size: int):
        pop = traffic["popularity"]
        if pop["dist"] != "zipf":
            raise ValueError(f"unknown popularity {pop['dist']!r}")
        self.seed, self.vocab = int(seed), int(vocab_size)
        self.n_adapters = int(n_adapters)
        self.pmf = zipf_pmf(self.n_adapters, float(pop["alpha"]))
        self.rank_of = np.arange(self.n_adapters)
        if pop.get("shuffle_ranks", True):
            self.rank_of = np.random.default_rng(
                [self.seed, 0x5EED]).permutation(self.n_adapters)

    def request(self, i: int, length: int):
        """(prompt tokens (length,) int64, adapter id) of request ``i``."""
        rng = np.random.default_rng([self.seed, int(i)])
        aid = int(self.rank_of[rng.choice(self.n_adapters, p=self.pmf)])
        tokens = rng.integers(0, self.vocab, int(length), dtype=np.int64)
        return tokens, aid
