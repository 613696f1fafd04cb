"""Synthetic natural-instruction-style task generator.

Stands in for the paper's 1000 natural-instruction tasks (no corpora
offline).  Each task is a deterministic seeded transformation family over a
small byte-level vocabulary — structurally like classification / extraction
/ transduction instruction tasks: the model sees  [instr tokens] [input]
[SEP] and must produce [output].  Tasks differ enough that per-task LoRAs
learn genuinely different adapters (verified by cross-task eval in tests).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

PAD, BOS, SEP, EOS = 0, 1, 2, 3
RESERVED = 4


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    task_id: int
    kind: str          # copy | reverse | map | sort | filter | rotate | pair
    seed: int
    vocab: int         # usable vocab (offset by RESERVED)
    in_len: int = 12
    instr_len: int = 4


KINDS = ("copy", "reverse", "map", "sort", "filter", "rotate", "pair")


def make_task(task_id: int, vocab: int = 256, seed: int = 1234) -> TaskSpec:
    kind = KINDS[task_id % len(KINDS)]
    return TaskSpec(task_id=task_id, kind=kind, seed=seed * 7919 + task_id,
                    vocab=vocab)


def _apply(spec: TaskSpec, rng: np.random.Generator,
           x: np.ndarray) -> np.ndarray:
    v = spec.vocab
    task_rng = np.random.default_rng(spec.seed)
    if spec.kind == "copy":
        return x
    if spec.kind == "reverse":
        return x[::-1]
    if spec.kind == "map":
        perm = task_rng.permutation(v)
        return perm[x]
    if spec.kind == "sort":
        return np.sort(x)
    if spec.kind == "filter":
        thr = int(task_rng.integers(v // 4, 3 * v // 4))
        kept = x[x < thr]
        out = np.full_like(x, 0)
        out[:kept.size] = kept
        return out
    if spec.kind == "rotate":
        k = int(task_rng.integers(1, spec.in_len - 1))
        return np.roll(x, k)
    if spec.kind == "pair":
        off = int(task_rng.integers(1, v - 1))
        return (x + off) % v
    raise ValueError(spec.kind)


def sample_example(spec: TaskSpec, rng: np.random.Generator
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (tokens, targets) of equal length; targets = -1 on non-output
    positions (loss-masked)."""
    task_rng = np.random.default_rng(spec.seed)
    instr = task_rng.integers(0, spec.vocab, size=spec.instr_len)
    x = rng.integers(0, spec.vocab, size=spec.in_len)
    y = _apply(spec, rng, x)
    seq = np.concatenate([[BOS], instr + RESERVED, x + RESERVED, [SEP],
                          y + RESERVED, [EOS]])
    tokens = seq[:-1]
    targets = seq[1:].copy()
    out_start = 1 + spec.instr_len + spec.in_len  # index of SEP in tokens
    targets[:out_start] = -1                       # only predict the output
    return tokens.astype(np.int32), targets.astype(np.int32)


def batch_of(spec: TaskSpec, batch: int, seq_len: int, seed: int
             ) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    toks = np.zeros((batch, seq_len), np.int32)
    tgts = np.full((batch, seq_len), -1, np.int32)
    for i in range(batch):
        t, g = sample_example(spec, rng)
        n = min(len(t), seq_len)
        toks[i, :n] = t[:n]
        tgts[i, :n] = g[:n]
    return {"tokens": toks, "targets": tgts}


def eval_exact_match(spec: TaskSpec, predict_fn, n: int = 32,
                     seq_len: int = 64, seed: int = 999) -> float:
    """predict_fn(tokens (B,S)) -> predicted next-token ids (B,S).
    Exact-match on the output segment (the paper's EM metric analogue)."""
    b = batch_of(spec, n, seq_len, seed)
    pred = np.asarray(predict_fn(b["tokens"]))
    mask = b["targets"] >= 0
    correct = ((pred == b["targets"]) | ~mask).all(axis=1)
    return float(correct.mean())


def eval_token_accuracy(spec: TaskSpec, predict_fn, n: int = 32,
                        seq_len: int = 64, seed: int = 999) -> float:
    b = batch_of(spec, n, seq_len, seed)
    pred = np.asarray(predict_fn(b["tokens"]))
    mask = b["targets"] >= 0
    return float((pred == b["targets"])[mask].mean())
