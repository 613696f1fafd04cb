"""Checkpoints with async save and restore onto any device (the port of
``repro/checkpoint/checkpoint.py``), in the same on-disk layout.

Layout: one directory ``step_N`` per step holding one ``.npy`` file per
leaf and ``manifest.json``, which maps each leaf's key (its dict keys, in
sorted order, joined by ``::``; a list or tuple index is ``#i``) to its
file, shape and dtype.  A bf16 leaf is stored as its raw ``uint16`` bits
with ``"bfloat16"`` in the manifest, which is how the JAX package stores
it, so a checkpoint written by either package restores in the other.  The
bits cross through torch views (no ``ml_dtypes``).

A save is written into ``.tmp_step_N`` and renamed to ``step_N`` when
complete; only the newest ``keep`` steps are kept.  ``restore_checkpoint``
places each leaf on the device of the matching leaf of ``tree_like``, so a
checkpoint written on the card restores on the CPU and the other way.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

_SEP = "::"
_ASYNC_STATE: dict = {}


def _flatten(tree, prefix=()) -> Dict[str, torch.Tensor]:
    """Leaves keyed by path, in the order JAX flattens the same tree."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"#{i}", v) for i, v in enumerate(tree)]
    else:
        return {_SEP.join(prefix): tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, prefix + (k,)))
    return flat


def _unflatten(tree_like, flat, prefix=()):
    if isinstance(tree_like, dict):
        return {k: _unflatten(v, flat, prefix + (str(k),))
                for k, v in tree_like.items()}
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(_unflatten(v, flat, prefix + (f"#{i}",))
                               for i, v in enumerate(tree_like))
    return flat[_SEP.join(prefix)]


def _to_host(t: torch.Tensor):
    """(host array, manifest dtype): npy files cannot hold bf16, so a bf16
    tensor is stored as its raw bits and its true dtype recorded.  Always a
    copy, also of a CPU tensor: an async save's writer must not see the
    caller's later in-place updates."""
    t = t.detach().to("cpu", memory_format=torch.contiguous_format,
                      copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def save_checkpoint(ckpt_dir: str, step: int, tree, *,
                    keep: int = 3, blocking: bool = True,
                    _async_state: dict = _ASYNC_STATE) -> str:
    """Write `tree` under ckpt_dir/step_N (atomic rename).  The device-to-
    host copy happens before this returns; with ``blocking=False`` the
    files are written by a thread (:func:`wait_for_async_saves` joins it)."""
    # join any in-flight async save before touching tmp dirs: a previous
    # save of the same step (re-reached after a restart) may still be
    # writing into .tmp_step_N
    prev: Optional[threading.Thread] = _async_state.get("thread")
    if prev is not None and prev.is_alive():
        prev.join()
    base = Path(ckpt_dir)
    base.mkdir(parents=True, exist_ok=True)
    tmp = base / f".tmp_step_{step}"
    final = base / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    flat = _flatten(tree)
    host = {k: _to_host(v) for k, v in flat.items()}

    def write():
        manifest = {}
        for k, (v, dtype) in host.items():
            fn = f"{abs(hash(k)) % 10**12}.npy"
            np.save(tmp / fn, v)
            manifest[k] = {"file": fn, "shape": list(v.shape),
                           "dtype": dtype}
        (tmp / "manifest.json").write_text(json.dumps(
            {"step": step, "arrays": manifest, "time": time.time()}))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(base, keep)

    if blocking:
        write()
    else:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        _async_state["thread"] = t
    return str(final)


def wait_for_async_saves(_async_state: dict = _ASYNC_STATE):
    t = _async_state.get("thread")
    if t is not None:
        t.join()


def _gc(base: Path, keep: int):
    steps = sorted((int(p.name.split("_")[1]), p)
                   for p in base.glob("step_*"))
    for _, p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    base = Path(ckpt_dir)
    if not base.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in base.glob("step_*")
             if (p / "manifest.json").exists()]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, tree_like):
    """Restore into the structure of `tree_like`, each leaf on the device of
    the matching leaf there, in the dtype the manifest records."""
    base = Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((base / "manifest.json").read_text())["arrays"]
    out = {}
    for k, like in _flatten(tree_like).items():
        meta = manifest[k]
        arr = np.load(base / meta["file"])
        if meta["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        out[k] = t.to(like.device)
    return _unflatten(tree_like, out)
