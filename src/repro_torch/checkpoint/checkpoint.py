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

Sharded (the port of the JAX module's elastic restore): a tree of
DTensors is saved as its assembled values, leaf by leaf (each gathered,
copied to the host by rank 0, and freed), in the same layout; rank 0
writes and, in a blocking save, the other ranks wait at a barrier until
the step is on disk.  ``restore_checkpoint(..., shardings=)`` places each
leaf under a tree of ``NamedSharding`` on the caller's mesh, which may
differ from the save-time mesh: each rank reads only its own block of
each file (memory-mapped) into a DTensor.
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
import torch.distributed as dist

from ..distributed.sharding import is_dtensor, island_out, local_block

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
    files are written by a thread (:func:`wait_for_async_saves` joins it).
    A tree of DTensors is called on every rank of its mesh: rank 0 writes
    the assembled values (the others wait, in a blocking save)."""
    # join any in-flight async save before touching tmp dirs: a previous
    # save of the same step (re-reached after a restart) may still be
    # writing into .tmp_step_N
    prev: Optional[threading.Thread] = _async_state.get("thread")
    if prev is not None and prev.is_alive():
        prev.join()
    base = Path(ckpt_dir)
    tmp = base / f".tmp_step_{step}"
    final = base / f"step_{step}"
    flat = _flatten(tree)
    sharded = any(is_dtensor(v) for v in flat.values())
    writer = not sharded or dist.get_rank() == 0
    host = {}
    for k, v in flat.items():
        if is_dtensor(v):
            v = v.full_tensor()         # every rank takes part; one leaf
        if writer:
            host[k] = _to_host(v)
    if not writer:
        if blocking:
            dist.barrier()
        return str(final)
    base.mkdir(parents=True, exist_ok=True)
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

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
        if sharded:
            dist.barrier()
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


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    # np.array, not np.ascontiguousarray, which makes a 0-d array 1-d; a
    # copy, which also reads a memory-mapped block into memory
    arr = np.array(arr, order="C", copy=True)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _mesh_device(sharding):
    dm = sharding.mesh._dm()
    if dm.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(dm.device_type)


def restore_checkpoint(ckpt_dir: str, step: int, tree_like, *,
                       shardings=None):
    """Restore into the structure of `tree_like`, in the dtype the manifest
    records: each leaf on the device of the matching leaf there or, with
    ``shardings`` (a matching tree of ``NamedSharding`` on a mesh with a
    DeviceMesh, possibly another mesh than at save time: elastic
    restore), as a DTensor under it holding this rank's block alone."""
    base = Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((base / "manifest.json").read_text())["arrays"]
    flat_sh = _flatten(shardings) if shardings is not None else {}
    out = {}
    for k, like in _flatten(tree_like).items():
        meta = manifest[k]
        sh = flat_sh.get(k)
        if sh is None:
            out[k] = _from_host(np.load(base / meta["file"]),
                                meta["dtype"]).to(like.device)
            continue
        arr = np.load(base / meta["file"], mmap_mode="r")
        block = local_block(arr.shape, sh.spec, sh.mesh,
                            sh.mesh.coordinates())
        local = _from_host(arr[block], meta["dtype"]).to(_mesh_device(sh))
        out[k] = island_out(local, sh.mesh._dm(), sh.placements(),
                            tuple(arr.shape))
    return _unflatten(tree_like, out)
