"""What an eager step costs on the card, op by op (the port's counterpart
of ``launch/hlo_cost.py``).

The JAX package compiles a step and reads its cost from the HLO text.  The
port's steps run eagerly, one kernel an aten op, so the counterpart of a
compiled module's cost is the step itself: :func:`analyze_step` runs it
under a ``TorchDispatchMode`` that records, for each aten op it reaches,

- flops: ``torch.utils.flop_counter``'s formulas (mm, bmm, addmm,
  baddbmm, convolution, attention); other ops count none;
- bytes: each tensor input read once and each tensor output written once
  (a broadcast input's stride-0 dims counted once).  Views and metadata
  ops count 0.  This is the traffic of an eager step;
- launches: ops that compute (not a view, a bare allocation or a
  metadata query);
- collectives (the ``c10d`` ops): counts, and the bytes each device moves
  by the ring factors of ``launch/roofline.py``;
- live bytes on the step's device, by storage lifetime (a weakref
  finalizer on each untyped storage): ``peak_bytes``, and ``temp_bytes``
  = peak less the arguments.

On ``meta`` tensors the step does no work and needs no device: the record
is what the step would do on the card.  A port kernel (``kernels/``) is
one entry of the record, written by the wrapper through
:func:`port_kernel` on meta and on CUDA tensors alike, with the bytes and
operations of ``kernels/checks.py``'s bound (the ops a wrapper runs
around its launch, its outputs' allocation, are not recorded).

Loop awareness, as ``analyze_hlo`` multiplies a while body by its trip
count: a train step of ``n_micro`` microbatches is recorded at 2 and 3
microbatches and extrapolated linearly (``training/step.py``'s one-
microbatch step takes no accumulation, so 2 is the first point of the
line).
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from .roofline import HBM_BW, PEAK_FLOPS, _ring_factor

aten = torch.ops.aten

# ops that only allocate: no kernel, no traffic
_ALLOC = {aten.empty.memory_format, aten.empty_strided.default,
          aten.empty_like.default, aten.new_empty.default,
          aten.new_empty_strided.default}

# c10d op -> the collective it is (the ring factors' names)
_COLLECTIVES = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "broadcast_": "collective-permute", "send": "collective-permute",
    "recv_": "collective-permute",
}
_FIELDS = ("count", "flops", "bytes", "launches")


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes an op reads or writes of ``t``: its elements, a broadcast
    (stride-0) dim counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(x):
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _group_size(func, args, kwargs) -> int:
    """The size of a c10d op's group: a legacy op's ProcessGroup argument,
    a functional op's ``group_name``."""
    import torch.distributed as dist
    if func.namespace == "_c10d_functional":
        from torch.distributed.distributed_c10d import _resolve_process_group
        names = [a.name for a in func._schema.arguments]
        i = names.index("group_name")
        name = args[i] if i < len(args) else kwargs["group_name"]
        return _resolve_process_group(name).size()
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except RuntimeError:
                continue                   # a ReduceOp, not the group
    return 1


class _Recorder(TorchDispatchMode):
    """The dispatch mode of :func:`analyze_step` (one step, one device
    type for the live bytes)."""

    def __init__(self, device_type: str):
        super().__init__()
        self.device_type = device_type
        self.ops: Dict[str, Dict[str, float]] = {}
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.coll_counts: Dict[str, int] = {}
        self.coll_bytes = 0.0
        self.suppress = 0
        self.live = self.peak = 0
        self._storages: Dict[int, int] = {}
        self._open = True

    # -- live bytes ---------------------------------------------------------
    def track(self, t: torch.Tensor) -> None:
        if t.device.type != self.device_type:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        if self._open:
            self.live -= self._storages.pop(key, 0)

    def close(self) -> None:
        self._open = False

    # -- ops ----------------------------------------------------------------
    def _add(self, table, name, **vals) -> None:
        row = table.setdefault(name, dict.fromkeys(_FIELDS, 0))
        for k, v in vals.items():
            row[k] += v

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self.track(t)
        if self.suppress:
            return out
        name = str(func)
        coll = _COLLECTIVES.get(func._schema.name.split("::")[-1]) \
            if func.namespace in ("c10d", "_c10d_functional") else None
        if coll is not None:
            # the legacy ops write their result into their first argument
            result = _tensors(args[0]) if func.namespace == "c10d" else outs
            rb = sum(tensor_bytes(t) for t in result)
            self.coll_counts[coll] = self.coll_counts.get(coll, 0) + 1
            self.coll_bytes += rb * _ring_factor(
                coll, _group_size(func, args, kwargs))
            self._add(self.ops, name, count=1, launches=1)
            return out
        ins = _tensors((args, kwargs))
        mutates = any(a.alias_info is not None and a.alias_info.is_write
                      for a in func._schema.arguments)
        in_keys = {t.untyped_storage()._cdata for t in ins}
        if func in _ALLOC or not outs or (not mutates and all(
                t.untyped_storage()._cdata in in_keys for t in outs)):
            self._add(self.ops, name, count=1)       # alloc, metadata, view
            return out
        flops = 0
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        nbytes = sum(tensor_bytes(t) for t in ins) + \
            sum(tensor_bytes(t) for t in outs)
        self._add(self.ops, name, count=1, flops=flops, bytes=nbytes,
                  launches=1)
        return out

    def add_kernel(self, name: str, launches: int, nbytes: int,
                   flops: int) -> None:
        self._add(self.kernels, name, count=1, flops=flops, bytes=nbytes,
                  launches=launches)


class _Active(threading.local):
    def __init__(self):
        self.stack = []


_ACTIVE = _Active()


@contextlib.contextmanager
def port_kernel(name: str, launches: int,
                cost: Callable[[], tuple]):
    """Around one call of a port kernel's wrapper: while a step is being
    recorded, the ops inside are left out of the record and the call is
    one entry of ``name`` with ``launches`` launches and ``cost()`` ->
    (bytes, flops), evaluated inside (a host read is not recorded)."""
    if not _ACTIVE.stack:
        yield
        return
    rec = _ACTIVE.stack[-1]
    rec.suppress += 1
    try:
        yield
        nbytes, flops = cost()
    finally:
        rec.suppress -= 1
    rec.add_kernel(name, launches, int(nbytes), int(flops))


def _totals(rec: dict) -> dict:
    rows = list(rec["by_op"].values()) + list(rec["kernels"].values())
    return {k: sum(r[k] for r in rows) for k in ("flops", "bytes",
                                                 "launches")}


def top_ops(rec: dict, n: int = 10) -> list:
    """The ``n`` entries of the record (aten ops and port kernels) with the
    most modelled time, max(bytes / HBM_BW, flops / PEAK_FLOPS)."""
    rows = [{"op": k, **v} for k, v in rec["by_op"].items()] + \
        [{"op": "port:" + k, **v} for k, v in rec["kernels"].items()]
    for r in rows:
        r["t_s"] = max(r["bytes"] / HBM_BW, r["flops"] / PEAK_FLOPS)
    return sorted((r for r in rows if r["t_s"] > 0),
                  key=lambda r: -r["t_s"])[:n]


def _record(fn, args, kwargs) -> dict:
    devs = [t.device.type for t in _tensors((args, kwargs))]
    device_type = devs[0] if devs else "cpu"
    rec = _Recorder(device_type)
    for t in _tensors((args, kwargs)):
        rec.track(t)
    arg_bytes = rec.live
    _ACTIVE.stack.append(rec)
    try:
        with rec:
            fn(*args, **kwargs)
    finally:
        _ACTIVE.stack.pop()
    rec.close()
    return {"device": device_type, "by_op": rec.ops, "kernels": rec.kernels,
            "collectives": {"counts": rec.coll_counts,
                            "bytes_moved": rec.coll_bytes},
            "argument_bytes": arg_bytes, "peak_bytes": rec.peak,
            "temp_bytes": rec.peak - arg_bytes}


def _extrapolate(r2: dict, r3: dict, n: int) -> dict:
    """The record at ``n`` microbatches from those at 2 and 3."""
    def line(a, b):
        return a + (n - 2) * (b - a)

    out = dict(r3)
    for key in ("by_op", "kernels"):
        names = list(r2[key]) + [k for k in r3[key] if k not in r2[key]]
        zero = dict.fromkeys(_FIELDS, 0)
        out[key] = {k: {f: line(r2[key].get(k, zero)[f],
                                r3[key].get(k, zero)[f]) for f in _FIELDS}
                    for k in names}
    c2, c3 = r2["collectives"], r3["collectives"]
    out["collectives"] = {
        "counts": {k: line(c2["counts"].get(k, 0), c3["counts"].get(k, 0))
                   for k in set(c2["counts"]) | set(c3["counts"])},
        "bytes_moved": line(c2["bytes_moved"], c3["bytes_moved"])}
    out["peak_bytes"] = max(r2["peak_bytes"], r3["peak_bytes"])
    out["temp_bytes"] = out["peak_bytes"] - out["argument_bytes"]
    return out


def analyze_step(fn: Callable, *args, n_micro: int = 1, **kwargs) -> dict:
    """Record one call ``fn(*args, **kwargs)``.  With ``n_micro`` > 1,
    ``fn`` takes ``n_micro=k`` and runs the step over the first k
    microbatches of its arguments: it is recorded at k = 2 and 3 (at k =
    ``n_micro`` when that is 2 or 3) and extrapolated to ``n_micro``; the
    peak is the larger of the two runs' (the accumulators live from the
    second microbatch on).

    Returns ``{"device", "n_micro", "flops", "bytes", "launches", "ops"
    (aten calls), "by_op" {op: count, flops, bytes, launches}, "kernels"
    {port kernel: ...}, "collectives" {counts, bytes_moved},
    "argument_bytes", "peak_bytes", "temp_bytes", "top"}``."""
    if n_micro <= 1:
        rec = _record(fn, args, kwargs)
    elif n_micro <= 3:
        rec = _record(fn, args, {**kwargs, "n_micro": n_micro})
    else:
        rec = _extrapolate(_record(fn, args, {**kwargs, "n_micro": 2}),
                           _record(fn, args, {**kwargs, "n_micro": 3}),
                           n_micro)
    rec["n_micro"] = n_micro
    rec.update(_totals(rec))
    rec["ops"] = sum(r["count"] for r in rec["by_op"].values())
    rec["top"] = top_ops(rec)
    return rec


def compare(a: dict, b: dict) -> list:
    """The entries where two records differ: ``(table, name, field, a's,
    b's)`` for every aten op and port kernel of either."""
    diffs = []
    for table in ("by_op", "kernels"):
        ta, tb = a[table], b[table]
        zero = dict.fromkeys(_FIELDS, 0)
        for name in list(ta) + [k for k in tb if k not in ta]:
            ra, rb = ta.get(name, zero), tb.get(name, zero)
            for f in _FIELDS:
                if ra[f] != rb[f]:
                    diffs.append((table, name, f, ra[f], rb[f]))
    return diffs
