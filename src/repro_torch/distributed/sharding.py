"""Logical-axis sharding rules (the port of ``distributed/sharding.py``).

Every parameter and activation dimension carries a *logical* axis name;
the rules map logical names to mesh axis names.  A dimension that the
product of its mesh axes does not divide is replicated instead (granite's
24 heads or 8 KV heads on a 16-way model axis), so one rule table holds
for every config.

Specs resolve against a mesh *description* (:class:`Mesh`: axis names and
sizes), so the production meshes (16, 16) and (2, 16, 16) resolve without
256 processes.  A mesh that is to place tensors also carries a
``torch.distributed`` ``DeviceMesh`` over the initialised process group
(``launch/mesh.py::device_mesh``); :meth:`NamedSharding.placements` turns
a spec into its DTensor placements, a dimension sharded over several mesh
axes (``batch`` -> ``("pod", "data")``) becoming ``Shard(dim)`` on each.

The port's model code runs replicated over the mesh, apart from the paths
that call a collective themselves (``distributed/collectives.py``,
``models/moe.py::_moe_ep``, ``distributed/grad_compression.py``); each
rank holds its own shard of what those paths shard.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

AxisName = Union[str, Tuple[str, ...], None]

# logical axis -> mesh axes (tuple = sharded over multiple mesh axes)
DEFAULT_RULES: Dict[str, AxisName] = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_sp": "model",        # Megatron-SP: layer-boundary activations seq-sharded
    "kv_seq": "model",        # KV-cache sequence dim (used when kv heads don't divide)
    "d_model": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "d_ff": "model",
    "experts": "model",
    "expert_ff": "model",     # claims model ONLY if experts could not (spec_for order)
    "vocab": "model",
    "ssm_heads": "model",
    "ssm_state": None,
    "ssm_groups": None,
    "conv_k": None,
    "layers": None,           # the stacking axis
    "rank": None,             # LoRA / JD rank
    "adapters": None,
    "clusters": None,
    "stats": None,
}


class P(tuple):
    """A partition spec: per dimension a mesh axis name, a tuple of names
    (sharded over their product, the first the outermost) or None."""

    def __new__(cls, *parts: AxisName):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh: axis names and sizes, ranks laid out row-major over them (as
    ``jax.make_mesh`` lays devices).  ``device_mesh`` is the
    ``torch.distributed`` DeviceMesh that places tensors and names the
    process groups, or None for a description only."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device_mesh: Any = dataclasses.field(default=None, compare=False,
                                         repr=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    def _dm(self):
        if self.device_mesh is None:
            raise ValueError("this mesh is a description: build it over a "
                             "process group with launch.mesh.device_mesh")
        return self.device_mesh

    def group(self, axis: str):
        """The process group of this rank's ranks along ``axis``."""
        return self._dm().get_group(axis)

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return int(self._dm().get_local_rank(axis))

    def coordinates(self) -> Dict[str, int]:
        return {a: self.coordinate(a) for a in self.axis_names}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.rules: Dict[str, AxisName] = dict(DEFAULT_RULES)


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh],
             rules: Optional[Dict[str, AxisName]] = None):
    """Activate a mesh + rules for spec resolution, constraints and the
    paths that shard over the mesh."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    if rules is not None:
        _CTX.rules = {**DEFAULT_RULES, **rules}
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh() -> Optional[Mesh]:
    return _CTX.mesh


def _mesh_axis_size(mesh: Mesh, name: AxisName) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= _mesh_axis_size(mesh, n)
        return out
    return mesh.shape.get(name, 1)


def _resolve_axis(mesh: Mesh, rules, logical: Optional[str],
                  dim: int) -> AxisName:
    if logical is None:
        return None
    mapped = rules.get(logical)
    if mapped is None:
        return None
    # drop mesh axes absent from this mesh (e.g. "pod" on single-pod)
    shape = mesh.shape
    if isinstance(mapped, tuple):
        mapped = tuple(m for m in mapped if m in shape)
        if not mapped:
            return None
        if len(mapped) == 1:
            mapped = mapped[0]
    elif mapped not in shape:
        return None
    size = _mesh_axis_size(mesh, mapped)
    if size <= 1 or dim % size != 0:
        return None  # divisibility fallback -> replicate
    return mapped


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]],
             mesh: Optional[Mesh] = None,
             rules: Optional[Dict[str, AxisName]] = None) -> P:
    """Partition spec of an array with the given logical axes under a
    mesh (the current one by default); ``P()`` without a mesh."""
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules
    if mesh is None:
        return P()
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)} "
                         f"differ in length")
    used = set()
    parts = []
    for dim, ax in zip(shape, axes):
        resolved = _resolve_axis(mesh, rules, ax, dim)
        # a mesh axis may appear at most once in a spec
        flat = (resolved,) if isinstance(resolved, str) else (resolved or ())
        if any(f in used for f in flat):
            resolved = None
        else:
            used.update(flat)
        parts.append(resolved)
    return P(*parts)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s counterpart)."""
    mesh: Mesh
    spec: P

    def placements(self) -> list:
        """The spec as DTensor placements, one per mesh axis."""
        return placements(self.spec, self.mesh)

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of one rank's shard of an array of ``shape``."""
        return local_shape(shape, self.spec, self.mesh)


def _spec_axes(spec: P):
    """(dim, mesh axis) pairs of a spec, axes of one dim in spec order."""
    for dim, part in enumerate(spec):
        for a in ((part,) if isinstance(part, str) else (part or ())):
            yield dim, a


def placements(spec: P, mesh: Mesh) -> list:
    """``Shard(dim)`` on each mesh axis the spec shards ``dim`` over,
    ``Replicate()`` on the rest.  DTensor splits a dim over its mesh axes
    in the mesh's order, so the axes of one dim must come in that order."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh.axis_names]
    seen: Dict[int, int] = {}
    for dim, a in _spec_axes(spec):
        i = mesh.axis_names.index(a)
        if seen.get(dim, -1) > i:
            raise ValueError(f"spec {spec}: dim {dim}'s mesh axes are not in "
                             f"the mesh's order {mesh.axis_names}")
        seen[dim] = i
        out[i] = Shard(dim)
    return out


def local_shape(shape: Sequence[int], spec: P, mesh: Mesh) -> Tuple[int, ...]:
    out = list(shape)
    for dim, a in _spec_axes(spec):
        out[dim] //= mesh.shape[a]
    return tuple(out)


def local_block(shape: Sequence[int], spec: P, mesh: Mesh,
                coords: Dict[str, int]) -> Tuple[slice, ...]:
    """The slices of an array of ``shape`` that the rank at ``coords``
    (index along each mesh axis) holds under ``spec``: a dim sharded over
    several axes splits over the first, then each piece over the next."""
    out = []
    for dim, size in enumerate(shape):
        start, n = 0, size
        part = spec[dim] if dim < len(spec) else None
        for a in ((part,) if isinstance(part, str) else (part or ())):
            n //= mesh.shape[a]
            start += coords[a] * n
        out.append(slice(start, start + n))
    return tuple(out)


def sharding_for(shape, axes, mesh=None,
                 rules=None) -> Optional[NamedSharding]:
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return None
    return NamedSharding(mesh, spec_for(shape, axes, mesh, rules))


def constrain(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Redistribute a DTensor to the spec of its logical axes; the identity
    on a plain tensor (each rank's own) or without a mesh."""
    mesh = _CTX.mesh
    if mesh is None or mesh.device_mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = spec_for(x.shape, axes, mesh, _CTX.rules)
    return x.redistribute(mesh.device_mesh, placements(spec, mesh))


def batch_spec(mesh: Optional[Mesh] = None) -> P:
    """Spec for a (B, ...) input batch dim."""
    # a huge dim: always divisible
    return spec_for((1 << 30,), ("batch",), mesh)
