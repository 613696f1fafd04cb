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

Inside :func:`sharded_step` (the port of a ``jax.jit`` with
``in_shardings``) the model runs on DTensors: :func:`constrain` at the
JAX module's points redistributes an activation to the spec of its
logical axes, and DTensor's sharding propagation inserts the collectives
GSPMD inserts.  Work that must see a rank's own block (a port kernel, a
path that calls a collective itself, an op DTensor has no rule for: the
cache writes, the attention's and the SSD's head-grouping views, a lookup
into a vocab-sharded table, the vocab-sharded cross-entropy) runs
between :func:`island_local` / :func:`island_locals` (a ``redistribute``
and ``to_local``; the latter takes a replicated input's gradient as the
partial sum a ``shard_map`` body's transpose gives it) and
:func:`island_out` (``DTensor.from_local``), as JAX's ``shard_map``
regions do; nothing there assembles a whole tensor.  Outside it, plain
tensors are each rank's own (``distributed/collectives.py``,
``models/moe.py::_moe_ep``, ``distributed/grad_compression.py``) and
:func:`constrain` leaves them as they are.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

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
        self.sharded = False


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


@contextlib.contextmanager
def sharded_step(mesh: Mesh, rules: Optional[Dict[str, AxisName]] = None):
    """Run the model's step on DTensors placed on ``mesh`` (which must
    carry a DeviceMesh): the mesh and activation rules active, every
    :func:`constrain` a redistribute that refuses a plain tensor, and a
    plain tensor that meets a DTensor in an op (a mask, a position, a
    constant) taken as replicated."""
    mesh._dm()
    prev = _CTX.sharded
    # torch's implicit_replication() clears the switch on exit, which would
    # end an enclosing step's (a checkpointed layer's recompute re-enters)
    disp = DTensor._op_dispatcher
    prev_implicit = disp._allow_implicit_replication
    _CTX.sharded = True
    disp._allow_implicit_replication = True
    try:
        with use_mesh(mesh, rules):
            yield
    finally:
        _CTX.sharded = prev
        disp._allow_implicit_replication = prev_implicit


def context():
    """The active mesh context (mesh, rules, sharded), for
    :func:`use_context` to re-enter elsewhere: the context is
    thread-local, and a checkpointed layer's recompute runs in the
    autograd engine's thread."""
    return (_CTX.mesh, dict(_CTX.rules), _CTX.sharded)


@contextlib.contextmanager
def use_context(ctx):
    """Re-enter a context that :func:`context` captured."""
    mesh, rules, sharded = ctx
    if sharded:
        with sharded_step(mesh, rules):
            yield
    else:
        with use_mesh(mesh, rules):
            yield


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


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
    """Redistribute a DTensor to the spec of its logical axes.  Inside
    :func:`sharded_step` a plain tensor raises ``TypeError``: a value has
    left the sharded step.  Outside it, the identity on a plain tensor
    (each rank's own) or without a mesh."""
    mesh = _CTX.mesh
    if mesh is None:
        return x
    if not isinstance(x, DTensor):
        if _CTX.sharded:
            raise TypeError(f"constrain{axes}: a plain {type(x).__name__} "
                            f"of shape {tuple(x.shape)} inside the sharded "
                            f"step, where every activation is a DTensor")
        return x
    if mesh.device_mesh is None:
        return x
    spec = spec_for(x.shape, axes, mesh, _CTX.rules)
    return x.redistribute(mesh.device_mesh, placements(spec, mesh))


# ---------------------------------------------------------------------------
# per-rank islands inside the sharded step (JAX's shard_map regions)
# ---------------------------------------------------------------------------


def replace_placements(pl: Sequence, fn) -> list:
    """``fn(mesh_dim, placement)`` applied to each placement."""
    return [fn(i, p) for i, p in enumerate(pl)]


def island_local(x: torch.Tensor, pl: Sequence) -> torch.Tensor:
    """This rank's block of DTensor ``x`` under the placements ``pl`` (a
    redistribute, then ``to_local``)."""
    return x.redistribute(x.device_mesh, list(pl)).to_local()


def island_locals(*pairs) -> list:
    """Each ``(DTensor, placements)`` as this rank's block, for an island
    that trains: where an input is replicated over a mesh dim along which
    another input is split, each rank computes something else from it,
    so its gradient is a partial sum there (the transpose of a
    ``shard_map`` body's unsplit input)."""
    split = {i for _, pl in pairs for i, p in enumerate(pl)
             if not isinstance(p, Replicate)}
    out = []
    for x, pl in pairs:
        grad_pl = [Partial() if isinstance(p, Replicate) and i in split
                   else p for i, p in enumerate(pl)]
        out.append(x.redistribute(x.device_mesh, list(pl)).to_local(
            grad_placements=grad_pl))
    return out


def head_blocks(q, kv):
    """Placements for a per-head island: ``q`` (B, S, H, ...) and ``kv``
    (B, S', Kv, ...) DTensors, head ``h`` reading kv head ``h // (H //
    Kv)`` (GQA; the SSD's heads and groups alike).  Returns ``(pl_q,
    pl_kv, narrow)``: both keep q's batch sharding; q's heads go over
    "model" where the model axis divides them, kv's too where it divides
    them, else kv stays whole there and each rank narrows it to
    ``narrow = (start, n)``, the kv heads its own q heads read; every other
    dim whole."""
    pl_q = replace_placements(q.placements, lambda i, p: p if (
        isinstance(p, Shard) and p.dim == 0) else Replicate())
    pl_kv = list(pl_q)
    narrow = None
    md = mesh_dim(q, "model")
    M = q.device_mesh.size(md) if md is not None else 1
    H, Kv = q.shape[2], kv.shape[2]
    if M > 1 and H % M == 0:
        G, H_loc = H // Kv, H // M
        if Kv % M == 0:
            pl_q[md] = pl_kv[md] = Shard(2)
        elif H_loc % G == 0 or G % H_loc == 0:
            pl_q[md] = Shard(2)
            r = q.device_mesh.get_local_rank(md)
            narrow = ((r * H_loc) // G, max(H_loc // G, 1))
    return pl_q, pl_kv, narrow


class _WholeGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pl):
        ctx.pl = pl
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != tuple(ctx.pl):
            g = g.redistribute(g.device_mesh, ctx.pl)
        return g, None


def whole_grad(y: torch.Tensor) -> torch.Tensor:
    """``y`` (a DTensor; a plain tensor passes as it is), whose gradient is
    brought to ``y``'s batch sharding with every other dim whole before
    it reaches the op that made ``y``: a layer's output joins the
    residual stream, whose gradient comes back sequence-sharded over the
    model axis (the carry's "seq_sp"), and a matrix product's backward
    cannot flatten a batch and a sequence sharded at once."""
    if not _CTX.sharded or not isinstance(y, DTensor):
        return y
    pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
               for p in y.placements)
    return _WholeGrad.apply(y, pl)


class SumOverRanks(torch.autograd.Function):
    """A sum all-reduce of each rank's part, whose backward passes the
    (replicated) cotangent to each part unchanged: the transpose of the
    sum of the parts (JAX's psum under ``shard_map``)."""

    @staticmethod
    def forward(ctx, y, group):
        import torch.distributed as dist
        y = y.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def max_over_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over the group's ranks, without a gradient (a
    softmax's shift)."""
    import torch.distributed as dist
    x = x.detach().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def island_out(t: torch.Tensor, like, pl: Sequence, shape=None):
    """A DTensor on ``like``'s DeviceMesh (``like`` a DTensor or the
    DeviceMesh) from this rank's block ``t`` under the placements ``pl``;
    ``shape`` the global shape (by default ``t``'s, each sharded dim times
    its mesh dims' sizes)."""
    dm = getattr(like, "device_mesh", like)
    if shape is None:
        shape = list(t.shape)
        for i, p in enumerate(pl):
            if isinstance(p, Shard):
                shape[p.dim] *= dm.size(i)
    shape = tuple(shape)
    stride, n = [], 1
    for d in reversed(shape):
        stride.append(n)
        n *= d
    # contiguous, as the stride given says (DTensor views the local block
    # by it)
    return DTensor.from_local(t.contiguous(), dm, list(pl), run_check=False,
                              shape=shape, stride=tuple(reversed(stride)))


def global_offset(x, dim: int) -> int:
    """Where this rank's block of DTensor ``x`` starts along ``dim``
    (shards split evenly, a dim over several mesh dims in mesh order)."""
    dm = x.device_mesh
    coords = dm.get_coordinate()
    n, off = x.shape[dim], 0
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            n //= dm.size(i)
            off += coords[i] * n
    return off


def mesh_dim(x, axis: str) -> Optional[int]:
    """The index of mesh axis ``axis`` in ``x``'s DeviceMesh, or None."""
    names = x.device_mesh.mesh_dim_names or ()
    return names.index(axis) if axis in names else None


def write_slice(cache: torch.Tensor, new: torch.Tensor, start: int,
                dim: int, inplace: bool = False) -> torch.Tensor:
    """``cache`` with ``new`` written at ``[start, start + n)`` along
    ``dim`` (``new`` in ``cache``'s dtype), a copy unless ``inplace``.  On
    a DTensor each rank writes the part of ``new`` that falls in its own
    block (``new`` is laid out as ``cache``, ``dim`` replicated): DTensor
    has no rule for a slice assignment on a sharded dim."""
    if not is_dtensor(cache):
        out = cache if inplace else cache.clone()
        out.narrow(dim, start, new.shape[dim]).copy_(new.to(out.dtype))
        return out
    pl = list(cache.placements)
    new_l = island_local(new.to(cache.dtype), replace_placements(
        pl, lambda i, p: Replicate() if isinstance(p, Shard) and p.dim == dim
        else p))
    loc = cache.to_local()
    out = loc if inplace else loc.clone()
    off = global_offset(cache, dim)
    lo = max(start, off)
    hi = min(start + new.shape[dim], off + loc.shape[dim])
    if hi > lo:
        out.narrow(dim, lo - off, hi - lo).copy_(
            new_l.narrow(dim, lo - start, hi - lo))
    return cache if inplace else island_out(out, cache, pl, cache.shape)


def unshard_batch_axes(tree):
    """A parameter tree with every DTensor leaf gathered over the batch
    mesh axes ("pod", "data"): FSDP's gather before use, under the train
    rules (where the weights' d_model is sharded over them); a leaf
    sharded only over "model" or a plain tensor is returned as it is.
    Autograd takes the gradient back to the leaf's placements (a reduce-
    scatter).  Outside :func:`sharded_step` the tree as it is."""
    if not _CTX.sharded:
        return tree

    def one(x):
        if not isinstance(x, DTensor):
            return x
        names = x.device_mesh.mesh_dim_names or ()
        pl = replace_placements(x.placements, lambda i, p: Replicate() if (
            names[i] in ("pod", "data")) else p)
        if pl == list(x.placements):
            return x
        return x.redistribute(x.device_mesh, pl)

    def walk(t):
        return {k: walk(v) for k, v in t.items()} if isinstance(t, dict) \
            else one(t)

    return walk(tree)


def batch_spec(mesh: Optional[Mesh] = None) -> P:
    """Spec for a (B, ...) input batch dim."""
    # a huge dim: always divisible
    return spec_for((1 << 30,), ("batch",), mesh)
