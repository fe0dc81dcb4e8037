"""Sharding rules: logical parameter/activation axes -> mesh axes, and the
DTensor placements they give.

The JAX package's ``distributed/sharding.py``: one declarative table decides
where every tensor dimension lives, and the models stay sharding-agnostic
(they tag dimensions with *logical* names via ``ParamSpec.axes``).  The spec
logic is a copy of the JAX package's, rule for rule (the tables, the
progressive divisibility fallback, the per-spec axis dedup); it reads a mesh
only through its axis names and sizes, so it takes either kind of mesh:

* torch's :class:`~torch.distributed.device_mesh.DeviceMesh`
  (``mesh_dim_names`` and the shape of ``mesh.mesh``), one rank per
  position;
* :class:`LocalMesh`, one process's mesh: axis names over an object array of
  ``torch.device``\\ s, the counterpart of ``jax.sharding.Mesh`` over local
  devices.  A position may repeat a device (as JAX's
  ``--xla_force_host_platform_device_count`` does on the host), which is how
  a 2-position mesh runs on one CPU or one card.

Mesh layout (launch/mesh.py):

* single-pod: ``(data=16, model=16)``
* multi-pod:  ``(pod=2, data=16, model=16)``

========  =================  =============================================
logical    mesh axes          meaning
========  =================  =============================================
embed      data               FSDP/ZeRO-3: weights sharded along d_model
mlp        model              Megatron TP (column/row parallel pairs)
heads      model              TP over the flattened q-heads dim
kv         model              TP over the flattened kv dim
vocab      model              sharded embedding + logits matmul
expert     model              expert parallelism
layers     (never sharded)    the scan axis of stacked weights
batch      (pod, data)        activations: DP over pod x data
seq        model (SP mode)    sequence parallelism for long-context cells
========  =================  =============================================

New in the port: :func:`placements_for` turns a spec into DTensor
placements, one per mesh dim (:func:`spec_of` is its inverse), and
:func:`param_shardings` / :func:`distribute_tree` place a tree under them.  A tensor dim sharded over
several mesh axes is laid out in the spec's axis order, major first, as JAX
lays it out (``TRAIN_FSDP_RULES``' batch ``("data", "model", "pod")`` on a
``(pod, data, model)`` mesh is data-major).  DTensor shards a dim over its
mesh dims in mesh order; where the two orders differ, the mesh dim that
comes earlier in the mesh than in the spec takes a ``_StridedShard`` whose
split factor is the size of the spec's axes before it that DTensor has not
split yet, which gives each position JAX's block.

Sharded execution: under :func:`activate` on a ``DeviceMesh`` the models'
tensors are DTensors (parameters placed by :func:`distribute_tree`), their
PyTorch ops run as DTensor ops, :func:`constrain` redistributes at the JAX
package's hook sites, and every kernel wrapper handed a DTensor runs on
each rank's blocks through :func:`on_blocks` (DTensor's ``local_map``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models.params import ParamSpec

MeshAxes = Union[None, str, Tuple[str, ...]]

#: the shortest causal sequence the context-parallel attention path takes
#: (the JAX package's ``models/attention.py:CP_MIN_SEQ``; the port's own
#: copy, which ``models/attention.py`` reads at each call)
CP_MIN_SEQ = 8192


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec`` as a tuple: one entry per tensor dim, each
    None (replicated), a mesh-axis name, or a tuple of names (the dim split
    over their product, the first axis major).  A one-name tuple is stored
    as the bare name, as JAX normalises it.  Trailing Nones are trimmed by
    :func:`spec_for` and :func:`batch_spec`, as in the JAX package."""

    def __new__(cls, *parts: MeshAxes) -> "PartitionSpec":
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class LocalMesh:
    """One process's device mesh: ``axis_names`` over ``devices``, an object
    ndarray of ``torch.device`` (any shape, one axis name a dim).  Positions
    may repeat a device."""

    def __init__(self, devices: Any, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [torch.device(d) for d in arr.reshape(-1)]
        self.devices = flat.reshape(arr.shape)
        self.axis_names = tuple(str(a) for a in axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a mesh "
                             f"of shape {self.devices.shape}")

    def __repr__(self) -> str:
        return (f"LocalMesh({dict(zip(self.axis_names, self.devices.shape))},"
                f" {list(self.devices.reshape(-1))})")


def mesh_axes(mesh: Any) -> Tuple[Tuple[str, int], ...]:
    """((axis name, size), ...) of a ``DeviceMesh``, a :class:`LocalMesh`
    or anything with ``axis_names`` and ``devices.shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        sizes = tuple(mesh.mesh.shape)
    else:
        names, sizes = mesh.axis_names, mesh.devices.shape
    return tuple((str(a), int(s)) for a, s in zip(names, sizes))


def _axis_names(mesh: Any) -> Tuple[str, ...]:
    return tuple(a for a, _ in mesh_axes(mesh))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical-axis -> mesh-axis mapping for one execution regime."""

    name: str
    table: Dict[str, MeshAxes]
    seq_sharded: bool = False    # SP: shard activation seq dim over "model"

    def mesh_axes(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        if logical == "seq" and not self.seq_sharded:
            return None
        return self.table.get(logical)

    def with_seq_sharding(self, on: bool = True) -> "ShardingRules":
        return dataclasses.replace(self, name=self.name + ("+sp" if on else ""),
                                   seq_sharded=on)


TRAIN_RULES = ShardingRules(
    name="train",
    table={
        "embed": "data",
        "mlp": "model",
        "heads": "model",
        "kv": "model",
        "kv_heads": "model",     # unflattened kv-head axis (falls back when
                                 # kv_heads < 16, e.g. GQA kv=8)
        "vocab": "model",
        "expert": "model",
        "layers": None,
        "batch": ("pod", "data"),
        "seq": "model",
        "kv_seq": "model",       # decode KV-cache sequence axis
    },
)

#: Small-model training (< ~20B): no tensor parallelism.  Batch spans
#: ("data", "model", "pod") (pure DP; the progressive fallback drops trailing
#: axes when B does not divide), weights ZeRO-3-shard over "data", and only
#: vocab/expert tables keep "model".
TRAIN_FSDP_RULES = ShardingRules(
    name="train-fsdp",
    table={
        "embed": "data",
        "mlp": None,
        "heads": None,
        "kv": None,
        "kv_heads": None,
        "vocab": "model",
        "expert": "model",
        "layers": None,
        # ("data","model") first so the progressive fallback drops "pod"
        # (2x pod-replicated compute) rather than "model" (16x) when B=256
        # doesn't divide 512.
        "batch": ("data", "model", "pod"),
        "seq": None,
        "kv_seq": "model",
    },
)

#: Params above which training uses TP (TRAIN_RULES) instead of pure FSDP.
TP_PARAM_THRESHOLD = 2e10


def train_rules_for(param_count: int) -> ShardingRules:
    return (TRAIN_RULES if param_count >= TP_PARAM_THRESHOLD
            else TRAIN_FSDP_RULES)


#: Serving: weights keep the 2-D (data x model) layout so big models fit;
#: the KV cache is seq-sharded over "model".
SERVE_RULES = ShardingRules(
    name="serve",
    table={
        "embed": "data",
        "mlp": "model",
        "heads": "model",
        "kv": "model",
        "kv_heads": "model",
        "vocab": "model",
        "expert": "model",
        "layers": None,
        "batch": ("pod", "data"),
        "seq": "model",
        "kv_seq": "model",
    },
)


# ---------------------------------------------------------------------------
# Active-rules context (thread-local, so tests stay single-device no-ops)
# ---------------------------------------------------------------------------
class _State(threading.local):
    rules: Optional[ShardingRules] = None
    mesh: Any = None


_STATE = _State()


@contextlib.contextmanager
def activate(rules: ShardingRules, mesh: Any):
    """Enable :func:`constrain` inside this block."""
    prev = (_STATE.rules, _STATE.mesh)
    _STATE.rules, _STATE.mesh = rules, mesh
    try:
        yield
    finally:
        _STATE.rules, _STATE.mesh = prev


def active_rules() -> Optional[ShardingRules]:
    return _STATE.rules


def active_mesh() -> Any:
    return _STATE.mesh


def active_axis_size(axis: str) -> int:
    """Size of a mesh axis under the active rules (1 when inactive)."""
    mesh = _STATE.mesh
    if mesh is None:
        return 1
    return dict(mesh_axes(mesh)).get(axis, 1)


def _axis_size(mesh: Any, axes: MeshAxes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = dict(mesh_axes(mesh))
    size = 1
    for a in axes:
        size *= sizes.get(a, 1)
    return size


def _prune(mesh: Any, axes: MeshAxes) -> MeshAxes:
    """Drop mesh axes the mesh does not have (e.g. 'pod' single-pod)."""
    if axes is None:
        return None
    names = _axis_names(mesh)
    if isinstance(axes, str):
        return axes if axes in names else None
    kept = tuple(a for a in axes if a in names)
    return kept if kept else None


def spec_for(logical_axes: Sequence[Optional[str]],
             rules: Optional[ShardingRules] = None,
             mesh: Any = None,
             shape: Optional[Tuple[int, ...]] = None) -> PartitionSpec:
    """PartitionSpec for a tensor whose dims carry ``logical_axes`` names.

    * divisibility fallback — a dim not divisible by its mesh-axis product
      progressively drops trailing mesh axes and replicates if nothing
      divides;
    * dedup — a mesh axis may appear only once per spec; later dims lose it.
    """
    rules = rules or _STATE.rules
    mesh = mesh or _STATE.mesh
    if rules is None:
        return P()
    used: set = set()
    out = []
    for i, name in enumerate(logical_axes):
        axes = rules.mesh_axes(name)
        if mesh is not None:
            axes = _prune(mesh, axes)
        if axes is not None:
            tup = (axes,) if isinstance(axes, str) else tuple(axes)
            tup = tuple(a for a in tup if a not in used)
            if shape is not None and mesh is not None:
                while tup and shape[i] % _axis_size(mesh, tup) != 0:
                    tup = tup[:-1]
            used.update(tup)
            axes = (None if not tup else
                    tup[0] if len(tup) == 1 else tup)
        out.append(axes)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def placements_for(spec: Sequence[MeshAxes], mesh: Any) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` where tensor dim d is split over that mesh axis (a
    ``_StridedShard`` where the spec orders the axes of d otherwise than the
    mesh does, see the module docstring), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    axes = mesh_axes(mesh)
    order = {a: i for i, (a, _) in enumerate(axes)}
    out: list = [Replicate() for _ in axes]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        for j, a in enumerate(names):
            i = order[a]
            split = 1
            for b in names[:j]:
                if order[b] > i:
                    split *= axes[order[b]][1]
            if split == 1:
                out[i] = Shard(dim)
            else:
                from torch.distributed.tensor.placement_types import (
                    _StridedShard)
                out[i] = _StridedShard(dim, split_factor=split)
    return tuple(out)


def shard_slices(spec: Sequence[MeshAxes], mesh: Any,
                 shape: Tuple[int, ...]) -> np.ndarray:
    """The block of a ``shape`` tensor each mesh position holds under
    ``spec``, as JAX's ``devices_indices_map`` gives it: an object ndarray
    of the mesh's shape, each entry a tuple of ``slice`` per dim.  Every
    sharded dim must divide by its axes' product (as :func:`spec_for`
    guarantees when given the shape)."""
    axes = mesh_axes(mesh)
    sizes = dict(axes)
    names = [a for a, _ in axes]
    out = np.empty(tuple(s for _, s in axes), dtype=object)
    for pos in np.ndindex(out.shape):
        coord = dict(zip(names, pos))
        sl = []
        for dim, n in enumerate(shape):
            entry = spec[dim] if dim < len(spec) else None
            if entry is None:
                sl.append(slice(0, n))
                continue
            group = (entry,) if isinstance(entry, str) else tuple(entry)
            parts, idx = 1, 0
            for a in group:
                idx = idx * sizes[a] + coord[a]
                parts *= sizes[a]
            if n % parts:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                 f"split over {group} ({parts} parts)")
            step = n // parts
            sl.append(slice(idx * step, (idx + 1) * step))
        out[pos] = tuple(sl)
    return out


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """The JAX package's ``with_sharding_constraint`` hook: a no-op unless
    rules and a ``DeviceMesh`` are active and ``x`` is a DTensor, which is
    then redistributed to the rule's placements."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor
    mesh = _STATE.mesh
    if (_STATE.rules is None or not isinstance(mesh, DeviceMesh)
            or not isinstance(x, DTensor)):
        return x
    spec = spec_for(logical_axes, shape=tuple(x.shape))
    return x.redistribute(mesh, placements_for(spec, mesh))


# ---------------------------------------------------------------------------
# Kernels on each rank's blocks
# ---------------------------------------------------------------------------
def is_dtensor(*xs: Any) -> bool:
    """True when any of ``xs`` is a DTensor."""
    from torch.distributed.tensor import DTensor
    return any(isinstance(x, DTensor) for x in xs)


def whole_on(placements: Sequence[Any], *dims: int) -> Tuple[Any, ...]:
    """``placements`` with every shard of tensor dims ``dims``, and every
    pending partial sum, replaced by ``Replicate()``: the layout of an input
    whose kernel reduces or scans along those dims (and of its output), the
    rest kept as it comes."""
    from torch.distributed.tensor import Partial, Replicate
    return tuple(Replicate() if getattr(pl, "dim", None) in dims
                 or isinstance(pl, Partial) else pl for pl in placements)


def remap(placements: Sequence[Any], dims: Dict[int, int]) -> Tuple[Any, ...]:
    """The placements of another tensor that shares some dims with the one
    ``placements`` lay out: a shard of dim ``d`` in ``dims`` becomes the
    same shard of dim ``dims[d]``, every other mesh dim ``Replicate()``
    (a kernel's weights and states follow its main input's layout)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for pl in placements:
        d = getattr(pl, "dim", None)
        if d not in dims:
            out.append(Replicate())
        elif type(pl) is Shard:
            out.append(Shard(dims[d]))
        else:                                     # a _StridedShard
            out.append(type(pl)(dims[d], split_factor=pl.split_factor))
    return tuple(out)


def block_of(mesh: Any, placements: Sequence[Any], dim: int
             ) -> Tuple[int, int]:
    """(this rank's block index, the number of blocks) of tensor dim
    ``dim`` under ``placements``: the dim's mesh axes in mesh order, the
    first major (plain ``Shard`` placements)."""
    coord = mesh.get_coordinate()
    sizes = tuple(mesh.mesh.shape)
    idx, parts = 0, 1
    for i, pl in enumerate(placements):
        if getattr(pl, "dim", None) == dim:
            idx, parts = idx * sizes[i] + coord[i], parts * sizes[i]
    return idx, parts


#: when True, :func:`replicated` checks that every rank made the same
#: tensor (a gather over each mesh dim a call; the rank tests set it)
CHECK_REPLICATED = False


def replicated(x: torch.Tensor, like: Any) -> torch.Tensor:
    """``x``, a plain tensor that every rank makes alike (a constant built
    from shapes or host integers: positions, a row index, a mask), as a
    DTensor replicated on the mesh of the DTensor ``like``; ``x`` as it is
    when ``like`` is not a DTensor or ``x`` already is one.  The one way a
    plain tensor joins DTensors, named at the site that makes it: DTensor
    refuses an op that mixes the two.  Under :data:`CHECK_REPLICATED` it
    raises ``ValueError`` where the ranks' tensors differ."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(like, DTensor) or isinstance(x, DTensor):
        return x
    mesh = like.device_mesh
    if CHECK_REPLICATED:
        import torch.distributed as dist
        t = x.detach().contiguous()
        t = t.to(torch.uint8) if t.dtype == torch.bool else t
        for d in range(mesh.ndim):
            got = [torch.empty_like(t) for _ in range(mesh.size(d))]
            dist.all_gather(got, t, group=mesh.get_group(d))
            if not all(torch.equal(g, t) for g in got):
                raise ValueError(f"replicated: the ranks along mesh dim {d} "
                                 f"hold different tensors of shape "
                                 f"{tuple(x.shape)}")
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def on_blocks(fn, args: Sequence[Any], in_placements: Sequence[Any],
              out_placements: Any):
    """``fn(*args)`` on each rank's blocks, through DTensor's ``local_map``:
    every tensor argument is first redistributed to its entry of
    ``in_placements`` (None for an argument that is not a tensor; a
    ``Partial`` entry is read ``Replicate``: a pending sum is reduced
    first), ``fn`` runs on the local tensors (a kernel wrapper: the
    hand-written kernel on the card, its plain version on the CPU), and its
    outputs come back as DTensors under ``out_placements`` (one tuple, or a
    tuple of them for a tuple of outputs).  A tensor argument with
    placements must be a DTensor (a constant the caller made goes through
    :func:`replicated` first): a plain one raises ``TypeError``.  Gradients
    flow back through it: an input replicated on a mesh dim where an output
    is sharded gets a partial gradient there (each rank's block of the
    output reaches only its own share of the input's gradient), sharded
    inputs their own layout.

    The one route by which a kernel reaches a DTensor: the launch itself
    (``kernels/common.py:ptr``) refuses one."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    # a kernel reads values: a pending partial sum is reduced first
    in_placements = tuple(
        None if pls is None else tuple(
            Replicate() if isinstance(pl, Partial) else pl for pl in pls)
        for pls in in_placements)
    for i, (a, pls) in enumerate(zip(args, in_placements)):
        if pls is not None and not isinstance(a, DTensor):
            raise TypeError(f"on_blocks: argument {i} has placements but is "
                            f"a {type(a).__name__}, not a DTensor (make a "
                            f"constant with sharding.replicated)")
    outs = (out_placements if out_placements and isinstance(
        out_placements[0], (tuple, list)) else (out_placements,))
    sharded = {i for o in outs for i, pl in enumerate(o)
               if not isinstance(pl, Replicate)}
    grads = tuple(
        None if pls is None else tuple(
            Partial() if isinstance(pl, Replicate) and i in sharded else pl
            for i, pl in enumerate(pls))
        for pls in in_placements)
    # local_map reads a tuple as one entry an output, a list as one output
    return local_map(fn, out_placements=tuple(list(o) for o in outs),
                     in_placements=tuple(in_placements),
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


# ---------------------------------------------------------------------------
# Parameter / batch specs (used by launch + checkpoint)
# ---------------------------------------------------------------------------
def _map_specs(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, ParamSpec):
        return fn(tree)
    raise TypeError(f"not a ParamSpec tree leaf: {type(tree).__name__}")


def param_specs(spec_tree, rules: ShardingRules, mesh: Any):
    """Tree of PartitionSpecs for a ParamSpec tree (divisibility-checked)."""
    return _map_specs(lambda s: spec_for(s.axes, rules, mesh, s.shape),
                      spec_tree)


def param_shardings(spec_tree, rules: ShardingRules, mesh: Any):
    """Tree of DTensor placements (one tuple per leaf) for a ParamSpec tree
    on a ``DeviceMesh`` — the JAX package's ``NamedSharding`` tree."""
    return _map_specs(
        lambda s: placements_for(spec_for(s.axes, rules, mesh, s.shape), mesh),
        spec_tree)


def spec_of(placements: Sequence[Any], mesh: Any) -> PartitionSpec:
    """The spec whose :func:`placements_for` on ``mesh`` is ``placements``:
    each tensor dim's mesh axes, in the order (of the few a dim has) that
    gives back its ``Shard`` / ``_StridedShard`` placements."""
    import itertools

    def key(pl):
        # by type: a _StridedShard compares equal to a Shard of its dim in
        # some torch versions, and is not a Shard subclass in others
        return (type(pl).__name__, getattr(pl, "dim", None),
                getattr(pl, "split_factor", None))

    axes = [a for a, _ in mesh_axes(mesh)]
    want = [key(pl) for pl in placements]
    by_dim: Dict[int, list] = {}
    for a, pl in zip(axes, placements):
        if hasattr(pl, "dim"):                  # Shard or _StridedShard
            by_dim.setdefault(pl.dim, []).append(a)
    entries: list = [None] * (max(by_dim) + 1 if by_dim else 0)
    for dim, names in by_dim.items():
        for order in itertools.permutations(names):
            entries[dim] = order[0] if len(order) == 1 else order
            got = [key(pl) for pl in placements_for(P(*entries), mesh)]
            if all(got[i] == want[i] for i, a in enumerate(axes)
                   if a in names):
                break
        else:
            raise ValueError(f"no spec gives placements {tuple(placements)}")
    return P(*entries)


def distribute_tree(tree, placements_tree, mesh: Any):
    """Every leaf of ``tree`` (a whole tensor, the same on every rank, on
    the host or the device) as a DTensor under the matching placements of
    ``placements_tree`` on ``mesh`` (a ``DeviceMesh``).  Each rank cuts its
    own block (:func:`shard_slices` of :func:`spec_of`, JAX's layout) where
    the leaf lies and moves only that block to the mesh's device, as JAX's
    ``device_put`` of a host array moves each device its shard: a sharded
    leaf never reaches the device whole (no scatter either)."""
    from torch.distributed.tensor import DTensor
    device = torch.device(mesh.device_type)

    def one(x, placements):
        x = torch.as_tensor(x)
        shape = tuple(x.shape)
        block = x[shard_slices(spec_of(placements, mesh), mesh, shape)[
            tuple(mesh.get_coordinate())]]
        local = block.contiguous().to(device)
        return DTensor.from_local(
            local, mesh, list(placements), run_check=False,
            shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())

    if isinstance(tree, dict):
        return {k: distribute_tree(v, placements_tree[k], mesh)
                for k, v in tree.items()}
    return one(tree, placements_tree)


def batch_spec(rules: ShardingRules, mesh: Any, ndim: int = 2) -> PartitionSpec:
    """(B, S, ...) batch: B over (pod, data); S per the SP flag."""
    axes: list = [_prune(mesh, rules.mesh_axes("batch"))]
    if ndim > 1:
        axes.append(_prune(mesh, rules.mesh_axes("seq")))
    axes += [None] * (ndim - len(axes))
    while axes and axes[-1] is None:
        axes.pop()
    return P(*axes)
