"""Parameter-spec trees: one source of truth for shapes and init.

Every model module describes its parameters as a nested dict of
:class:`ParamSpec` (shape + logical axis names + init law), in the JAX
package's layout: the per-position weights of ``blocks`` are stacked over
``n_groups`` on a leading ``"layers"`` axis.  :func:`init_params` turns such
a tree into tensors of the same layout; :class:`repro_torch.models.
transformer.Transformer` unstacks them into one module per layer.

Leaves are addressed by their path in the format ``jax.tree_util.keystr``
gives (``"['blocks']['pos0']['block']['wq']"``), dict keys in sorted order,
so a path names the same leaf in both packages.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from ..core.runtime import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # "normal" | "zeros" | "ones" | "constant"
    scale: float = 1.0            # stddev for normal (already fan-adjusted)
    constant: float = 0.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             "in length")


def dense_spec(in_dim: int, out_dim: int, axes=("embed", "mlp"),
               scale: float | None = None, stacked: int = 0) -> ParamSpec:
    """A (in, out) matmul weight with 1/sqrt(fan_in) init."""
    scale = in_dim ** -0.5 if scale is None else scale
    shape: Tuple[int, ...] = (in_dim, out_dim)
    ax: Tuple[Optional[str], ...] = tuple(axes)
    if stacked:
        shape = (stacked,) + shape
        ax = ("layers",) + ax
    return ParamSpec(shape, ax, "normal", scale)


def leaves_with_path(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) for every non-dict leaf of a nested dict, keys sorted,
    paths as ``jax.tree_util.keystr`` writes them."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves_with_path(tree[key], f"{prefix}[{key!r}]")
    else:
        yield prefix, tree


def map_tree(fn, tree: Any) -> Any:
    """``fn`` applied to every non-dict leaf, the dict structure kept."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def leaf_seed(seed: int, path: str) -> int:
    """The generator seed of one leaf, from ``seed`` and the CRC-32 of its
    path (never builtin ``hash()``, which is salted per process), mixed into
    32 bits: the CPU generator reads only the low 32 bits of a seed.  An odd
    multiplier keeps distinct seeds distinct for one path."""
    return (zlib.crc32(path.encode()) ^ (int(seed) * 2654435761)) % 2 ** 32


def state_device(device=None) -> torch.device:
    """Where a model state (a cache, a recurrent state) is made: the card
    when ``device`` is None, ``meta`` for shapes alone, else ``device``
    through :func:`~repro_torch.core.runtime.resolve_device` (which raises
    when the card is asked for and there is none)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device("cuda" if device is None else device)


#: a ``normal`` leaf of more elements than this is drawn slice by slice
DRAW_SLICE = 2 ** 30


def draw_rows(shape: Tuple[int, ...]) -> int:
    """How many slices :func:`init_params` draws a leaf of ``shape`` in:
    1 up to :data:`DRAW_SLICE` elements, else the rows of the fewest
    leading axes whose rows each hold at most that many."""
    n, rows = 1, 1
    for s in shape:
        n *= s
    for s in shape:
        if n <= DRAW_SLICE:
            break
        n //= s
        rows *= s
    return rows


def init_params(spec_tree: Dict[str, Any], seed: int, *,
                dtype: torch.dtype = torch.float32,
                device: Any = None) -> Dict[str, Any]:
    """Concrete init of a spec tree, on ``device`` (default: the card).

    Each ``normal`` leaf is drawn from its own ``torch.Generator`` on
    ``device``, seeded from ``(seed, crc32(path))`` (:func:`leaf_seed`), so
    adding or removing a parameter never perturbs the others.  The draw is
    in float32 and scaled before the cast to ``dtype``, as the JAX
    package's ``init_params`` does; its threefry bits cannot be replayed, so
    these values are not the JAX package's (parity tests carry the JAX
    parameters across with ``params_from_jax``).

    A leaf of more than :data:`DRAW_SLICE` elements (an MoE's stacked
    experts: moonshot's ``wi`` holds 8.86 G) is drawn in slices along its
    leading axes (:func:`draw_rows`), one after another from its generator,
    each scaled in place and copied into the leaf of ``dtype``, so no f32
    copy of the whole leaf is ever made; its values need not be a whole
    draw's (the card's generator offsets each call), and every smaller
    leaf's are the whole draw's.
    """
    dev = resolve_device("cuda" if device is None else device)

    def make(path: str, spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=dev)
        if spec.init == "constant":
            return torch.full(spec.shape, spec.constant, dtype=dtype, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(leaf_seed(seed, path))
        rows = draw_rows(spec.shape)
        if rows == 1:
            draw = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                               device=dev)
            return (draw * spec.scale).to(dtype)
        out = torch.empty(spec.shape, dtype=dtype, device=dev)
        for row in out.view((rows, -1)):
            draw = torch.randn(row.shape, generator=gen, dtype=torch.float32,
                               device=dev)
            row.copy_(draw.mul_(spec.scale))
        return out

    def build(tree: Dict[str, Any], prefix: str) -> Dict[str, Any]:
        out = {}
        for key, sub in tree.items():
            path = f"{prefix}[{key!r}]"
            out[key] = (build(sub, path) if isinstance(sub, dict)
                        else make(path, sub))
        return out

    return build(spec_tree, "")


def param_bytes(spec_tree: Dict[str, Any], itemsize: int = 4) -> int:
    total = 0
    for _path, spec in leaves_with_path(spec_tree):
        n = 1
        for s in spec.shape:
            n *= s
        total += n * itemsize
    return total
