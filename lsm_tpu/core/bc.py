"""Boundary conditions as ghost-padding transforms.

The reference expresses BCs as pointwise ghost-index stencils resolved lazily at
``phi[I]`` (``/root/reference/src/boundaryconditions.jl:19-188``,
``meshfield.jl:248-260``). Here the form is the inverse: *eagerly* materialize a
ghost-padded array ``pad_ghost(values, bcs, width)`` once per stencil evaluation,
so every downstream derivative is a dense shifted-slice over a single contiguous
array that XLA fuses.

Supported kinds (semantics matched to the reference):

- ``Periodic``            — wrap-around. Left ghost at distance ``k`` reads node
  ``n-1-k``; right ghost at distance ``k`` reads node ``k``
  (``boundaryconditions.jl:107-119``; note the shared endpoint: period is ``n-1``).
- ``Extrapolation(P)``    — degree-``P`` one-sided Lagrange extrapolation from the
  ``P+1`` boundary-adjacent nodes, weights ``w_j(k) = prod_{m!=j} (-k-m)/(j-m)``
  (``boundaryconditions.jl:90-97,134-144``). ``Neumann = Extrapolation(0)`` and
  ``LinearExtrapolation = Extrapolation(1)``.
- ``Symmetry``            — mirror about the boundary *node*: ghost at distance
  ``k`` reads the interior node at distance ``k`` (``boundaryconditions.jl:146-153``).

Corner ghosts: dimensions are padded sequentially (dim 0 first), so a corner ghost
is the composition of the per-dim stencils — a bilinear form identical to the
reference's recursive corner resolution (the per-dim ghost operators commute).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "BoundaryCondition",
    "Periodic",
    "Extrapolation",
    "Neumann",
    "LinearExtrapolation",
    "Symmetry",
    "normalize_bcs",
    "pad_ghost",
    "bcs_str",
]


class BoundaryCondition:
    """Marker base class for boundary conditions (static pytree metadata)."""

    __slots__ = ()


@dataclasses.dataclass(frozen=True)
class Periodic(BoundaryCondition):
    def __str__(self):
        return "Periodic"


@dataclasses.dataclass(frozen=True)
class Extrapolation(BoundaryCondition):
    """Degree-``degree`` one-sided polynomial extrapolation into the ghost region."""

    degree: int = 1

    def __post_init__(self):
        if self.degree < 0:
            raise ValueError("extrapolation degree must be at least 0")

    def __str__(self):
        return {0: "Neumann", 1: "Linear extrapolation"}.get(
            self.degree, f"Degree {self.degree} extrapolation"
        )


def Neumann() -> Extrapolation:
    """Homogeneous Neumann BC: constant extension (``Extrapolation(0)``)."""
    return Extrapolation(0)


def LinearExtrapolation() -> Extrapolation:
    """Linear extrapolation BC (``Extrapolation(1)``)."""
    return Extrapolation(1)


@dataclasses.dataclass(frozen=True)
class Symmetry(BoundaryCondition):
    def __str__(self):
        return "Symmetry"


BCLike = Union[BoundaryCondition, Sequence]
BCPair = Tuple[BoundaryCondition, BoundaryCondition]


def normalize_bcs(bc: Optional[BCLike], ndim: int) -> Optional[Tuple[BCPair, ...]]:
    """Normalize user BC input into an ``ndim``-tuple of ``(left, right)`` pairs.

    Mirrors ``_normalize_bc`` (``boundaryconditions.jl:166-188``): a single BC applies
    everywhere; a length-``ndim`` sequence applies per dimension; entries may be
    ``(left, right)`` pairs. One-sided periodicity is rejected.
    """
    if bc is None:
        return None
    if isinstance(bc, BoundaryCondition):
        return tuple((bc, bc) for _ in range(ndim))
    bc = tuple(bc)
    if len(bc) != ndim:
        raise ValueError(
            f"invalid number of boundary conditions: got {len(bc)}, expected {ndim}"
        )
    out = []
    for d, entry in enumerate(bc):
        if isinstance(entry, BoundaryCondition):
            pair = (entry, entry)
        else:
            entry = tuple(entry)
            if len(entry) != 2 or not all(
                isinstance(b, BoundaryCondition) for b in entry
            ):
                raise ValueError(f"invalid boundary condition for dimension {d}")
            pair = entry
        left, right = pair
        if isinstance(left, Periodic) != isinstance(right, Periodic):
            raise ValueError(
                f"periodic boundary conditions cannot be mixed with others in dimension {d}"
            )
        out.append(pair)
    return tuple(out)


def _lagrange_extrap_weights(width: int, degree: int) -> np.ndarray:
    """Weights ``W[g, j]`` of node ``j`` (0-indexed from the boundary) for the ghost
    layer at row ``g``, where rows are ordered outermost-first (distance
    ``k = width - g``). ``w_j(k) = prod_{m != j} (-k - m) / (j - m)``
    (reference ``_lagrange_extrap_weight``, ``boundaryconditions.jl:90-97``)."""
    P = degree
    W = np.empty((width, P + 1), dtype=np.float64)
    for g in range(width):
        k = width - g
        for j in range(P + 1):
            w = 1.0
            for m in range(P + 1):
                if m != j:
                    w *= (-k - m) / (j - m)
            W[g, j] = w
    return W


def _take(v: jnp.ndarray, idxs: np.ndarray, axis: int) -> jnp.ndarray:
    return jnp.take(v, jnp.asarray(idxs), axis=axis)


def _ghost_block(
    v: jnp.ndarray, bc: BoundaryCondition, axis: int, width: int, side: str
) -> jnp.ndarray:
    """Ghost block of ``width`` layers for one side of one axis, ordered so it can be
    concatenated directly (left block outermost-first; right block innermost-first)."""
    n = v.shape[axis]
    if isinstance(bc, Periodic):
        if side == "left":  # ghost -k -> node n-1-k, k = width..1
            idxs = np.arange(n - 1 - width, n - 1)
        else:  # ghost n-1+k -> node k, k = 1..width
            idxs = np.arange(1, width + 1)
        return _take(v, idxs, axis)
    if isinstance(bc, Symmetry):
        if side == "left":  # ghost -k -> node k, k = width..1
            idxs = np.arange(width, 0, -1)
        else:  # ghost n-1+k -> node n-1-k, k = 1..width
            idxs = np.arange(n - 2, n - 2 - width, -1)
        return _take(v, idxs, axis)
    if isinstance(bc, Extrapolation):
        P = bc.degree
        if P + 1 > n:
            raise ValueError(
                f"Extrapolation({P}) needs {P + 1} nodes but axis {axis} has {n}"
            )
        W = _lagrange_extrap_weights(width, P)
        if side == "left":
            idxs = np.arange(P + 1)  # boundary node 0 inward
        else:
            idxs = np.arange(n - 1, n - 2 - P, -1)  # boundary node n-1 inward
            W = W[::-1]  # right block ordered innermost-first (k = 1..width)
        base = jnp.moveaxis(_take(v, idxs, axis), axis, 0)
        # HIGHEST precision: a float32 contraction on a GPU may run in TF32
        # (about 3 decimal digits), which would make every Extrapolation ghost
        # only ~1e-3 accurate
        block = jnp.tensordot(
            jnp.asarray(W, dtype=v.dtype), base, axes=1,
            precision=jax.lax.Precision.HIGHEST,
        )
        return jnp.moveaxis(block, 0, axis)
    raise TypeError(f"unsupported boundary condition {bc!r}")


def pad_axis(
    v: jnp.ndarray, bcs_pair: BCPair, axis: int, width: int
) -> jnp.ndarray:
    """Pad one axis with ``width`` ghost layers on both sides."""
    if width == 0:
        return v
    left, right = bcs_pair
    lblock = _ghost_block(v, left, axis, width, "left")
    rblock = _ghost_block(v, right, axis, width, "right")
    return jnp.concatenate([lblock, v, rblock], axis=axis)


def pad_ghost(
    v: jnp.ndarray, bcs: Tuple[BCPair, ...], width: int, axes: Optional[Sequence[int]] = None
) -> jnp.ndarray:
    """Ghost-pad ``v`` with ``width`` layers on every side of each axis in ``axes``
    (default: all), composing corner ghosts by sequential per-dim application."""
    if bcs is None:
        raise ValueError(
            "cannot evaluate ghost nodes on a field without boundary conditions"
        )
    axes = range(v.ndim) if axes is None else axes
    for ax in axes:
        v = pad_axis(v, bcs[ax], ax, width)
    return v


def bcs_str(bcs: Optional[Tuple[BCPair, ...]]) -> str:
    """Compact human-readable BC summary (reference ``_bc_str``)."""
    if bcs is None:
        return "none"
    names = ["x", "y", "z"] if len(bcs) <= 3 else [f"d{i}" for i in range(len(bcs))]
    flat = [b for pair in bcs for b in pair]
    if all(b == flat[0] for b in flat):
        return f"{flat[0]} (all)"
    parts = []
    for name, (l, r) in zip(names, bcs):
        parts.append(f"{name}: {l}" if l == r else f"{name}: {l} <-> {r}")
    return ", ".join(parts)
