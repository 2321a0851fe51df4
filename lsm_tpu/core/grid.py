"""Uniform Cartesian grid geometry.

JAX analogue of the reference's ``CartesianGrid`` (see
``/root/reference/src/meshes.jl:1-110``): a static (non-traced) description of a
tensor-product node lattice ``[lo, hi]`` with ``shape[d]`` nodes per dimension and
spacing ``h[d] = (hi[d] - lo[d]) / (shape[d] - 1)``. Node ``i`` (0-based) along
dimension ``d`` sits at ``lo[d] + i * h[d]``; cells are the node-bounded hypercubes,
``shape[d] - 1`` per dimension.

The grid is deliberately a frozen dataclass of Python floats/ints so it can live in
the *static* part of JAX pytrees: every jitted function specializes on the grid, and
all shapes derived from it are static under tracing.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import jax.numpy as jnp
import numpy as np

__all__ = ["Grid"]


@dataclasses.dataclass(frozen=True)
class Grid:
    """Uniform Cartesian grid with nodes at ``lo + i*h``, ``i = 0 .. shape[d]-1``."""

    lo: Tuple[float, ...]
    hi: Tuple[float, ...]
    shape: Tuple[int, ...]

    def __init__(self, lo: Sequence[float], hi: Sequence[float], shape: Sequence[int]):
        lo = tuple(float(v) for v in lo)
        hi = tuple(float(v) for v in hi)
        shape = tuple(int(v) for v in shape)
        if not (len(lo) == len(hi) == len(shape)):
            raise ValueError("lo, hi and shape must have the same length")
        if any(n < 2 for n in shape):
            raise ValueError("grids need at least 2 nodes per dimension")
        if any(h <= l for l, h in zip(lo, hi)):
            raise ValueError("hi must be strictly greater than lo in every dimension")
        object.__setattr__(self, "lo", lo)
        object.__setattr__(self, "hi", hi)
        object.__setattr__(self, "shape", shape)

    # -- construction -------------------------------------------------------------

    @staticmethod
    def from_meshsize(lo: Sequence[float], hi: Sequence[float], meshsize) -> "Grid":
        """Grid spanning ``[lo, hi]`` with spacing at most ``meshsize`` per dimension.

        The domain is honored exactly and the cell count is rounded *up*, so the
        realized spacing is never coarser than ``meshsize`` (reference semantics:
        ``meshes.jl:69-83``).
        """
        lo = tuple(float(v) for v in lo)
        hi = tuple(float(v) for v in hi)
        ndim = len(lo)
        if np.isscalar(meshsize):
            hs = (float(meshsize),) * ndim
        else:
            hs = tuple(float(v) for v in meshsize)
        if len(hs) != ndim:
            raise ValueError("meshsize must be a scalar or have one entry per dimension")
        if any(h <= 0 for h in hs):
            raise ValueError("meshsize must be positive in every dimension")
        shape = tuple(
            int(math.ceil((b - a) / h - 1e-12)) + 1 for a, b, h in zip(lo, hi, hs)
        )
        return Grid(lo, hi, shape)

    # -- geometry -----------------------------------------------------------------

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def spacing(self) -> Tuple[float, ...]:
        """Node spacing per dimension (reference ``meshsize``, ``meshes.jl:109-110``)."""
        return tuple(
            (b - a) / (n - 1) for a, b, n in zip(self.lo, self.hi, self.shape)
        )

    @property
    def min_spacing(self) -> float:
        return min(self.spacing)

    @property
    def cell_volume(self) -> float:
        return float(np.prod(self.spacing))

    @property
    def num_nodes(self) -> int:
        return int(np.prod(self.shape))

    @property
    def cells_shape(self) -> Tuple[int, ...]:
        return tuple(n - 1 for n in self.shape)

    def axis_coords(self, dim: int, dtype=jnp.float64) -> jnp.ndarray:
        """1-D array of node coordinates along dimension ``dim``."""
        return jnp.linspace(self.lo[dim], self.hi[dim], self.shape[dim], dtype=dtype)

    def coords(self, dtype=jnp.float64):
        """Tuple of N broadcastable coordinate arrays (sparse meshgrid, ij-indexing)."""
        axes = [self.axis_coords(d, dtype=dtype) for d in range(self.ndim)]
        return tuple(jnp.meshgrid(*axes, indexing="ij", sparse=True))

    def dense_coords(self, dtype=jnp.float64):
        """Tuple of N dense coordinate arrays of shape ``self.shape``."""
        axes = [self.axis_coords(d, dtype=dtype) for d in range(self.ndim)]
        return tuple(jnp.meshgrid(*axes, indexing="ij"))

    def node(self, index: Sequence[int]) -> Tuple[float, ...]:
        """Coordinates of the node at (0-based) multi-index ``index``.

        Indices outside the grid are accepted (ghost-node coordinates), matching the
        reference's unchecked ``_getnode`` (``meshes.jl:114-117``).
        """
        h = self.spacing
        return tuple(a + i * hh for a, i, hh in zip(self.lo, index, h))

    def cell_center(self, index: Sequence[int]) -> Tuple[float, ...]:
        h = self.spacing
        return tuple(a + (i + 0.5) * hh for a, i, hh in zip(self.lo, index, h))

    def locate_cell(self, x: jnp.ndarray) -> jnp.ndarray:
        """Cell multi-index containing point(s) ``x`` (shape (..., N)), clamped to the
        grid like the reference's ``compute_index`` (``meshes.jl:155-167``)."""
        lo = jnp.asarray(self.lo, dtype=x.dtype)
        h = jnp.asarray(self.spacing, dtype=x.dtype)
        idx = jnp.floor((x - lo) / h).astype(jnp.int32)
        hi = jnp.asarray([n - 2 for n in self.shape], dtype=jnp.int32)
        return jnp.clip(idx, 0, hi)

    def __repr__(self) -> str:  # pretty tree mirroring meshes.jl:239-250
        dom = " x ".join(f"[{a:g}, {b:g}]" for a, b in zip(self.lo, self.hi))
        nodes = " x ".join(str(n) for n in self.shape)
        h = ", ".join(f"{v:.4g}" for v in self.spacing)
        return (
            f"Grid in R^{self.ndim}\n"
            f"  |- domain:  {dom}\n"
            f"  |- nodes:   {nodes}\n"
            f"  `- spacing: h = ({h})"
        )
