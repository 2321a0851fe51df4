"""Continuous fields: piecewise tensor-product Bernstein interpolation.

JAX analogue of the reference's ``src/interpolation.jl``. The reference
fills one cell's Bernstein coefficients lazily per task with a memo; here the
coefficients of EVERY cell are computed in one shot as a batched Kronecker
application — per dimension, a stack of ``nv`` shifted slices contracted with the
shared 1-D interpolation matrix (one contraction) — and evaluation is gather +
vmapped polynomial contraction over arbitrary batches of query points.
Differentiation uses ``jax.grad``/``jax.hessian`` of the patch evaluation
(replacing ForwardDiff), fused via ``value_and_gradient`` etc.

The 1-D interpolation matrix mapping ``stencil_order+1`` equispaced nodal values
to the ``order+1`` Bernstein coefficients of the central cell is the pinv of the
Bernstein Vandermonde (reference ``_interpolation_matrix``,
``interpolation.jl:57-69``; even order => least-squares on an order+1 stencil).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.bc import Extrapolation
from ..core.field import MeshField
from .bernstein import (
    bernstein_basis,
    bernstein_eval,
    bernstein_value_grad,
    bernstein_value_grad_hess,
)

__all__ = ["InterpolatedField", "interpolation_matrix"]


def _stencil_order(order: int) -> int:
    return order if order % 2 == 1 else order + 1


def interpolation_matrix(order: int) -> np.ndarray:
    """(order+1) x (stencil_order+1) matrix: nodal values -> Bernstein coeffs on
    the central cell ``[(s-1)/(2s), (s+1)/(2s)]`` of the unit stencil."""
    s = _stencil_order(order)
    nc, nv = order + 1, s + 1
    nodes = np.arange(nv) / s
    a, b = (s - 1) / (2 * s), (s + 1) / (2 * s)
    t = (nodes - a) / (b - a)
    V = np.empty((nv, nc))
    for j in range(nc):
        V[:, j] = math.comb(order, j) * t**j * (1 - t) ** (order - j)
    return np.linalg.pinv(V)


def _all_cell_coeffs(padded: jnp.ndarray, mat: jnp.ndarray, cells_shape, pad: int, off: int):
    """Bernstein coefficients of every cell: shape ``(*cells_shape, nc, ..., nc)``."""
    nc, nv = mat.shape
    A = padded
    ndim = len(cells_shape)
    for d in range(ndim):
        start = pad + off
        slabs = []
        for k in range(nv):
            sl = [slice(None)] * A.ndim
            sl[d] = slice(start + k, start + k + cells_shape[d])
            slabs.append(A[tuple(sl)])
        S = jnp.stack(slabs, axis=0)  # (nv, ...)
        # HIGHEST: float32 contractions may otherwise run in TF32 on a GPU
        A = jnp.tensordot(mat, S, axes=[[1], [0]],
                          precision=jax.lax.Precision.HIGHEST)  # (nc, ...)
        A = jnp.moveaxis(A, 0, -1)  # spatial axes stay in place, coeff axes trail
    return A


@jax.tree_util.register_pytree_node_class
class InterpolatedField:
    """Continuous field: discrete field + degree-``order`` Bernstein patch per cell.

    Calling conventions (reference ``interpolation.jl:287-321``): ``cf(x)`` with
    ``x`` a length-N point or an ``(..., N)`` batch; ``gradient`` / ``hessian`` /
    ``value_and_gradient`` / ``value_gradient_hessian`` differentiate the same
    local patch. ``cell_extrema`` / ``proven_empty`` exploit the Bernstein
    convex-hull property.
    """

    #: above this many coefficient floats, switch to the lazy per-batch path
    LAZY_THRESHOLD = 1 << 26

    def __init__(self, field: MeshField, order: int = 3,
                 lazy: Optional[bool] = None, _state=None):
        if _state is not None:
            (self.field, self.order, self.coeffs, self._padded,
             self._mat, self._pad, self._off) = _state
            return
        if not field.has_bcs():
            field = field.with_bcs(Extrapolation(order))
        self.field = field
        self.order = int(order)
        mat = jnp.asarray(interpolation_matrix(self.order), dtype=field.dtype)
        nv = mat.shape[1]
        pad = (nv - 2 + 1) // 2
        off = -((nv - 2) // 2)
        self._mat, self._pad, self._off = mat, pad, off
        ncoef = math.prod(field.grid.cells_shape) * (self.order + 1) ** field.ndim
        if lazy is None:
            lazy = ncoef > self.LAZY_THRESHOLD
        padded = field.pad(pad)
        if lazy:
            # the reference is lazy-per-cell with a memo (interpolation.jl:87-112);
            # here "lazy" = batched on-demand coefficients from the padded nodal
            # array — O(grid) memory instead of O(grid * (order+1)^N)
            self.coeffs = None
            self._padded = padded
        else:
            self.coeffs = _all_cell_coeffs(
                padded, mat, field.grid.cells_shape, pad, off
            )
            self._padded = None

    @property
    def is_lazy(self) -> bool:
        return self.coeffs is None

    # -- pytree --------------------------------------------------------------------

    def tree_flatten(self):
        return (self.field, self.coeffs, self._padded, self._mat), (
            self.order, self._pad, self._off,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.field, obj.coeffs, obj._padded, obj._mat = children
        obj.order, obj._pad, obj._off = aux
        return obj

    # -- geometry helpers ----------------------------------------------------------

    @property
    def grid(self):
        return self.field.grid

    @property
    def ndim(self):
        return self.field.ndim

    def _cell_box(self, cell_idx: jnp.ndarray):
        grid = self.grid
        lo = jnp.asarray(grid.lo, dtype=self.field.dtype)
        h = jnp.asarray(grid.spacing, dtype=self.field.dtype)
        cl = lo + cell_idx * h
        return cl, cl + h

    def _gather_coeffs(self, cell_idx: jnp.ndarray):
        """Coefficient blocks for (batched) cell multi-indices ``(..., N)``."""
        ndim = self.ndim
        cells_shape = self.grid.cells_shape
        nc = self.order + 1
        if self.is_lazy:
            return self._coeffs_on_demand(cell_idx)
        flat = self.coeffs.reshape((-1,) + (nc,) * ndim)
        strides = np.cumprod((cells_shape[1:] + (1,))[::-1])[::-1].copy()
        lin = jnp.sum(cell_idx * jnp.asarray(strides, dtype=cell_idx.dtype), axis=-1)
        return flat[lin]

    def _coeffs_on_demand(self, cell_idx: jnp.ndarray):
        """Lazy path: gather each cell's ``(nv,)*N`` nodal stencil from the
        padded array and contract with the shared 1-D matrix per dimension
        (batched Kronecker application, same math as :func:`_all_cell_coeffs`)."""
        ndim = self.ndim
        mat = self._mat
        nc, nv = mat.shape
        base = cell_idx + (self._pad + self._off)  # stencil start in padded coords
        ar = jnp.arange(nv)
        # advanced-indexing gather of (..., nv, ..., nv) neighborhoods
        idxs = []
        for d in range(ndim):
            ix = base[..., d]
            ix = ix.reshape(ix.shape + (1,) * ndim)
            shape_d = [1] * ndim
            shape_d[d] = nv
            idxs.append(ix + ar.reshape(shape_d))
        A = self._padded[tuple(idxs)]  # (..., nv, nv[, nv])
        for _ in range(ndim):
            # consume the first trailing stencil axis, append its coeff axis at
            # the end; after ndim rounds the trailing axes are (nc,)*ndim in
            # dimension order (matches the eager layout)
            A = jnp.tensordot(A, mat, axes=[[A.ndim - ndim], [1]],
                              precision=jax.lax.Precision.HIGHEST)
        return A

    # -- evaluation ----------------------------------------------------------------

    def _point_eval(self, fn, x: jnp.ndarray):
        x = jnp.asarray(x, dtype=self.field.dtype)
        single = x.ndim == 1
        pts = jnp.atleast_2d(x)
        cell = self.grid.locate_cell(pts)
        blocks = self._gather_coeffs(cell)
        lo, hi = self._cell_box(cell.astype(pts.dtype))
        out = jax.vmap(fn)(blocks, lo, hi, pts)
        if single:
            out = jax.tree_util.tree_map(lambda o: o[0], out)
        return out

    def __call__(self, x) -> jnp.ndarray:
        return self._point_eval(bernstein_eval, x)

    def gradient(self, x) -> jnp.ndarray:
        return self._point_eval(
            lambda c, lo, hi, p: jax.grad(lambda q: bernstein_eval(c, lo, hi, q))(p), x
        )

    def hessian(self, x) -> jnp.ndarray:
        return self._point_eval(
            lambda c, lo, hi, p: jax.hessian(lambda q: bernstein_eval(c, lo, hi, q))(p), x
        )

    def value_and_gradient(self, x):
        return self._point_eval(bernstein_value_grad, x)

    def value_gradient_hessian(self, x):
        return self._point_eval(bernstein_value_grad_hess, x)

    # -- cell queries (interpolation.jl:227-282) -----------------------------------

    def make_interpolant(self, cell_index: Sequence[int]):
        """``(coeffs, lo, hi)`` triple of the Bernstein patch on one cell."""
        idx = jnp.asarray(cell_index)
        blocks = self._gather_coeffs(idx[None])[0]
        lo, hi = self._cell_box(idx.astype(self.field.dtype))
        return blocks, lo, hi

    def local_interpolant(self, x):
        cell = self.grid.locate_cell(jnp.asarray(x, dtype=self.field.dtype))
        return self.make_interpolant(cell)

    def cell_extrema(self, cell_index: Optional[Sequence[int]] = None,
                     chunk: int = 1 << 17):
        """Convex-hull (min, max) bounds — one cell, or every cell at once
        (lazy fields compute all-cell bounds in ``chunk``-cell batches)."""
        ndim = self.ndim
        axes = tuple(range(-ndim, 0))
        if cell_index is None:
            if not self.is_lazy:
                return jnp.min(self.coeffs, axis=axes), jnp.max(self.coeffs, axis=axes)
            cells_shape = self.grid.cells_shape
            ncells = math.prod(cells_shape)
            strides = np.cumprod((cells_shape[1:] + (1,))[::-1])[::-1].copy()
            nchunks = -(-ncells // chunk)
            pad_n = nchunks * chunk

            def one(start):
                lin = start + jnp.arange(chunk)
                lin = jnp.minimum(lin, ncells - 1)  # clamp the ragged tail
                multi = jnp.stack(
                    [(lin // int(s)) % int(c) for s, c in zip(strides, cells_shape)],
                    axis=-1,
                )
                blocks = self._gather_coeffs(multi)
                return jnp.min(blocks, axis=axes), jnp.max(blocks, axis=axes)

            mins, maxs = jax.lax.map(one, jnp.arange(nchunks) * chunk)
            mins = mins.reshape(pad_n)[:ncells].reshape(cells_shape)
            maxs = maxs.reshape(pad_n)[:ncells].reshape(cells_shape)
            return mins, maxs
        blocks = self._gather_coeffs(jnp.asarray(cell_index)[None])[0]
        return jnp.min(blocks), jnp.max(blocks)

    def proven_empty(self, cell_index: Optional[Sequence[int]] = None, surface: bool = False):
        """True where a cell provably contains no interface (``surface=True``:
        ``min*max > 0``) or no interior (``min > 0``)."""
        m, M = self.cell_extrema(cell_index)
        return (m * M > 0) if surface else (m > 0)

    def __repr__(self):
        return f"InterpolatedField (order {self.order}) wrapping {self.field!r}"
