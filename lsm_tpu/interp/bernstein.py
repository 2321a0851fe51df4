"""Tensor-product Bernstein polynomials, batched.

JAX analogue of the reference's ``src/bernstein.jl``: instead of a scalar
de-Casteljau recursion per point, coefficients live in arrays with ``N`` trailing
coefficient axes and evaluation is a sequence of basis-vector contractions —
differentiable with ``jax.grad`` (replacing ForwardDiff) and batchable with
``vmap`` over points and cells.

Also provides the algebraic operations the implicit-integration quadrature needs
(reference ``ext/ImplicitIntegrationExt.jl:19-68``): convex-hull bounds, per-axis
derivative polynomials, de-Casteljau midpoint subdivision, and face restrictions.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "bernstein_basis",
    "bernstein_eval",
    "bernstein_value_grad",
    "bernstein_value_grad_hess",
    "bernstein_derivative",
    "bernstein_bounds",
    "bernstein_split",
    "bernstein_face",
]


def _binomials(n: int) -> np.ndarray:
    return np.asarray([math.comb(n, k) for k in range(n + 1)], dtype=np.float64)


def bernstein_basis(degree: int, t) -> jnp.ndarray:
    """Basis vector ``B_k(t) = C(d,k) t^k (1-t)^(d-k)``, ``k = 0..degree``.

    ``t`` may be a scalar or an array; the basis axis is appended last.
    """
    t = jnp.asarray(t)
    k = jnp.arange(degree + 1, dtype=t.dtype)
    binom = jnp.asarray(_binomials(degree), dtype=t.dtype)
    tt = t[..., None]
    # guard 0^0 at the endpoints
    pow_t = jnp.where(k == 0, 1.0, tt**k)
    pow_1mt = jnp.where(k == degree, 1.0, (1.0 - tt) ** (degree - k))
    return binom * pow_t * pow_1mt


def bernstein_eval(coeffs: jnp.ndarray, lo, hi, x) -> jnp.ndarray:
    """Evaluate the tensor-product Bernstein polynomial at point ``x``.

    ``coeffs`` has one axis per dimension (shape ``(d1+1, ..., dN+1)``); ``lo`` /
    ``hi`` are length-N box corners; ``x`` is a length-N point. Returns a scalar.
    Maps over the last N axes, so leading batch axes of ``coeffs`` broadcast.
    """
    lo = jnp.asarray(lo)
    hi = jnp.asarray(hi)
    x = jnp.asarray(x)
    ndim = lo.shape[-1] if lo.ndim else 1
    t = (x - lo) / (hi - lo)
    out = coeffs
    for d in range(ndim):
        remaining = ndim - d  # coefficient axes still uncontracted (the last ones)
        deg = out.shape[-remaining] - 1
        basis = bernstein_basis(deg, t[d]).astype(out.dtype)
        # HIGHEST: a float32 contraction may otherwise run in TF32 on a GPU —
        # fatal for the high-order interpolation/SDF oracle (see core/bc.py)
        moved = jnp.moveaxis(out, -remaining, -1)
        out = jax.lax.dot_general(
            moved, basis, (((moved.ndim - 1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )
    return out


def bernstein_value_grad(coeffs, lo, hi, x):
    """Fused value and gradient at ``x`` (reference ``value_and_gradient``)."""
    f = lambda p: bernstein_eval(coeffs, lo, hi, p)
    return f(x), jax.grad(f)(x)


def bernstein_value_grad_hess(coeffs, lo, hi, x):
    """Fused value, gradient and Hessian at ``x``."""
    f = lambda p: bernstein_eval(coeffs, lo, hi, p)
    return f(x), jax.grad(f)(x), jax.hessian(f)(x)


def _coeff_axis(coeffs: jnp.ndarray, ndim: int, axis: int) -> int:
    """Index of the coefficient axis for spatial ``axis`` (the last N axes)."""
    return coeffs.ndim - ndim + axis


def bernstein_derivative(coeffs: jnp.ndarray, ndim: int, axis: int, lo, hi) -> jnp.ndarray:
    """Coefficients of ``d/dx_axis p`` (degree reduced by one along ``axis``):
    ``d * (c_{i+1} - c_i) / (hi - lo)``."""
    ax = _coeff_axis(coeffs, ndim, axis)
    n = coeffs.shape[ax]
    d = n - 1
    upper = jax.lax.slice_in_dim(coeffs, 1, n, axis=ax)
    lower = jax.lax.slice_in_dim(coeffs, 0, n - 1, axis=ax)
    scale = d / (hi[axis] - lo[axis])
    return (upper - lower) * scale


def bernstein_bounds(coeffs: jnp.ndarray, ndim: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Convex-hull bounds ``(min, max)`` over the last ``ndim`` coefficient axes."""
    axes = tuple(range(coeffs.ndim - ndim, coeffs.ndim))
    return jnp.min(coeffs, axis=axes), jnp.max(coeffs, axis=axes)


def _decasteljau_tables(n: int, t: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """Matrices L, R with ``left = L @ c`` and ``right = R @ c`` the Bernstein
    coefficients of the two halves of a degree-(n-1) curve split at ``t``."""
    L = np.zeros((n, n))
    R = np.zeros((n, n))
    # de Casteljau triangle: row k of L is the first entry after k steps,
    # row k of R is the last entry after n-1-k steps
    tri = np.eye(n)
    L[0] = tri[0]
    R[n - 1] = tri[n - 1]
    for k in range(1, n):
        tri = (1 - t) * tri[:-1] + t * tri[1:]
        L[k] = tri[0]
        R[n - 1 - k] = tri[-1]
    return L, R


def bernstein_split(coeffs: jnp.ndarray, ndim: int, axis: int, t: float = 0.5):
    """Split along ``axis`` at parameter ``t`` (de Casteljau); returns
    ``(left_coeffs, right_coeffs)``."""
    ax = _coeff_axis(coeffs, ndim, axis)
    n = coeffs.shape[ax]
    L, R = _decasteljau_tables(n, t)
    Lj = jnp.asarray(L, dtype=coeffs.dtype)
    Rj = jnp.asarray(R, dtype=coeffs.dtype)
    moved = jnp.moveaxis(coeffs, ax, -1)
    hi = jax.lax.Precision.HIGHEST
    left = jnp.moveaxis(jnp.matmul(moved, Lj.T, precision=hi), -1, ax)
    right = jnp.moveaxis(jnp.matmul(moved, Rj.T, precision=hi), -1, ax)
    return left, right


def bernstein_face(coeffs: jnp.ndarray, ndim: int, axis: int, side: int) -> jnp.ndarray:
    """Restrict to the face ``x_axis = lo`` (``side=0``) or ``x_axis = hi``
    (``side=1``): take the first/last coefficient slice along that axis."""
    ax = _coeff_axis(coeffs, ndim, axis)
    idx = 0 if side == 0 else coeffs.shape[ax] - 1
    return jax.lax.index_in_dim(coeffs, idx, axis=ax, keepdims=False)
