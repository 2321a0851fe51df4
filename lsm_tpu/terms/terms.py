"""Hamilton-Jacobi terms of the level-set equation ``phi_t + sum_n term_n = 0``.

JAX analogue of the reference's ``src/levelsetterms.jl``: each term is an
immutable pytree with three methods —

- ``rhs(phi, t)``    -> whole-grid contribution array (the reference's per-node
  ``_compute_term`` vectorized over the grid),
- ``cfl_dt(phi, t)`` -> the largest stable time step (global min of the reference's
  per-node ``_compute_cfl``),
- ``update(phi, t)`` -> a refreshed term (the functional form of the reference's
  ``update_term!`` mutation hook, called before the CFL estimate and at every
  Runge-Kutta stage).

Coefficient fields (velocity, speed, curvature weight) may be:

- a :class:`~lsm_tpu.core.field.MeshField` (vector-valued with a leading component
  axis for advection velocities),
- a raw array (same shape as the grid; for velocities ``(ndim, *grid.shape)``),
- a callable ``f(x, t)`` receiving the tuple of broadcastable node-coordinate
  arrays plus time, returning an array or a sequence of per-component arrays
  (the reference's ``(x, t) -> SVector`` form, ``levelsetterms.jl:42-43``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp

from ..core.field import MeshField
from ..ops import stencils as st

__all__ = [
    "AdvectionTerm",
    "NormalMotionTerm",
    "CurvatureTerm",
    "EikonalReinitializationTerm",
    "compute_cfl",
    "total_rhs",
    "update_terms",
]

Coefficient = Union[MeshField, jnp.ndarray, Callable]


def _eval_scalar_field(f: Coefficient, phi: MeshField, t) -> jnp.ndarray:
    """Evaluate a scalar coefficient field on the grid nodes."""
    if isinstance(f, MeshField):
        return f.values
    if callable(f):
        xs = phi.grid.coords(dtype=phi.dtype)
        return jnp.broadcast_to(jnp.asarray(f(xs, t), dtype=phi.dtype), phi.shape)
    return jnp.broadcast_to(jnp.asarray(f, dtype=phi.dtype), phi.shape)


def _eval_vector_field(f: Coefficient, phi: MeshField, t) -> Tuple[jnp.ndarray, ...]:
    """Evaluate a velocity field as a tuple of per-component node arrays."""
    ndim = phi.ndim
    if isinstance(f, MeshField):
        if not f.is_vector:
            raise ValueError("advection velocity MeshField must be vector-valued")
        return tuple(f.values[d] for d in range(ndim))
    if callable(f):
        xs = phi.grid.coords(dtype=phi.dtype)
        comps = f(xs, t)
        if isinstance(comps, (tuple, list)):
            return tuple(
                jnp.broadcast_to(jnp.asarray(c, dtype=phi.dtype), phi.shape)
                for c in comps
            )
        comps = jnp.asarray(comps)
        return tuple(comps[d] for d in range(ndim))
    f = jnp.asarray(f)
    return tuple(f[d] for d in range(ndim))


def _masked_max(x: jnp.ndarray, mask) -> jnp.ndarray:
    """Max of a nonnegative quantity over the active nodes (all nodes when dense).

    CFL bounds reduce over *active* nodes only (reference ``levelsetterms.jl:31-38``
    loops ``active_nodeindices``); off-band coefficients may be stale/garbage.
    """
    if mask is None:
        return jnp.max(x)
    return jnp.max(jnp.where(mask, x, 0.0))


def _flatten_coeff(coeff):
    """Split a coefficient into (dynamic children, static aux).

    Callables and plain Python scalars are static metadata; everything else
    (MeshField, arrays, tuples of arrays) is a dynamic pytree child.
    """
    if callable(coeff) and not isinstance(coeff, MeshField):
        return (), ("static", coeff)
    if isinstance(coeff, (float, int)) and not isinstance(coeff, bool):
        return (), ("static", coeff)
    return (coeff,), ("dynamic", None)


def _unflatten_coeff(children, aux):
    kind, value = aux
    return children[0] if kind == "dynamic" else value


class _Term:
    """Shared term protocol (reference ``LevelSetTerm``, ``levelsetterms.jl:1-43``)."""

    def update(self, phi: MeshField, t):
        return self

    def rhs(self, phi: MeshField, t) -> jnp.ndarray:
        raise NotImplementedError

    def cfl_dt(self, phi: MeshField, t) -> jnp.ndarray:
        raise NotImplementedError

    @property
    def pad_width(self) -> int:
        raise NotImplementedError


@jax.tree_util.register_pytree_node_class
class AdvectionTerm(_Term):
    """``u . grad(phi)`` with sign-of-velocity upwinding per dimension
    (``levelsetterms.jl:45-96``). ``scheme`` is ``"weno5"`` (default) or ``"upwind"``.

    ``update_func(velocity, phi, t) -> new_velocity`` refreshes a state-dependent
    velocity before the CFL estimate and at each RK stage (functional counterpart of
    the reference's in-place ``update_func`` hook).
    """

    def __init__(self, velocity: Coefficient, scheme: str = "weno5", update_func=None):
        if scheme not in ("weno5", "upwind"):
            raise ValueError(f"unknown scheme {scheme!r}; use 'weno5' or 'upwind'")
        self.velocity = velocity
        self.scheme = scheme
        self.update_func = update_func

    def tree_flatten(self):
        children, aux = _flatten_coeff(self.velocity)
        return children, (aux, self.scheme, self.update_func)

    @classmethod
    def tree_unflatten(cls, aux_data, children):
        vel_aux, scheme, update_func = aux_data
        obj = object.__new__(cls)
        obj.velocity = _unflatten_coeff(children, vel_aux)
        obj.scheme = scheme
        obj.update_func = update_func
        return obj

    @property
    def pad_width(self) -> int:
        return st.PAD_WENO5 if self.scheme == "weno5" else st.PAD_D0

    def update(self, phi, t):
        if self.update_func is None:
            return self
        new_vel = self.update_func(self.velocity, phi, t)
        return AdvectionTerm(new_vel, self.scheme, self.update_func)

    def rhs(self, phi, t):
        g = self.pad_width
        p = phi.pad(g)
        u = _eval_vector_field(self.velocity, phi, t)
        spacing = phi.spacing
        if self.scheme == "weno5":
            # hand-adjoint VJP: f32 autodiff of WENO5 is wrong at tie cells
            return st.weno5_advection(p, u, tuple(spacing), tuple(phi.shape))
        out = 0.0
        for ax, h in enumerate(spacing):
            dminus = st.dm(p, ax, h, g, phi.shape)
            dplus = st.dp(p, ax, h, g, phi.shape)
            out = out + u[ax] * jnp.where(u[ax] > 0, dminus, dplus)
        return out

    def cfl_dt(self, phi, t):
        # Unsplit multidimensional bound: dt * sum_d |u_d| / h_d <= 1 (O-F eq. 3.10).
        u = _eval_vector_field(self.velocity, phi, t)
        s = 0.0
        for ax, h in enumerate(phi.spacing):
            s = s + jnp.abs(u[ax]) / h
        return 1.0 / _masked_max(s, phi.active_mask)


@jax.tree_util.register_pytree_node_class
class NormalMotionTerm(_Term):
    """``v |grad(phi)|`` via the Godunov Hamiltonian with second-order ENO one-sided
    derivatives (``levelsetterms.jl:130-187``, O-F eq. 6.28)."""

    def __init__(self, speed: Coefficient, update_func=None):
        self.speed = speed
        self.update_func = update_func

    def tree_flatten(self):
        children, aux = _flatten_coeff(self.speed)
        return children, (aux, self.update_func)

    @classmethod
    def tree_unflatten(cls, aux_data, children):
        speed_aux, update_func = aux_data
        obj = object.__new__(cls)
        obj.speed = _unflatten_coeff(children, speed_aux)
        obj.update_func = update_func
        return obj

    @property
    def pad_width(self) -> int:
        return st.PAD_ENO2

    def update(self, phi, t):
        if self.update_func is None:
            return self
        return NormalMotionTerm(self.update_func(self.speed, phi, t), self.update_func)

    def rhs(self, phi, t):
        g = self.pad_width
        p = phi.pad(g)
        v = _eval_scalar_field(self.speed, phi, t)
        grad_p, grad_m = st.godunov_norms(p, phi.spacing, g, phi.shape)
        return jnp.maximum(v, 0.0) * grad_p + jnp.minimum(v, 0.0) * grad_m

    def cfl_dt(self, phi, t):
        v = _eval_scalar_field(self.speed, phi, t)
        inv_h_sum = sum(1.0 / h for h in phi.spacing)
        return 1.0 / (_masked_max(jnp.abs(v), phi.active_mask) * inv_h_sum)


@jax.tree_util.register_pytree_node_class
class CurvatureTerm(_Term):
    """``b kappa |grad(phi)|`` — parabolic curvature motion (``levelsetterms.jl:99-127``).
    Well-posed for ``b <= 0``."""

    def __init__(self, b: Coefficient):
        self.b = b

    def tree_flatten(self):
        children, aux = _flatten_coeff(self.b)
        return children, (aux,)

    @classmethod
    def tree_unflatten(cls, aux_data, children):
        obj = object.__new__(cls)
        obj.b = _unflatten_coeff(children, aux_data[0])
        return obj

    @property
    def pad_width(self) -> int:
        return st.PAD_ENO2  # curvature needs corner ghosts; 2 is safe everywhere

    def rhs(self, phi, t):
        from ..geometry.queries import curvature_from_padded, grad_norm_from_padded

        g = self.pad_width
        p = phi.pad(g)
        b = _eval_scalar_field(self.b, phi, t)
        kappa = curvature_from_padded(p, phi.spacing, g, phi.shape)
        return b * kappa * grad_norm_from_padded(p, phi.spacing, g, phi.shape)

    def cfl_dt(self, phi, t):
        b = _eval_scalar_field(self.b, phi, t)
        hmin = phi.grid.min_spacing
        return hmin * hmin / (2.0 * _masked_max(jnp.abs(b), phi.active_mask))


@jax.tree_util.register_pytree_node_class
class EikonalReinitializationTerm(_Term):
    """``sign(phi) (|grad(phi)| - 1)`` — PDE reinitialization toward a signed
    distance function (``levelsetterms.jl:190-265``).

    With ``s0`` given (a MeshField), the smoothed sign of the *initial* level set is
    frozen (O-F eq. 7.5): build it via :meth:`from_initial`. With ``s0=None`` the
    sign is recomputed from the current ``phi`` with gradient-aware smoothing
    (O-F eq. 7.6).
    """

    def __init__(self, s0: Optional[MeshField] = None):
        self.s0 = s0

    @staticmethod
    def from_initial(phi0: MeshField) -> "EikonalReinitializationTerm":
        """Freeze the smoothed sign ``phi0 / sqrt(phi0^2 + dx^2)`` of the initial
        level set (``levelsetterms.jl:217-221``)."""
        dx = phi0.grid.min_spacing
        s0 = phi0.map(lambda v: v / jnp.sqrt(v * v + dx * dx))
        return EikonalReinitializationTerm(s0)

    def tree_flatten(self):
        if self.s0 is None:
            return (), (False,)
        return (self.s0,), (True,)

    @classmethod
    def tree_unflatten(cls, aux_data, children):
        obj = object.__new__(cls)
        obj.s0 = children[0] if aux_data[0] else None
        return obj

    @property
    def pad_width(self) -> int:
        return st.PAD_ENO2

    def rhs(self, phi, t):
        g = self.pad_width
        p = phi.pad(g)
        grad_p, grad_m = st.godunov_norms(p, phi.spacing, g, phi.shape)
        if self.s0 is None:
            sgn = jnp.sign(phi.values)
            norm = jnp.where(sgn > 0, grad_p, grad_m)
            dx = phi.grid.min_spacing
            denom = jnp.sqrt(phi.values**2 + norm**2 * dx * dx)
            s = jnp.where(denom == 0, 0.0, phi.values / jnp.where(denom == 0, 1.0, denom))
        else:
            s = self.s0.values
            norm = jnp.where(jnp.sign(s) > 0, grad_p, grad_m)
        return s * (norm - 1.0)

    def cfl_dt(self, phi, t):
        return jnp.asarray(phi.grid.min_spacing, dtype=phi.dtype)


# -- term-collection helpers (levelsetterms.jl:14-38) ------------------------------


def update_terms(terms: Sequence[_Term], phi: MeshField, t):
    """Refresh all state-dependent terms (reference ``update_term!`` loop)."""
    return tuple(term.update(phi, t) for term in terms)


def total_rhs(terms: Sequence[_Term], phi: MeshField, t) -> jnp.ndarray:
    """Sum of the contributions of all terms, ``L(phi, t)``."""
    out = 0.0
    for term in terms:
        out = out + term.rhs(phi, t)
    return out


def compute_cfl(terms: Sequence[_Term], phi: MeshField, t) -> jnp.ndarray:
    """Largest stable time step over all terms (min of per-term bounds).

    Returns a traced scalar; the host-side integrate loop validates positivity
    (the reference throws on ``dt <= 0``, ``levelsetterms.jl:26``).
    """
    dts = [term.cfl_dt(phi, t) for term in terms]
    out = dts[0]
    for dt in dts[1:]:
        out = jnp.minimum(out, dt)
    return out
