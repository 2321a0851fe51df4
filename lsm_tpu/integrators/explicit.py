"""Explicit TVD Runge-Kutta time integrators.

JAX analogue of the reference's ``src/timestepping.jl:1-202``: each
integrator is a tiny frozen (static, hashable) dataclass with a pure
``advance(terms, phi, t, dt) -> (phi_new, terms_new)`` stage function, designed to
be composed under ``jax.jit`` / ``lax.scan`` / ``lax.while_loop`` by the drivers in
:mod:`lsm_tpu.integrators.loop` and :mod:`lsm_tpu.equation`.

Terms are re-``update``-d at every stage with the stage state and time, matching the
reference's per-stage ``update_term!`` calls (``timestepping.jl:149,158,174,185,196``).
Every integrator carries a ``cfl`` safety factor (default 0.5).
"""

from __future__ import annotations

import dataclasses

from ..core.field import MeshField
from ..terms.terms import total_rhs, update_terms

__all__ = ["TimeIntegrator", "ForwardEuler", "RK2", "RK3"]


def _stage(terms, phi, t, aux, coeffs):
    """One RK stage ``alpha*aux + beta*phi - gamma*L(phi, t)`` as values.

    ``aux`` is a values array or ``None``; ``coeffs = (alpha, beta, gamma)``
    with traced scalars welcome (an adaptive ``dt`` does not recompile).
    """
    alpha, beta, gamma = coeffs
    out = beta * phi.values - gamma * total_rhs(terms, phi, t)
    if aux is not None:
        out = alpha * aux + out
    return out


@dataclasses.dataclass(frozen=True)
class TimeIntegrator:
    cfl: float = 0.5

    def advance(self, terms, phi: MeshField, t, dt):
        raise NotImplementedError

    def describe(self) -> str:
        raise NotImplementedError

    def __repr__(self):
        return f"{self.describe()}\n  `- cfl: {self.cfl}"


@dataclasses.dataclass(frozen=True, repr=False)
class ForwardEuler(TimeIntegrator):
    """First-order explicit forward Euler (``timestepping.jl:126-137``)."""

    def advance(self, terms, phi, t, dt):
        terms = update_terms(terms, phi, t)
        phi_new = phi.with_values(_stage(terms, phi, t, None, (0.0, 1.0, dt)))
        return phi_new, terms

    def describe(self):
        return "ForwardEuler (1st order explicit)"


@dataclasses.dataclass(frozen=True, repr=False)
class RK2(TimeIntegrator):
    """Second-order TVD Runge-Kutta (Heun predictor-corrector,
    ``timestepping.jl:141-164``)."""

    def advance(self, terms, phi, t, dt):
        # Heun in convex-combination (SSP) form, one axpy per stage:
        # pred = phi - dt L(phi);
        # phi_new = 1/2 phi + 1/2 (pred - dt L(pred)).
        terms = update_terms(terms, phi, t)
        pred = phi.with_values(_stage(terms, phi, t, None, (0.0, 1.0, dt)))
        terms = update_terms(terms, pred, t + dt)
        phi_new = phi.with_values(
            _stage(terms, pred, t + dt, phi.values, (0.5, 0.5, 0.5 * dt))
        )
        return phi_new, terms

    def describe(self):
        return "RK2 (2nd order TVD Runge-Kutta, Heun's method)"


@dataclasses.dataclass(frozen=True, repr=False)
class RK3(TimeIntegrator):
    """Third-order Shu-Osher TVD Runge-Kutta (``timestepping.jl:168-202``)."""

    def advance(self, terms, phi, t, dt):
        # Shu-Osher stages in axpy form:
        #   u1 = phi - dt L(phi)
        #   u2 = 3/4 phi + 1/4 u1 - 1/4 dt L(u1)
        #   out = 1/3 phi + 2/3 u2 - 2/3 dt L(u2)
        terms = update_terms(terms, phi, t)
        u1 = phi.with_values(_stage(terms, phi, t, None, (0.0, 1.0, dt)))
        terms = update_terms(terms, u1, t + dt)
        u2 = phi.with_values(
            _stage(terms, u1, t + dt, phi.values, (0.75, 0.25, 0.25 * dt))
        )
        terms = update_terms(terms, u2, t + 0.5 * dt)
        third = 1.0 / 3.0
        new_vals = _stage(
            terms, u2, t + 0.5 * dt, phi.values, (third, 2.0 * third, 2.0 * third * dt)
        )
        return phi.with_values(new_vals), terms

    def describe(self):
        return "RK3 (3rd order TVD Runge-Kutta)"
