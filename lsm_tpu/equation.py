"""User-facing evolution driver.

JAX analogue of the reference's ``LevelSetEquation``
(``/root/reference/src/levelsetequation.jl``): holds the terms, integrator, current
state and time, and exposes ``integrate(tf)``.

Two execution modes:

- With hooks (``prehook`` / ``posthook``, run once per *accepted* step, allowed to
  mutate the equation — the reference's observability/reinitialization surface,
  ``levelsetequation.jl:169-203``): a host loop around one jitted step; the CFL
  scalar is the only per-step device->host sync.
- Without hooks: the whole ``t -> tf`` evolution runs device-resident in one
  ``lax.while_loop`` (:func:`lsm_tpu.integrators.loop.evolve`).
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, Optional, Sequence, Union

import jax.numpy as jnp

from .core.field import MeshField
from .geometry import queries as geo
from .integrators.explicit import RK3, TimeIntegrator
from .integrators import loop as _loop
from .terms.terms import compute_cfl as _compute_cfl, update_terms

__all__ = ["LevelSetEquation"]

Hook = Optional[Callable[["LevelSetEquation"], None]]


class LevelSetEquation:
    """``phi_t + sum_n term_n = 0`` evolution driver.

    Parameters mirror the reference constructor (``levelsetequation.jl:59-78``):
    ``terms`` (one term or a sequence), ``ic`` (initial :class:`MeshField`; never
    mutated — JAX arrays are immutable so the copy is free), ``bc`` (optional;
    wins over BCs already attached to ``ic``, with a warning when both are given;
    an error when neither is), ``integrator`` (default :class:`RK3`), ``t``.
    """

    def __init__(
        self,
        *,
        terms,
        ic: MeshField,
        bc=None,
        integrator: TimeIntegrator = RK3(),
        t: float = 0.0,
    ):
        if not isinstance(ic, MeshField):
            raise TypeError("ic must be a MeshField (or narrow-band field)")
        self.terms = tuple(terms) if isinstance(terms, (tuple, list)) else (terms,)
        if len(self.terms) == 0:
            raise ValueError("at least one term is required")
        if bc is not None:
            if ic.has_bcs():
                warnings.warn(
                    "both `bc` and boundary conditions on `ic` were provided; using `bc`"
                )
            state = ic.with_bcs(bc, replace=True)
        elif ic.has_bcs():
            state = ic
        else:
            raise ValueError(
                "no boundary conditions: provide `bc` or attach them to `ic`"
            )
        self.state = state
        self.integrator = integrator
        self.t = float(t)

    # -- accessors (levelsetequation.jl:124-166) -----------------------------------

    @property
    def current_state(self) -> MeshField:
        return self.state

    @property
    def current_time(self) -> float:
        return self.t

    @property
    def grid(self):
        return self.state.grid

    @property
    def boundary_conditions(self):
        return self.state.bcs

    def volume(self):
        return geo.volume(self.state)

    def perimeter(self):
        return geo.perimeter(self.state)

    # -- evolution -----------------------------------------------------------------

    def integrate(
        self,
        tf: float,
        dt_max: float = math.inf,
        *,
        prehook: Hook = None,
        posthook: Hook = None,
        max_steps: Optional[int] = None,
    ) -> "LevelSetEquation":
        """Advance the state to exactly ``tf`` (reference ``integrate!``,
        ``levelsetequation.jl:169-203``). Hooks run once per accepted step (not per
        RK stage) and may mutate ``self.state`` / ``self.terms``."""
        tf = float(tf)
        if tf < self.t:
            raise ValueError(f"tf = {tf} is before current time t = {self.t}")

        if prehook is None and posthook is None:
            phi, terms, t_reached, _ = _loop.evolve(
                self.integrator, self.terms, self.state, self.t, tf, dt_max,
                max_steps=max_steps,
            )
            if not bool(jnp.all(jnp.isfinite(phi.values))):
                raise ArithmeticError(
                    "non-finite state after integrate(); check for NaN/Inf velocities "
                    "or an invalid CFL time step"
                )
            # an early stop (max_steps) reports the time actually reached, not tf
            self.state, self.terms, self.t = phi, terms, float(t_reached)
            return self

        alpha = self.integrator.cfl
        nsteps = 0
        eps = jnp.finfo(self.state.dtype).eps * max(abs(tf), 1.0)
        while self.t <= tf - eps:
            if max_steps is not None and nsteps >= max_steps:
                break
            if prehook is not None:
                prehook(self)
            self.terms = update_terms(self.terms, self.state, self.t)
            cfl_dt = float(_compute_cfl(self.terms, self.state, self.t))
            if not (cfl_dt > 0) or math.isnan(cfl_dt):
                raise ValueError(
                    f"invalid time-step based on CFL condition: dt = {cfl_dt} "
                    "(check for NaN/Inf in velocity or speed)"
                )
            dt = min(dt_max, alpha * cfl_dt, tf - self.t)
            self.state, self.terms = _loop.step(
                self.integrator, self.terms, self.state, self.t, dt
            )
            self.state = self.state.update_band()  # no-op on dense fields
            self.t += dt
            nsteps += 1
            if posthook is not None:
                posthook(self)
        if self.t > tf - eps:
            # reached tf: snap away accumulated float dust so repeated
            # integrate() calls chain exactly; an early max_steps stop keeps
            # the time actually integrated to.
            self.t = tf
        return self

    def __repr__(self):
        term_strs = " + ".join(type(t).__name__ for t in self.terms)
        return (
            "LevelSetEquation:\n"
            f"  |- phi_t + {term_strs} = 0\n"
            f"  |- integrator: {self.integrator.describe()}\n"
            f"  |- t: {self.t}\n"
            f"  `- state: {self.state.shape} {self.state.dtype}"
        )
