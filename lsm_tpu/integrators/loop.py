"""Device-resident time-loop drivers.

Two compiled forms of the reference's ``_integrate!`` outer loop
(``/root/reference/src/timestepping.jl:101-122``):

- :func:`evolve` — adaptive CFL-driven ``lax.while_loop`` landing exactly on
  ``tf``; the forward-only path of ``LevelSetEquation.integrate``.
- :func:`rollout` — fixed-step ``lax.scan`` over ``nsteps``; fully reverse-mode
  differentiable (gradients of the evolved phi flow through every step), the
  path the reference never had.

Both re-update state-dependent terms before the step (so ``dt`` reflects the speed
actually used) and at every RK stage, matching the reference semantics.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..core.field import MeshField
from ..terms.terms import compute_cfl, update_terms
from .explicit import TimeIntegrator

__all__ = ["evolve", "rollout", "step"]


def _scan_steps(step_fn, carry, nsteps, remat, remat_chunk):
    """``carry = step_fn(carry)`` repeated ``nsteps`` times under ``lax.scan``.

    ``remat=True`` wraps each step in :func:`jax.checkpoint` so the scan's
    backward saves only the step-INPUT carry per step instead of every RK
    stage's residuals. Forward-only evaluation is unaffected: checkpoint adds
    no work unless the scan is differentiated.

    ``remat_chunk=K`` adds a second remat level for long horizons: an outer
    scan over checkpointed K-step chunks, so peak residual memory is
    ``nsteps/K + K`` carries instead of ``nsteps``.
    """
    one = jax.checkpoint(step_fn) if remat else step_fn

    def body(c, _):
        return one(c), None

    if remat and remat_chunk and nsteps > remat_chunk:
        chunk = int(remat_chunk)
        nchunks, rem = divmod(nsteps, chunk)

        @jax.checkpoint
        def chunk_fn(c):
            c, _ = jax.lax.scan(body, c, None, length=chunk)
            return c

        def outer(c, _):
            return chunk_fn(c), None

        carry, _ = jax.lax.scan(outer, carry, None, length=nchunks)
        if rem:
            carry, _ = jax.lax.scan(body, carry, None, length=rem)
        return carry
    carry, _ = jax.lax.scan(body, carry, None, length=nsteps)
    return carry


@partial(jax.jit, static_argnames=("integrator",))
def step(integrator: TimeIntegrator, terms, phi: MeshField, t, dt):
    """One accepted step of ``integrator`` (jitted, shared by all drivers)."""
    return integrator.advance(terms, phi, t, dt)


@partial(jax.jit, static_argnames=("integrator", "max_steps"))
def evolve(
    integrator: TimeIntegrator,
    terms,
    phi: MeshField,
    t0,
    tf,
    dt_max=jnp.inf,
    max_steps: Optional[int] = None,
):
    """Evolve ``phi`` from ``t0`` to exactly ``tf`` with adaptive CFL time steps,
    entirely on device (``lax.while_loop``). Returns ``(phi, terms, t, nsteps)``
    where ``t`` is the time actually reached (``== tf`` unless the loop stopped
    early on ``max_steps`` or a non-positive ``dt``).

    ``max_steps`` optionally bounds the iteration count (guards against a
    vanishing CFL); the loop also stops if ``dt`` becomes non-positive or NaN.
    """
    dtype = phi.dtype
    t0 = jnp.asarray(t0, dtype)
    tf = jnp.asarray(tf, dtype)
    eps = jnp.finfo(dtype).eps

    def cond(carry):
        phi, terms, t, n, ok = carry
        in_time = t <= tf - eps * jnp.maximum(jnp.abs(tf), 1.0)
        if max_steps is not None:
            in_time = jnp.logical_and(in_time, n < max_steps)
        return jnp.logical_and(in_time, ok)

    def body(carry):
        phi, terms, t, n, ok = carry
        terms = update_terms(terms, phi, t)
        dt = jnp.minimum(
            jnp.minimum(dt_max, integrator.cfl * compute_cfl(terms, phi, t)), tf - t
        )
        ok = jnp.logical_and(ok, dt > 0)
        phi_new, terms_new = integrator.advance(terms, phi, t, dt)
        phi_new = phi_new.update_band()  # no-op on dense fields
        return phi_new, terms_new, t + dt, n + 1, ok

    phi, terms, t, n, ok = jax.lax.while_loop(
        cond, body, (phi, terms, t0, jnp.asarray(0, jnp.int32), jnp.asarray(True))
    )
    # Steps land exactly on tf (dt is clamped to tf - t); snap away the residual
    # float dust, but only when the loop actually reached tf (an early stop on
    # max_steps/dt<=0 must report the time really integrated to).
    reached = t > tf - eps * jnp.maximum(jnp.abs(tf), 1.0)
    t = jnp.where(reached, tf, t)
    return phi, terms, t, n


@partial(jax.jit, static_argnames=("integrator", "nsteps", "remat", "remat_chunk"))
def rollout(
    integrator: TimeIntegrator,
    terms,
    phi: MeshField,
    t0,
    dt,
    nsteps: int,
    remat: bool = True,
    remat_chunk: Optional[int] = None,
):
    """Fixed-step differentiable rollout: ``nsteps`` steps of size ``dt`` under
    ``lax.scan``. Returns ``(phi, terms)`` at ``t0 + nsteps * dt``.

    ``remat`` (default on) wraps each step in :func:`jax.checkpoint`, so a
    differentiated rollout saves ONE step-input buffer per step instead of
    every RK stage's residuals; forward-only rollouts pay nothing for it.
    ``remat_chunk=K`` trades a second recompute level for ``nsteps/K + K``
    saved buffers on longer horizons.
    """
    dtype = phi.dtype
    dt = jnp.asarray(dt, dtype)

    def one(carry):
        phi, terms, t = carry
        phi, terms = integrator.advance(terms, phi, t, dt)
        phi = phi.update_band()  # no-op on dense fields
        return phi, terms, t + dt

    phi, terms, _ = _scan_steps(one, (phi, terms, jnp.asarray(t0, dtype)),
                                nsteps, remat, remat_chunk)
    return phi, terms
