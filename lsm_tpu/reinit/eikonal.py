"""Device-resident PDE reinitialization to a signed distance function.

Replaces the reference's KDTree + Newton closest-point ``reinitialize!``
(``/root/reference/src/reinitializer.jl``, ``src/sdf.jl``) with an iterated
Hamilton-Jacobi pseudo-time solve — the whole-array formulation anticipated by the
reference's own ``EikonalReinitializationTerm`` (``src/levelsetterms.jl:190-265``):

    d phi / d tau = - sign(phi0) (|grad phi| - 1)

discretized with the Godunov Hamiltonian + second-order ENO one-sided derivatives,
plus the Russo-Smereka subcell fix (Russo & Smereka 2000, "A remark on computing
distance functions") at interface-adjacent nodes so the zero contour does not move:
there the update relaxes ``phi`` toward the subcell distance estimate
``D = phi0 / |grad phi0|`` instead of solving the PDE, pinning the interface.

The whole solve is a single fused ``lax.fori_loop`` of elementwise stencil updates —
no host sync, no trees, differentiable, shardable. The high-order Newton
closest-point oracle lives separately in :mod:`lsm_tpu.interp.sdf`.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..core.field import MeshField
from ..ops import stencils as st

__all__ = ["reinitialize", "reinit_rhs"]


def _axis_crossing_distance(p0, ax, h, g, shape, dtype):
    """Per-node distances ``(s_m, s_p, cross_m, cross_p)`` to the zero
    crossing of phi0 along ``ax`` on the backward/forward side.

    Quadratic (ENO) interface location — Min, "On reinitializing level set
    functions" (JCP 2010), eq. (13)-(14): with ``pxx = minmod(D2 phi0_i,
    D2 phi0_{i+1})`` the crossing sits at

        s+ = h (1/2 + (p_i - p_{i+1} - sgn(p_i - p_{i+1}) sqrt(disc)) / pxx),
        disc = (pxx/2 - p_i - p_{i+1})^2 - 4 p_i p_{i+1},

    falling back to the linear secant ``h p_i / (p_i - p_{i+1})`` where the
    quadratic degenerates. O(h^3) interface location -> O(h^2) distances."""
    n = len(shape)
    c = st.shift(p0, (0,) * n, g, shape)
    nb_p = st.shift(p0, tuple(1 if d == ax else 0 for d in range(n)), g, shape)
    nb_m = st.shift(p0, tuple(-1 if d == ax else 0 for d in range(n)), g, shape)
    d2 = st.d2c(p0, ax, h, g, shape) * (h * h)  # undivided second difference

    def one_side(nb, d2nb):
        cross = c * nb < 0
        pxx = st.minmod(d2, d2nb)
        denom_lin = c - nb
        lin = h * c / jnp.where(denom_lin == 0, 1.0, denom_lin)
        disc = (0.5 * pxx - c - nb) ** 2 - 4.0 * c * nb
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        quad = h * (0.5 + (c - nb - jnp.sign(c - nb) * sq)
                    / jnp.where(pxx == 0, 1.0, pxx))
        eps = jnp.asarray(100.0, dtype) * jnp.finfo(dtype).eps
        s = jnp.where(jnp.abs(pxx) > eps, quad, lin)
        # the crossing must lie strictly inside (0, h]
        s = jnp.clip(s, eps * h, h)
        return jnp.where(cross, s, h), cross

    # undivided D2 at the neighbors i+1 / i-1 (reach 2: PAD_ENO2 suffices)
    d2_pl = (st.shift(p0, tuple(2 if d == ax else 0 for d in range(n)), g, shape)
             - 2.0 * nb_p + c)
    d2_mi = (st.shift(p0, tuple(-2 if d == ax else 0 for d in range(n)), g, shape)
             - 2.0 * nb_m + c)
    s_p, cross_p = one_side(nb_p, d2_pl)
    s_m, cross_m = one_side(nb_m, d2_mi)
    return s_m, s_p, cross_m, cross_p


def reinit_rhs(phi: MeshField, s0_values: jnp.ndarray) -> jnp.ndarray:
    """Pseudo-time RHS ``s0 (|grad phi| - 1)`` with frozen smoothed sign ``s0``
    (the away-from-interface part of the update)."""
    g = st.PAD_ENO2
    p = phi.pad(g)
    grad_p, grad_m = st.godunov_norms(p, phi.spacing, g, phi.shape)
    norm = jnp.where(s0_values > 0, grad_p, grad_m)
    return s0_values * (norm - 1.0)


@partial(jax.jit, static_argnames=("iters", "subcell"))
def _reinitialize_impl(phi: MeshField, iters: int, cfl, subcell: bool, band_width):
    g = st.PAD_ENO2
    dx = phi.grid.min_spacing
    dtype = phi.dtype
    shape = tuple(phi.shape)
    n = len(shape)
    spacing = phi.spacing

    p0 = phi.pad(g)
    # frozen smoothed sign (O-F eq. 7.5)
    s0 = phi.values / jnp.sqrt(phi.values**2 + dx * dx)
    sgn0 = jnp.sign(phi.values)

    if subcell:
        # second-order subcell fix (Min, JCP 2010): per-axis quadratic
        # interface locations from phi0, frozen across the pseudo-time solve
        geo = [
            _axis_crossing_distance(p0, ax, h, g, shape, dtype)
            for ax, h in enumerate(spacing)
        ]
        iface = jnp.zeros(shape, dtype=bool)
        smin = jnp.full(shape, jnp.inf, dtype)
        for s_m, s_p, cross_m, cross_p in geo:
            iface = iface | cross_m | cross_p
            smin = jnp.minimum(smin, jnp.where(cross_m, s_m, jnp.inf))
            smin = jnp.minimum(smin, jnp.where(cross_p, s_p, jnp.inf))
        # sign: exact at interface-adjacent nodes (the subcell stencils pin
        # the contour), smoothed elsewhere
        S = jnp.where(iface, sgn0, s0)
        # local pseudo-time step: the 1/s stiffness of the subcell stencils
        # demands dtau <= cfl * s at interface nodes
        dtau = cfl * jnp.minimum(smin, dx)
    else:
        S = s0
        dtau = cfl * dx

    if band_width is not None:
        # freeze nodes far outside the band: their value only needs the right sign
        active = jnp.abs(phi.values) <= band_width
    else:
        active = None

    def godunov_subcell(f):
        p = f.pad(g)
        c = f.values
        gp2 = 0.0
        gm2 = 0.0
        for ax, h in enumerate(spacing):
            A, B = st.eno2_onesided(p, ax, h, g, shape)
            s_m, s_p, cross_m, cross_p = geo[ax]
            # divided second derivatives of the CURRENT iterate at i, i+-1
            d2c = st.d2c(p, ax, h, g, shape)
            d2p = (st.shift(p, tuple(2 if d == ax else 0 for d in range(n)), g, shape)
                   - 2.0 * st.shift(p, tuple(1 if d == ax else 0 for d in range(n)), g, shape)
                   + c) / (h * h)
            d2m = (st.shift(p, tuple(-2 if d == ax else 0 for d in range(n)), g, shape)
                   - 2.0 * st.shift(p, tuple(-1 if d == ax else 0 for d in range(n)), g, shape)
                   + c) / (h * h)
            # Min eq. (23): one-sided differences toward the interface point
            B_fix = (0.0 - c) / s_p - 0.5 * s_p * st.minmod(d2c, d2p)
            A_fix = c / s_m + 0.5 * s_m * st.minmod(d2c, d2m)
            A = jnp.where(cross_m, A_fix, A)
            B = jnp.where(cross_p, B_fix, B)
            gp2 = gp2 + jnp.maximum(A, 0.0) ** 2 + jnp.minimum(B, 0.0) ** 2
            gm2 = gm2 + jnp.minimum(A, 0.0) ** 2 + jnp.maximum(B, 0.0) ** 2
        return jnp.sqrt(gp2), jnp.sqrt(gm2)

    def body(_, f):
        if subcell:
            grad_p, grad_m = godunov_subcell(f)
            norm = jnp.where(S > 0, grad_p, grad_m)
            new = f.values - dtau * S * (norm - 1.0)
        else:
            new = f.values - dtau * reinit_rhs(f, s0)
        if active is not None:
            new = jnp.where(active, new, f.values)
        return f.with_values(new.astype(dtype))

    return jax.lax.fori_loop(0, iters, body, phi)


def reinitialize(
    phi: MeshField,
    iters: Optional[int] = None,
    cfl: float = 0.45,
    subcell: bool = True,
    band_width: Optional[float] = None,
) -> MeshField:
    """Reinitialize ``phi`` to (approximately) a signed distance function.

    - ``iters``: pseudo-time steps. Default covers ``band_width`` (if given) or the
      full domain diameter at unit propagation speed.
    - ``cfl``: pseudo-time step ``dtau = cfl * min(h)``.
    - ``subcell``: apply the interface-pinning Russo-Smereka fix (recommended; the
      zero contour stays put to O(h^2)).
    - ``band_width``: only update nodes with ``|phi| <= band_width`` (narrow-band
      usage); farther nodes keep their (correctly signed) values.

    Accuracy oracle: the reference's Newton ``reinitialize!``
    (``test/test-reinitializer.jl``), relaxed to this method's order.
    """
    if not phi.has_bcs():
        from ..core.bc import LinearExtrapolation

        phi = phi.with_bcs(LinearExtrapolation())
    if iters is None:
        dx = phi.grid.min_spacing
        reach = band_width if band_width is not None else max(
            b - a for a, b in zip(phi.grid.lo, phi.grid.hi)
        )
        iters = int(math.ceil(reach / (cfl * dx))) + 5
    return _reinitialize_impl(phi, iters, cfl, subcell, band_width)
