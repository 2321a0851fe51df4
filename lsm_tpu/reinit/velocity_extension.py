"""Velocity extension off the interface along normals (Peng et al. 1999).

JAX analogue of the reference's ``src/velocityextension.jl``: solve in
pseudo-time ``dF/dtau + sign(phi) n . grad(F) = 0`` with first-order upwinding
biased by the precomputed smoothed-signed-normal components
``a_d = S * grad(phi)_d / |grad(phi)|``, ``S = phi / sqrt(phi^2 + dx^2)``, holding a
Dirichlet-frozen mask of near-interface nodes fixed. The fixed-iteration pointwise
loop of the reference is already device-shaped — here it is a ``lax.fori_loop`` of
fused whole-array upwind updates.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Union

import jax
import jax.numpy as jnp

from ..core.bc import LinearExtrapolation
from ..core.field import MeshField
from ..ops import stencils as st

__all__ = ["extend_along_normals"]


def _signed_normal_components(phi: MeshField, dx, min_norm):
    """``a_d = S grad(phi)_d / |grad|`` with centered differences; zero where the
    gradient (squared) norm is below ``min_norm^2`` (``velocityextension.jl:95-116``)."""
    g = st.PAD_D0
    p = phi.pad(g)
    comps = [st.d0(p, ax, h, g, phi.shape) for ax, h in enumerate(phi.spacing)]
    norm_sq = sum(c * c for c in comps)
    ok = norm_sq > min_norm * min_norm
    inv = jnp.where(ok, 1.0 / jnp.sqrt(jnp.where(ok, norm_sq, 1.0)), 0.0)
    S = phi.values / jnp.sqrt(phi.values**2 + dx * dx)
    return [S * c * inv for c in comps]


@partial(jax.jit, static_argnames=("nb_iters",))
def _extend_impl(F: MeshField, a_comps, frozen, tau, nb_iters: int):
    g = st.PAD_D0
    shape = F.shape
    spacing = F.spacing
    upwind_sel = [a > 0 for a in a_comps]

    def body(_, f):
        p = f.pad(g)
        adv = 0.0
        for ax, h in enumerate(spacing):
            dminus = st.dm(p, ax, h, g, shape)
            dplus = st.dp(p, ax, h, g, shape)
            adv = adv + a_comps[ax] * jnp.where(upwind_sel[ax], dminus, dplus)
        new = f.values - tau * adv
        return f.with_values(jnp.where(frozen, f.values, new))

    return jax.lax.fori_loop(0, nb_iters, body, F)


def extend_along_normals(
    F: Union[MeshField, jnp.ndarray],
    phi: MeshField,
    nb_iters: int = 50,
    cfl: float = 0.45,
    frozen: Optional[jnp.ndarray] = None,
    interface_band: float = 1.5,
    min_norm: float = 1e-14,
) -> Union[MeshField, jnp.ndarray]:
    """Extend the scalar speed field ``F`` away from the interface of ``phi``.

    ``frozen`` (bool array) marks Dirichlet-held nodes; by default the band
    ``|phi| <= interface_band * min(h)``. Returns the same kind (array/MeshField)
    as the input.
    """
    if nb_iters < 0:
        raise ValueError("nb_iters must be non-negative")
    if cfl <= 0:
        raise ValueError("cfl must be strictly positive")
    if interface_band < 0:
        raise ValueError("interface_band must be non-negative")
    if min_norm < 0:
        raise ValueError("min_norm must be non-negative")

    as_field = isinstance(F, MeshField)
    if as_field:
        if F.grid != phi.grid:
            raise ValueError("F and phi must be defined on the same mesh")
        F_values = F.values
    else:
        F_values = jnp.asarray(F)
        if F_values.shape != phi.shape:
            raise ValueError("F and phi must have the same size")
    if not jnp.issubdtype(F_values.dtype, jnp.floating):
        raise ValueError("F must have floating-point element type")

    bcs = phi.bcs
    if bcs is None:
        phi = phi.with_bcs(LinearExtrapolation())
        bcs = phi.bcs
    Ff = MeshField(F_values, phi.grid, bcs, _normalized=True)

    dx = phi.grid.min_spacing
    if frozen is None:
        frozen_mask = jnp.abs(phi.values) <= interface_band * dx
    else:
        if isinstance(frozen, MeshField):
            frozen = frozen.values
        frozen = jnp.asarray(frozen)
        if frozen.shape != phi.shape:
            raise ValueError("frozen mask must have the same size as phi")
        if frozen.dtype != jnp.bool_:
            raise ValueError("frozen mask must contain Bool values")
        frozen_mask = frozen

    a = _signed_normal_components(phi, dx, min_norm)
    out = _extend_impl(Ff, a, frozen_mask, cfl * dx, nb_iters)
    if as_field:
        return F.with_values(out.values)
    return out.values
