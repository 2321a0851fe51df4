"""Sharded device-resident adaptive evolution, dense and narrow-band.

Puts the reference's ENTIRE adaptive time loop (``_integrate!``,
``/root/reference/src/timestepping.jl:101-122``) inside one ``shard_map``: each
shard runs the ``lax.while_loop`` on its local block, ghost layers move between
devices by ``ppermute`` (:func:`lsm_tpu.parallel.halo.halo_pad_axis`), and the CFL bound — a min over
*active* nodes globally (``levelsetterms.jl:22-38``) — becomes a shard-local
masked reduction followed by ``jax.lax.pmin`` over the mesh axes, so every
shard takes the same ``dt`` and the loop stays in lockstep without host trips.

The narrow band shards too: :class:`ShardedNarrowBandField` carries the local
``mask``/compute-mask blocks as ordinary sharded leaves, and ``update_band``
(reference ``update_band!``, ``meshfield.jl:553-588``) exchanges an
``nlayers+1``-deep halo of values+mask so cut-cell detection and the L1
dilation see across shard faces — the cropped result equals the unsharded
band mask exactly.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..core import bc as _bc
from ..core.field import MeshField
from ..core.grid import Grid
from ..core.narrowband import (
    NarrowBandField,
    _stamp_corners,
    cut_cell_mask,
    box_dilate,
)
from ..terms.terms import compute_cfl, update_terms
from .halo import HaloField, halo_pad_axis, _leaf_spec, _ring_perm

__all__ = [
    "ShardedNarrowBandField",
    "sharded_band_mask",
    "make_sharded_evolve",
]


def _exchange_pad_axis(v, axis, axis_name, n_shards, width, fill):
    """Pad one sharded axis with ``width`` layers: ppermute on interior faces,
    the constant ``fill`` on physical faces (no BC logic — used for masks and
    for band re-tubing, where out-of-domain neighbours simply don't exist)."""

    def sl(start, stop):
        s = [slice(None)] * v.ndim
        s[axis] = slice(start, stop)
        return v[tuple(s)]

    n = v.shape[axis]
    if n_shards == 1:
        pad_shape = list(v.shape)
        pad_shape[axis] = width
        block = jnp.full(pad_shape, fill, v.dtype)
        return jnp.concatenate([block, v, block], axis=axis)

    idx = jax.lax.axis_index(axis_name)
    from_left = jax.lax.ppermute(sl(n - width, n), axis_name, _ring_perm(n_shards, +1))
    from_right = jax.lax.ppermute(sl(0, width), axis_name, _ring_perm(n_shards, -1))
    fill_block = jnp.full_like(from_left, fill)
    from_left = jnp.where(idx == 0, fill_block, from_left)
    from_right = jnp.where(idx == n_shards - 1, fill_block, from_right)
    return jnp.concatenate([from_left, v, from_right], axis=axis)


def _exchange_pad(v, shard_axes, axis_sizes, width, fill):
    for d, name in enumerate(shard_axes):
        v = _exchange_pad_axis(v, d, name, axis_sizes[d] if name else 1, width, fill)
    return v


def sharded_band_mask(values, mask, nlayers, shard_axes, axis_sizes):
    """Shard-local re-tube: the new active mask for this block, seeing across
    shard faces. ``mask`` (may be None on first build) restricts cut-cell
    detection to fully-active cells (``meshfield.jl:567-575``)."""
    w = nlayers + 1  # 1 cell of cut-detection reach + nlayers of dilation
    v_ext = _exchange_pad(values, shard_axes, axis_sizes, w, 0.0)
    valid = _exchange_pad(
        jnp.ones(values.shape, bool), shard_axes, axis_sizes, w, False
    )
    node_mask = valid
    if mask is not None:
        m_ext = _exchange_pad(mask, shard_axes, axis_sizes, w, False)
        node_mask = node_mask & m_ext
    cut = cut_cell_mask(v_ext, node_mask)
    m = box_dilate(_stamp_corners(cut), nlayers)
    crop = tuple(slice(w, w + n) for n in values.shape)
    return m[crop]


@jax.tree_util.register_pytree_node_class
class ShardedNarrowBandField(NarrowBandField):
    """Shard-local view of a domain-decomposed narrow-band field.

    Same masked-dense semantics as :class:`NarrowBandField`; ``pad`` performs
    halo exchange on interior faces (physical faces keep the BC ghosts), and
    ``update_band`` re-tubes with cross-shard visibility. ``grid`` is the
    global grid (spacing source); ``shape`` reports the local block.
    """

    def __init__(self, values, grid, bcs, mask, nlayers, cmask,
                 shard_axes, axis_sizes):
        # bypass NarrowBandField.__init__ (it would recompute mask/cmask from
        # the local block without halo visibility)
        MeshField.__init__(self, values, grid, bcs, _normalized=True)
        self.mask = mask
        self.nlayers = nlayers
        self._cmask = cmask
        self.shard_axes = tuple(shard_axes)
        self.axis_sizes = tuple(axis_sizes)

    def tree_flatten(self):
        return (self.values, self.mask, self._cmask), (
            self.grid, self.bcs, self.nlayers, self.shard_axes, self.axis_sizes,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        grid, bcs, nlayers, shard_axes, axis_sizes = aux
        values, mask, cmask = children
        return cls(values, grid, bcs, mask, nlayers, cmask, shard_axes, axis_sizes)

    @property
    def shape(self):
        # the LOCAL block (stencils/pads operate shard-locally); the global
        # extent lives on self.grid
        return self.values.shape

    def with_values(self, values, mask_update: bool = True):
        if mask_update:
            values = jnp.where(self._cmask, values, self.values)
        return ShardedNarrowBandField(
            values, self.grid, self.bcs, self.mask, self.nlayers, self._cmask,
            self.shard_axes, self.axis_sizes,
        )

    def pad(self, width: int) -> jnp.ndarray:
        if self.bcs is None:
            raise ValueError("field has no boundary conditions")
        v = self.values
        for d in range(self.grid.ndim):
            name = self.shard_axes[d]
            if name is None:
                v = _bc.pad_axis(v, self.bcs[d], d, width)
            else:
                v = halo_pad_axis(v, d, name, self.axis_sizes[d], self.bcs[d], width)
        return v

    def update_band(self) -> "ShardedNarrowBandField":
        new_mask = sharded_band_mask(
            self.values, self.mask, self.nlayers, self.shard_axes, self.axis_sizes
        )
        w = self.COMPUTE_HALO
        cm_ext = _exchange_pad(new_mask, self.shard_axes, self.axis_sizes, w, False)
        cmask = box_dilate(cm_ext, w)[
            tuple(slice(w, w + n) for n in new_mask.shape)
        ]
        return ShardedNarrowBandField(
            self.values, self.grid, self.bcs, new_mask, self.nlayers, cmask,
            self.shard_axes, self.axis_sizes,
        )


def _mesh_layout(mesh: Mesh, ndim: int):
    names = list(mesh.axis_names)[:ndim]
    shard_axes = tuple(names[d] if d < len(names) else None for d in range(ndim))
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    axis_sizes = tuple(sizes.get(a, 1) if a else 1 for a in shard_axes)
    return shard_axes, axis_sizes


def make_sharded_evolve(
    integrator,
    mesh: Mesh,
    grid: Grid,
    dt_max=jnp.inf,
    max_steps: Optional[int] = None,
    is_band: bool = False,
    nlayers: int = 3,
):
    """Build a jitted sharded adaptive evolution
    ``(terms, phi: MeshField, t0, tf) -> (phi, t, nsteps)``.

    ``phi.values`` (and, for ``is_band=True``, the band masks built internally)
    are domain-decomposed over the mesh; the full while-loop runs inside
    ``shard_map`` with a ``pmin``-reduced CFL each step. Semantics match
    :func:`lsm_tpu.integrators.loop.evolve` (including early stop on
    ``max_steps`` / non-positive ``dt``).
    """
    ndim = grid.ndim
    shard_axes, axis_sizes = _mesh_layout(mesh, ndim)
    used_axes = tuple(a for a in shard_axes if a is not None)

    def evolve_fn(terms, phi: MeshField, t0, tf):
        bcs = phi.bcs
        dtype = phi.dtype
        eps = jnp.finfo(dtype).eps

        if is_band:
            nb = phi if isinstance(phi, NarrowBandField) else None
            local_leaves = (phi.values,) if nb is None else (
                phi.values, nb.mask, nb.compute_mask)
        else:
            local_leaves = (phi.values,)

        def local_evolve(terms, leaves, t0, tf):
            if is_band:
                if len(leaves) == 1:
                    values = leaves[0]
                    mask = sharded_band_mask(values, None, nlayers, shard_axes, axis_sizes)
                    w = NarrowBandField.COMPUTE_HALO
                    cm_ext = _exchange_pad(mask, shard_axes, axis_sizes, w, False)
                    cmask = box_dilate(cm_ext, w)[
                        tuple(slice(w, w + n) for n in mask.shape)]
                else:
                    values, mask, cmask = leaves
                hf = ShardedNarrowBandField(
                    values, grid, bcs, mask, nlayers, cmask, shard_axes, axis_sizes)
            else:
                hf = HaloField(leaves[0], grid, bcs, shard_axes, axis_sizes)

            t0_ = jnp.asarray(t0, dtype)
            tf_ = jnp.asarray(tf, dtype)

            def cond(carry):
                f, terms, t, n, ok = carry
                in_time = t <= tf_ - eps * jnp.maximum(jnp.abs(tf_), 1.0)
                if max_steps is not None:
                    in_time = jnp.logical_and(in_time, n < max_steps)
                return jnp.logical_and(in_time, ok)

            def body(carry):
                f, terms, t, n, ok = carry
                terms = update_terms(terms, f, t)
                dt_local = compute_cfl(terms, f, t)
                # global CFL: min over every shard's active nodes (SURVEY 2.3)
                dt = dt_local if not used_axes else jax.lax.pmin(dt_local, used_axes)
                dt = jnp.minimum(jnp.minimum(dt_max, integrator.cfl * dt), tf_ - t)
                ok = jnp.logical_and(ok, dt > 0)
                f_new, terms_new = integrator.advance(terms, f, t, dt)
                f_new = f_new.update_band()  # no-op on dense fields
                return f_new, terms_new, t + dt, n + 1, ok

            f, terms, t, n, ok = jax.lax.while_loop(
                cond, body, (hf, terms, t0_, jnp.asarray(0, jnp.int32), jnp.asarray(True))
            )
            reached = t > tf_ - eps * jnp.maximum(jnp.abs(tf_), 1.0)
            t = jnp.where(reached, tf_, t)
            if is_band:
                return (f.values, f.mask, f.compute_mask), t, n
            return (f.values,), t, n

        specs_terms = jax.tree_util.tree_map(
            lambda l: _leaf_spec(l, mesh, ndim), terms)
        leaf_specs = tuple(_leaf_spec(l, mesh, ndim) for l in local_leaves)
        out_leaf_specs = (
            (leaf_specs[0],) * 3 if is_band else (leaf_specs[0],))
        fn = shard_map(
            local_evolve,
            mesh=mesh,
            in_specs=(specs_terms, leaf_specs, P(), P()),
            out_specs=(out_leaf_specs, P(), P()),
            check_vma=False,
        )
        out_leaves, t, n = fn(terms, local_leaves, t0, tf)
        if is_band:
            values, mask, cmask = out_leaves
            out = NarrowBandField(
                values, grid, bcs, mask, nlayers, _normalized=True, _cmask=cmask)
        else:
            out = phi.with_values(out_leaves[0])
        return out, t, n

    return jax.jit(evolve_fn)
