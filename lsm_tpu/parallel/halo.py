"""Explicit halo exchange over the device mesh (shard_map + ppermute).

The auto-SPMD path (:mod:`lsm_tpu.parallel.sharding`) lets XLA infer the
collectives; this module is the hand-written equivalent the sharded evolution
builds on: the grid is domain-decomposed over mesh axes, and ghost layers come from

- **interior faces**: ``jax.lax.ppermute`` ring shifts of edge slabs (width = the
  stencil reach, 3 for WENO5),
- **physical faces** (outermost shards): the ordinary BC ghost blocks of
  :mod:`lsm_tpu.core.bc` computed from shard-local data,
- **periodic wrap**: the ring permute *with the duplicated-endpoint correction*
  — the global grid stores both endpoints of a periodic dimension
  (``phi[0] == phi[n-1]``, period ``n-1`` nodes), so the wrapping shard sends a
  slab shifted by one node (left ghost at distance k reads node ``n-1-k``).

Key construct: :class:`HaloField` — a :class:`MeshField` whose ``pad(width)``
performs the halo exchange instead of a local BC pad. Because every stencil,
term, and integrator in the engine reaches ghost values exclusively through
``pad``, the *entire* evolution stack runs unchanged inside ``shard_map`` on
shard-local arrays: :func:`sharded_advance` is literally
``integrator.advance`` on a ``HaloField``.

Corner ghosts across shard corners compose exactly like the local pad: dims are
exchanged sequentially, and a later dim's edge slab already contains the earlier
dim's halos.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..core import bc as _bc
from ..core.field import MeshField
from ..core.grid import Grid
from .sharding import domain_spec

__all__ = ["HaloField", "halo_pad_axis", "sharded_advance", "make_sharded_step"]


def _ring_perm(n: int, shift: int):
    return [(i, (i + shift) % n) for i in range(n)]


def halo_pad_axis(
    v: jnp.ndarray,
    axis: int,
    axis_name: str,
    n_shards: int,
    bc_pair,
    width: int,
) -> jnp.ndarray:
    """Pad one *sharded* axis of a shard-local array with ``width`` ghost layers:
    ppermute exchange on interior faces, BC ghosts on physical faces."""
    if n_shards == 1:
        return _bc.pad_axis(v, bc_pair, axis, width)

    left_bc, right_bc = bc_pair
    periodic = isinstance(left_bc, _bc.Periodic)
    idx = jax.lax.axis_index(axis_name)
    n = v.shape[axis]

    def sl(start, stop):
        s = [slice(None)] * v.ndim
        s[axis] = slice(start, stop)
        return v[tuple(s)]

    # slab sent rightward becomes the right neighbor's LEFT halo.
    # Periodic wrap correction: the last shard holds the duplicated endpoint, so
    # for the wrap message it sends [n-1-w, n-1) instead of its last w rows.
    send_right = sl(n - width, n)
    if periodic:
        send_right = jnp.where(
            idx == n_shards - 1, sl(n - 1 - width, n - 1), send_right
        )
    from_left = jax.lax.ppermute(send_right, axis_name, _ring_perm(n_shards, +1))

    # slab sent leftward becomes the left neighbor's RIGHT halo; shard 0's wrap
    # message skips its duplicated endpoint (right ghost at distance k = node k).
    send_left = sl(0, width)
    if periodic:
        send_left = jnp.where(idx == 0, sl(1, width + 1), send_left)
    from_right = jax.lax.ppermute(send_left, axis_name, _ring_perm(n_shards, -1))

    if not periodic:
        # physical faces: overwrite the (garbage) wrap messages with BC ghosts
        lblock = _bc._ghost_block(v, left_bc, axis, width, "left")
        rblock = _bc._ghost_block(v, right_bc, axis, width, "right")
        from_left = jnp.where(idx == 0, lblock, from_left)
        from_right = jnp.where(idx == n_shards - 1, rblock, from_right)

    return jnp.concatenate([from_left, v, from_right], axis=axis)


@jax.tree_util.register_pytree_node_class
class HaloField(MeshField):
    """Shard-local view of a domain-decomposed field.

    ``shard_axes[d]`` is the mesh axis name dimension ``d`` is sharded over (or
    None), ``axis_sizes[d]`` the shard count. ``grid`` is the *global* grid
    (spacing source); ``shape`` reports the local array shape.
    """

    def __init__(self, values, grid: Grid, bcs, shard_axes, axis_sizes, _normalized=True):
        super().__init__(values, grid, bcs, _normalized=_normalized)
        self.shard_axes = tuple(shard_axes)
        self.axis_sizes = tuple(axis_sizes)

    def tree_flatten(self):
        return (self.values,), (self.grid, self.bcs, self.shard_axes, self.axis_sizes)

    @classmethod
    def tree_unflatten(cls, aux, children):
        grid, bcs, shard_axes, axis_sizes = aux
        return cls(children[0], grid, bcs, shard_axes, axis_sizes)

    @property
    def shape(self):
        spatial = self.values.shape
        if self.is_vector:
            spatial = spatial[1:]
        return spatial

    @property
    def is_vector(self) -> bool:
        return self.values.ndim == self.grid.ndim + 1

    def with_values(self, values):
        return HaloField(values, self.grid, self.bcs, self.shard_axes, self.axis_sizes)

    def pad(self, width: int) -> jnp.ndarray:
        if self.bcs is None:
            raise ValueError("field has no boundary conditions")
        v = self.values
        lead = 1 if self.is_vector else 0
        for d in range(self.grid.ndim):
            ax = d + lead
            name = self.shard_axes[d]
            if name is None:
                v = _bc.pad_axis(v, self.bcs[d], ax, width)
            else:
                v = halo_pad_axis(v, ax, name, self.axis_sizes[d], self.bcs[d], width)
        return v


def _leaf_spec(leaf, mesh: Mesh, grid_ndim: int):
    names = list(mesh.axis_names)[:grid_ndim]
    nd = getattr(leaf, "ndim", 0)
    if nd == grid_ndim:
        return P(*(names + [None] * (grid_ndim - len(names))))
    if nd == grid_ndim + 1:  # vector field: component axis replicated
        return P(*([None] + names + [None] * (grid_ndim - len(names))))
    return P()


def make_sharded_step(integrator, mesh: Mesh, grid: Grid):
    """Build a jitted shard_map step ``(terms, phi, t, dt) -> phi_new``.

    ``phi`` may be a dense :class:`MeshField` or a
    :class:`~lsm_tpu.core.narrowband.NarrowBandField` (the band masks shard as
    ordinary leaves; masked updates apply shard-locally). Coefficient fields
    inside the terms must be arrays / MeshFields (sharded alongside phi);
    coordinate-callable coefficients cannot see shard-local coordinates and are
    rejected by omission.
    """
    from ..core.narrowband import NarrowBandField

    ndim = grid.ndim
    names = list(mesh.axis_names)[:ndim]
    shard_axes = tuple(names[d] if d < len(names) else None for d in range(ndim))
    axis_sizes = tuple(
        dict(zip(mesh.axis_names, mesh.devices.shape)).get(a, 1) if a else 1
        for a in shard_axes
    )

    def step(terms, phi: MeshField, t, dt):
        bcs = phi.bcs  # static; closed over by the local step
        is_band = isinstance(phi, NarrowBandField)

        def local_step(terms, leaves, t, dt):
            if is_band:
                from .evolve import ShardedNarrowBandField

                values, mask, cmask = leaves
                hf = ShardedNarrowBandField(
                    values, grid, bcs, mask, phi.nlayers, cmask,
                    shard_axes, axis_sizes,
                )
            else:
                hf = HaloField(leaves[0], grid, bcs, shard_axes, axis_sizes)
            out, _ = integrator.advance(terms, hf, t, dt)
            return out.values

        leaves = (
            (phi.values, phi.mask, phi.compute_mask) if is_band else (phi.values,)
        )
        specs_terms = jax.tree_util.tree_map(lambda l: _leaf_spec(l, mesh, ndim), terms)
        leaf_specs = tuple(_leaf_spec(l, mesh, ndim) for l in leaves)
        fn = shard_map(
            local_step,
            mesh=mesh,
            in_specs=(specs_terms, leaf_specs, P(), P()),
            out_specs=leaf_specs[0],
            check_vma=False,
        )
        new_values = fn(terms, leaves, t, dt)
        if is_band:
            # the local steps already applied the compute-mask freeze
            return phi.with_values(new_values, mask_update=False)
        return phi.with_values(new_values)

    return jax.jit(step)
