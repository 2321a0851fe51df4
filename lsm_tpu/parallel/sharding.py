"""Device-mesh sharding of the level-set grid.

The reference has no distributed backend (threads only; SURVEY.md section 2.3) — this
layer is new surface. The domain decomposition IS the grid: the phi array is sharded
over a ``jax.sharding.Mesh`` of devices, one named mesh axis per (leading) spatial
dimension. Two execution paths:

- **auto-SPMD (this module)**: annotate shardings on the step inputs/outputs and let
  XLA's partitioner insert the halo collectives for the shifted-slice stencils
  (collective-permutes). Correct for every operator in the library; the
  differentiable rollout uses it.
- **explicit halo exchange** (:mod:`lsm_tpu.parallel.halo`): ``shard_map`` +
  ``ppermute`` 3-wide halos with physical BCs applied only on outermost shards —
  the path of :func:`lsm_tpu.parallel.make_sharded_evolve`.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.field import MeshField

__all__ = ["make_mesh", "mesh_axis_names", "domain_spec", "shard_field", "constrain"]


def _factorize(n: int, ndim: int) -> Tuple[int, ...]:
    """Split ``n`` devices into an ``ndim``-dim mesh shape, most-balanced first."""
    shape = [1] * ndim
    remaining = n
    for d in range(ndim):
        # greedy: largest divisor <= remaining^(1/(ndim-d))
        target = round(remaining ** (1.0 / (ndim - d)))
        best = 1
        for k in range(1, remaining + 1):
            if remaining % k == 0 and k <= max(target, 1):
                best = k
        shape[d] = best
        remaining //= best
    shape[-1] *= remaining
    return tuple(shape)


def mesh_axis_names(ndim: int) -> Tuple[str, ...]:
    return tuple("xyz"[d] if ndim <= 3 else f"d{d}" for d in range(ndim))


def make_mesh(
    n_devices: Optional[int] = None,
    mesh_shape: Optional[Sequence[int]] = None,
    axis_names: Optional[Sequence[str]] = None,
    devices=None,
) -> Mesh:
    """Build a device mesh for domain decomposition.

    Defaults: all available devices, factorized into a 2-axis mesh named
    ``("x", "y")``: grids shard their two leading dimensions, and for 3D the
    innermost (contiguous) dimension stays whole on every device, so halo slabs
    are contiguous rows. Every device reaches every other at the same rate, so
    the mesh shape follows the grid alone.
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if mesh_shape is None:
        ndim = 2 if n > 1 else 1
        mesh_shape = _factorize(n, ndim)
    mesh_shape = tuple(mesh_shape)
    if math.prod(mesh_shape) != n:
        raise ValueError(f"mesh shape {mesh_shape} does not cover {n} devices")
    if axis_names is None:
        axis_names = mesh_axis_names(len(mesh_shape))
    dev_array = np.asarray(devices).reshape(mesh_shape)
    return Mesh(dev_array, tuple(axis_names))


def domain_spec(mesh: Mesh, grid_ndim: int, vector: bool = False) -> P:
    """PartitionSpec sharding the leading grid dimensions over the mesh axes.

    Vector fields keep the component axis replicated.
    """
    names = list(mesh.axis_names)[:grid_ndim]
    spec = names + [None] * (grid_ndim - len(names))
    if vector:
        spec = [None] + spec
    return P(*spec)


def shard_field(phi: MeshField, mesh: Mesh) -> MeshField:
    """Place a field's values with the canonical domain-decomposition sharding."""
    spec = domain_spec(mesh, phi.ndim, vector=phi.is_vector)
    values = jax.device_put(phi.values, NamedSharding(mesh, spec))
    return phi.with_values(values)


def constrain(values, mesh: Mesh, grid_ndim: int, vector: bool = False):
    """``with_sharding_constraint`` with the canonical domain spec."""
    spec = domain_spec(mesh, grid_ndim, vector=vector)
    return jax.lax.with_sharding_constraint(values, NamedSharding(mesh, spec))
