"""Sharded device-resident adaptive evolution == unsharded evolve, dense and
narrow-band, on the 8-device virtual CPU mesh.

The whole adaptive while-loop (state-dependent CFL dt) runs inside shard_map
with a pmin CFL reduction; results must match the single-device
:func:`lsm_tpu.integrators.loop.evolve` to float tolerance over >= 20 steps.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import lsm_tpu as lsm
from lsm_tpu.integrators.loop import evolve
from lsm_tpu.models import shapes
from lsm_tpu.parallel import (
    ShardedNarrowBandField,
    make_mesh,
    make_sharded_evolve,
    shard_field,
    sharded_band_mask,
)
from lsm_tpu.core.narrowband import NarrowBandField, band_mask_from_values


def _mesh2d():
    return make_mesh(8, mesh_shape=(4, 2), axis_names=("x", "y"))


def _setup_dense():
    grid = lsm.Grid((-1.0, -1.0), (1.0, 1.0), (64, 32))
    phi = lsm.sample(
        lambda X, Y: jnp.sqrt((X - 0.3) ** 2 + Y**2) - 0.35, grid,
        lsm.Extrapolation(2),
    )
    vel = lsm.sample(lambda X, Y: (-Y, X), grid, vector=True)
    return grid, phi, lsm.AdvectionTerm(vel)


def test_sharded_evolve_dense_matches_unsharded():
    grid, phi, term = _setup_dense()
    tf = 0.7  # >= 20 adaptive CFL steps at 64x32
    ref_phi, _, ref_t, ref_n = evolve(lsm.RK3(), (term,), phi, 0.0, tf)
    assert int(ref_n) >= 20

    mesh = _mesh2d()
    ev = make_sharded_evolve(lsm.RK3(), mesh, grid)
    out, t, n = ev((term,), shard_field(phi, mesh), 0.0, tf)
    assert int(n) == int(ref_n)
    assert float(t) == float(ref_t)
    np.testing.assert_allclose(
        np.asarray(out.values), np.asarray(ref_phi.values), atol=1e-12
    )


def test_sharded_evolve_max_steps_early_stop():
    grid, phi, term = _setup_dense()
    mesh = _mesh2d()
    ev = make_sharded_evolve(lsm.RK3(), mesh, grid, max_steps=5)
    out, t, n = ev((term,), shard_field(phi, mesh), 0.0, 0.7)
    assert int(n) == 5
    assert float(t) < 0.7  # reports the time actually reached


def _setup_band():
    grid = lsm.Grid((-1.0, -1.0), (1.0, 1.0), (64, 32))
    phi = lsm.sample(
        lambda X, Y: jnp.sqrt((X - 0.3) ** 2 + Y**2) - 0.35, grid,
        lsm.Extrapolation(2),
    )
    vel = lsm.sample(lambda X, Y: (-Y, X), grid, vector=True)
    return grid, NarrowBandField.from_field(phi), lsm.AdvectionTerm(vel)


def test_sharded_band_mask_matches_unsharded():
    grid, nb, _ = _setup_band()
    mesh = _mesh2d()
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def local(v, m):
        return sharded_band_mask(v, m, 3, ("x", "y"), (4, 2))

    got = shard_map(
        local, mesh=mesh, in_specs=(P("x", "y"), P("x", "y")),
        out_specs=P("x", "y"), check_vma=False,
    )(nb.values, nb.mask)
    expect = band_mask_from_values(nb.values, 3, nb.mask)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(expect))


def test_sharded_evolve_band_matches_unsharded():
    grid, nb, term = _setup_band()
    tf = 0.7
    ref_phi, _, ref_t, ref_n = evolve(lsm.RK3(), (term,), nb, 0.0, tf)
    assert int(ref_n) >= 20

    mesh = _mesh2d()
    ev = make_sharded_evolve(lsm.RK3(), mesh, grid, is_band=True, nlayers=nb.nlayers)
    out, t, n = ev((term,), shard_field(nb, mesh), 0.0, tf)
    assert int(n) == int(ref_n)
    assert isinstance(out, NarrowBandField)
    np.testing.assert_array_equal(np.asarray(out.mask), np.asarray(ref_phi.mask))
    np.testing.assert_allclose(
        np.asarray(out.values), np.asarray(ref_phi.values), atol=1e-12
    )


def test_sharded_step_band_matches_unsharded():
    # one-step API (make_sharded_step) with a NarrowBandField
    from lsm_tpu.parallel import make_sharded_step
    from lsm_tpu.integrators.loop import step as unsharded_step

    grid, nb, term = _setup_band()
    mesh = _mesh2d()
    sstep = make_sharded_step(lsm.RK3(), mesh, grid)
    dt = 0.3 * grid.min_spacing
    got = sstep((term,), shard_field(nb, mesh), 0.0, dt)
    expect, _ = unsharded_step(lsm.RK3(), (term,), nb, 0.0, dt)
    np.testing.assert_allclose(
        np.asarray(got.values), np.asarray(expect.values), atol=1e-12
    )


def test_sharded_evolve_band_multi_term():
    # band + advection + normal motion, sharded == unsharded
    grid, nb, term = _setup_band()
    terms = (term, lsm.NormalMotionTerm(0.05))
    tf = 0.25
    ref_phi, _, ref_t, ref_n = evolve(lsm.RK3(), terms, nb, 0.0, tf)
    mesh = _mesh2d()
    ev = make_sharded_evolve(lsm.RK3(), mesh, grid, is_band=True, nlayers=nb.nlayers)
    out, t, n = ev(terms, shard_field(nb, mesh), 0.0, tf)
    assert int(n) == int(ref_n)
    np.testing.assert_allclose(
        np.asarray(out.values), np.asarray(ref_phi.values), atol=1e-12
    )
