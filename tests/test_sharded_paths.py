"""3D sharded evolution and sharded differentiable rollouts == one device, on
the 8-device CPU mesh.

``make_sharded_evolve`` runs the adaptive loop under ``shard_map`` with
``ppermute`` halos and a ``pmin`` CFL bound; the differentiable rollout is the
auto-SPMD path (``shard_field`` + ``constrain``, XLA inserts the halo
collectives). Coordinate-callable velocities cannot see shard-local
coordinates under ``shard_map``, so the sharded evolution takes them sampled.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import lsm_tpu as lsm
from lsm_tpu.parallel import constrain, make_mesh, make_sharded_evolve, shard_field

SHAPE = (32, 16, 16)


def _grid(lo=(0.0, 0.0, 0.0), hi=(1.0, 1.0, 1.0)):
    return lsm.Grid(lo, hi, SHAPE)


def _swirl(grid):
    return lsm.sample(
        lambda X, Y, Z: jnp.sin(2 * jnp.pi * X) * jnp.cos(2 * jnp.pi * Y)
        + 0.3 * jnp.sin(2 * jnp.pi * Z), grid, lsm.Periodic())


def _vel(grid, w=0.2):
    return lsm.sample(lambda X, Y, Z: (0.5 - Y + 0.0 * (X + Z), X - 0.5 + 0.0 * (Y + Z),
                                       w + 0.0 * (X + Y + Z)), grid, vector=True)


def _evolve_case(name):
    if name == "periodic-rk3":
        grid = _grid()
        return lsm.RK3(), (lsm.AdvectionTerm(_vel(grid)),), _swirl(grid), 0.05
    if name == "extrapolation-fe":
        grid = _grid((-1.0,) * 3, (1.0,) * 3)
        phi = lsm.sample(lambda X, Y, Z: jnp.sqrt(X**2 + Y**2 + Z**2) - 0.5, grid,
                         lsm.Extrapolation(1))
        vel = lsm.sample(lambda X, Y, Z: (-Y + 0.0 * (X + Z), X + 0.0 * (Y + Z),
                                          0.1 + 0.0 * (X + Y + Z)), grid, vector=True)
        return lsm.ForwardEuler(), (lsm.AdvectionTerm(vel),), phi, 0.2
    grid = _grid()  # mixed BCs per face, advection + frozen-sign reinitialization
    phi = lsm.sample(
        lambda X, Y, Z: jnp.sqrt((X - 0.5) ** 2 + (Y - 0.4) ** 2 + (Z - 0.6) ** 2) - 0.25,
        grid, bc=[(lsm.Symmetry(), lsm.Extrapolation(2)), lsm.Extrapolation(1),
                  lsm.Symmetry()])
    terms = (lsm.AdvectionTerm(_vel(grid, w=0.0)),
             lsm.EikonalReinitializationTerm.from_initial(phi))
    return lsm.RK2(), terms, phi, 0.05


@pytest.mark.parametrize("name", ["periodic-rk3", "extrapolation-fe", "mixed-bcs-multi-term-rk2"])
def test_sharded_evolve_3d_matches_single_device(name):
    integrator, terms, phi, tf = _evolve_case(name)
    ref, _, t_ref, n_ref = lsm.evolve(integrator, terms, phi, 0.0, tf, max_steps=6)
    mesh = make_mesh(8)
    ev = make_sharded_evolve(integrator, mesh, phi.grid, max_steps=6)
    out, t, n = ev(terms, shard_field(phi, mesh), 0.0, tf)
    assert int(n) == int(n_ref) >= 3
    assert float(t) == float(t_ref)
    assert len(out.values.sharding.device_set) == 8
    a, b = np.asarray(out.values), np.asarray(ref.values)
    assert np.abs(a - b).max() < 1e-12 * max(np.abs(b).max(), 1.0)


def _rollout_grad(integrator, phi, vel, nsteps, mesh=None, remat=True, wrt=0):
    dt = 0.3 * phi.grid.min_spacing

    def loss(values, vel_values):
        if mesh is not None:
            values = constrain(values, mesh, 3)
        term = lsm.AdvectionTerm(vel.with_values(vel_values))
        out, _ = lsm.rollout(integrator, (term,), phi.with_values(values), 0.0, dt,
                             nsteps, remat=remat)
        v = constrain(out.values, mesh, 3) if mesh is not None else out.values
        return jnp.sum(v ** 2)

    p, u = phi.values, vel.values
    if mesh is not None:
        p, u = shard_field(phi, mesh).values, shard_field(vel, mesh).values
    return jax.jit(jax.value_and_grad(loss, argnums=wrt))(p, u)


def _close(got, want, tol=1e-11):
    (vs, gs), (vr, gr) = got, want
    np.testing.assert_allclose(float(vs), float(vr), rtol=1e-12)
    a, b = np.asarray(gs), np.asarray(gr)
    assert np.abs(b).max() > 0
    assert np.abs(a - b).max() < tol * max(np.abs(b).max(), 1.0)


@pytest.mark.parametrize("case", ["periodic-rk3", "mixed-bcs-fe-phi-and-velocity",
                                  "remat-rk2"])
def test_sharded_rollout_grad_matches_single_device(case):
    mesh = make_mesh(8)
    if case == "periodic-rk3":
        grid = _grid()
        phi, vel = _swirl(grid), _vel(grid)
        _close(_rollout_grad(lsm.RK3(), phi, vel, 3, mesh),
               _rollout_grad(lsm.RK3(), phi, vel, 3))
    elif case == "mixed-bcs-fe-phi-and-velocity":
        grid = _grid((-1.0,) * 3, (1.0,) * 3)
        rng = np.random.default_rng(5)
        phi = lsm.sample(
            lambda X, Y, Z: jnp.sqrt((X + 0.013) ** 2 + (Y - 0.021) ** 2 + Z**2) - 0.493,
            grid, bc=[(lsm.Symmetry(), lsm.Extrapolation(2)), lsm.Extrapolation(1),
                      lsm.Periodic()])
        phi = phi.with_values(phi.values + jnp.asarray(rng.standard_normal(SHAPE)) * 1e-3)
        vel = lsm.sample(lambda X, Y, Z: (-Y + 0.0 * (X + Z), X + 0.0 * (Y + Z),
                                          0.1 + 0.0 * (X + Y + Z)), grid, vector=True)
        for wrt in (0, 1):
            _close(_rollout_grad(lsm.ForwardEuler(), phi, vel, 2, mesh, wrt=wrt),
                   _rollout_grad(lsm.ForwardEuler(), phi, vel, 2, wrt=wrt))
    else:  # step-level remat is gradient-neutral on the sharded path too
        grid = _grid()
        phi, vel = _swirl(grid), _vel(grid, w=0.25)
        _close(_rollout_grad(lsm.RK2(), phi, vel, 3, mesh, remat=True),
               _rollout_grad(lsm.RK2(), phi, vel, 3, mesh, remat=False), tol=1e-13)
