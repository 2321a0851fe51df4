"""``LevelSetEquation.integrate`` and ``rollout``: one path each.

``integrate`` without hooks runs the device-resident adaptive ``lax.while_loop``
(``loop.evolve``); with hooks it runs the host loop around one jitted step. Both
implement the reference loop (``timestepping.jl:101-122``) and must agree, dense
and banded, for every explicit integrator. Bands must match the dense run near
the interface (reference ``test-levelsetequation.jl:144-154``), also with a
state-dependent velocity and when ``eq.state`` is reassigned between calls.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import lsm_tpu as lsm
from lsm_tpu.core.narrowband import NarrowBandField

INTEGRATORS = [lsm.ForwardEuler(), lsm.RK2(), lsm.RK3()]
INTEGRATOR_IDS = ["fe", "rk2", "rk3"]


def _circle(ndim, n=24):
    lo, hi = (-1.0,) * ndim, (1.0,) * ndim
    grid = lsm.Grid(lo, hi, (n,) * ndim)
    if ndim == 2:
        f = lambda X, Y: jnp.sqrt((X - 0.2) ** 2 + Y**2) - 0.5
    else:
        f = lambda X, Y, Z: jnp.sqrt((X - 0.2) ** 2 + Y**2 + Z**2) - 0.5
    return grid, lsm.sample(f, grid, lsm.Extrapolation(2))


def _rotation(ndim):
    if ndim == 2:
        return lambda xs, t: (-xs[1] + 0 * xs[0], xs[0] + 0 * xs[1])
    return lambda xs, t: (-xs[1] + 0 * xs[0], xs[0] + 0 * xs[1], 0.1 + 0 * xs[2])


def _near_error(nb, dense, nlayers=3):
    """Max |band - dense| over active nodes within half the band width."""
    gamma = nlayers * nb.grid.min_spacing
    m = np.asarray(nb.active_mask) & (np.abs(np.asarray(nb.values)) < gamma / 2)
    assert m.any()
    return np.abs(np.asarray(nb.values) - np.asarray(dense.values))[m].max()


@pytest.mark.parametrize("kind", ["dense2d", "dense3d", "band2d", "band3d"])
@pytest.mark.parametrize("integrator", INTEGRATORS, ids=INTEGRATOR_IDS)
def test_device_loop_matches_host_loop(integrator, kind):
    ndim = int(kind[-2])
    grid, phi = _circle(ndim, n=24 if ndim == 2 else 12)
    ic = NarrowBandField.from_field(phi) if kind.startswith("band") else phi
    tf = 7.5 * 0.25 * grid.min_spacing
    term = lsm.AdvectionTerm(_rotation(ndim))
    dev = lsm.LevelSetEquation(terms=term, ic=ic, integrator=integrator).integrate(tf)
    steps = []
    host = lsm.LevelSetEquation(terms=term, ic=ic, integrator=integrator)
    host.integrate(tf, posthook=lambda eq: steps.append(eq.current_time))
    assert len(steps) >= 5
    assert dev.current_time == host.current_time == tf
    np.testing.assert_allclose(np.asarray(dev.current_state.values),
                               np.asarray(host.current_state.values), rtol=1e-12, atol=1e-13)
    if kind.startswith("band"):
        assert isinstance(dev.current_state, NarrowBandField)
        np.testing.assert_array_equal(np.asarray(dev.current_state.active_mask),
                                      np.asarray(host.current_state.active_mask))


@pytest.mark.parametrize("integrator", INTEGRATORS, ids=INTEGRATOR_IDS)
def test_rollout_matches_integrate_at_fixed_dt(integrator):
    """A rollout of n steps of dt lands where integrate lands when dt_max = dt
    binds every step."""
    grid, phi = _circle(2)
    term = lsm.AdvectionTerm(_rotation(2))
    dt = 0.2 * grid.min_spacing
    out, _ = lsm.rollout(integrator, (term,), phi, 0.0, dt, 6)
    eq = lsm.LevelSetEquation(terms=term, ic=phi, integrator=integrator)
    eq.integrate(6 * dt, dt_max=dt)
    np.testing.assert_allclose(np.asarray(out.values),
                               np.asarray(eq.current_state.values), rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("ndim", [2, 3])
def test_band_integrate_matches_dense_near_interface(ndim):
    grid, phi = _circle(ndim, n=40 if ndim == 2 else 20)
    term = lsm.AdvectionTerm(_rotation(ndim))
    tf = 0.3
    band = lsm.LevelSetEquation(terms=term, ic=NarrowBandField.from_field(phi),
                                integrator=lsm.RK3()).integrate(tf)
    dense = lsm.LevelSetEquation(terms=term, ic=phi, integrator=lsm.RK3()).integrate(tf)
    assert isinstance(band.current_state, NarrowBandField)
    assert _near_error(band.current_state, dense.current_state) < 1e-3


@pytest.mark.parametrize("ndim", [2, 3])
def test_band_update_func_matches_dense(ndim):
    """A state-dependent velocity (refreshed before the CFL bound and at every
    stage) gives the same near-interface evolution banded and dense."""
    grid, phi = _circle(ndim, n=40 if ndim == 2 else 20)
    base = lsm.sample(lambda *X: _rotation(ndim)(X, 0.0), grid, phi.bcs, vector=True)

    def update(vel, f, t):
        scale = 1.0 + 0.5 * jnp.tanh(jnp.mean(jnp.abs(f.values)))
        return base.with_values(base.values * scale)

    def term():
        return lsm.AdvectionTerm(base, update_func=update)

    tf = 0.2
    band = lsm.LevelSetEquation(terms=term(), ic=NarrowBandField.from_field(phi),
                                integrator=lsm.RK3()).integrate(tf)
    dense = lsm.LevelSetEquation(terms=term(), ic=phi, integrator=lsm.RK3()).integrate(tf)
    # the updated velocity persists on the equation (reference: mutated term)
    v0 = term().velocity.values
    assert float(jnp.abs(dense.terms[0].velocity.values - v0).max()) > 0
    # the band's mean |phi| sees frozen off-band values, so its scale differs a
    # little from the dense run's; the interface motion must still agree
    assert _near_error(band.current_state, dense.current_state) < 1e-2


@pytest.mark.parametrize("kind", ["dense-same-grid", "dense-new-grid", "band-new-grid"])
def test_state_reassignment_between_calls(kind):
    """Reassigning ``eq.state`` between ``integrate`` calls (a supported idiom)
    evolves the new state on its own grid, exactly as a fresh equation would."""
    grid, phi = _circle(2)
    term = lsm.AdvectionTerm(_rotation(2))
    eq = lsm.LevelSetEquation(terms=term, ic=phi, integrator=lsm.RK3())
    eq.integrate(0.05)

    if kind == "dense-same-grid":
        new = phi.with_values(phi.values * 0.5)
    else:
        grid2 = lsm.Grid((-2.0, -2.0), (2.0, 2.0), grid.shape)  # same shape, 2x spacing
        new = lsm.sample(lambda X, Y: jnp.sqrt(X**2 + Y**2) - 1.0, grid2, lsm.Extrapolation(2))
        if kind.startswith("band"):
            new = NarrowBandField.from_field(new)
    eq.state, eq.t = new, 0.0
    eq.integrate(0.1)
    fresh = lsm.LevelSetEquation(terms=term, ic=new, integrator=lsm.RK3()).integrate(0.1)
    assert eq.current_state.grid == new.grid
    np.testing.assert_allclose(np.asarray(eq.current_state.values),
                               np.asarray(fresh.current_state.values), rtol=1e-13, atol=1e-14)


def test_update_func_rollout_differentiable():
    """rollout() threads updated terms through the scan and stays
    differentiable (gradient against central finite differences)."""
    grid, base = _circle(2, n=16)
    dt = 0.3 * grid.min_spacing

    def update(vel, f, t):
        s = 1.0 + 0.1 * jnp.tanh(jnp.mean(jnp.abs(f.values)))
        return lsm.MeshField(vel.values * s, f.grid, f.bcs, _normalized=True)

    u = jnp.stack([jnp.full(grid.shape, 0.1), jnp.full(grid.shape, -0.05)])
    vel0 = lsm.MeshField(u, grid, base.bcs, _normalized=True)

    def loss(v):
        term = lsm.AdvectionTerm(vel0, update_func=update)
        out, terms = lsm.rollout(lsm.RK2(), (term,), base.with_values(v), 0.0, dt, 2)
        return jnp.sum(out.values ** 2) + jnp.sum(terms[0].velocity.values)

    v0 = base.values + jnp.asarray(np.random.default_rng(5).standard_normal(grid.shape)) * 1e-3
    g = jax.grad(loss)(v0)
    eps = 1e-6
    for ij in ((3, 4), (8, 8), (12, 2)):
        fd = (float(loss(v0.at[ij].add(eps))) - float(loss(v0.at[ij].add(-eps)))) / (2 * eps)
        assert abs(float(g[ij]) - fd) < 1e-5 * max(1.0, abs(fd))
