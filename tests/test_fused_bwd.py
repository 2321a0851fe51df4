"""The WENO5 advection Hamiltonian's fused forward/backward (hand adjoint).

``stencils.weno5_upwind_fwd_bwd`` computes the Hamiltonian and its cotangents in
one pass; ``stencils.weno5_advection`` wraps it as a ``jax.custom_vjp`` and is
what ``AdvectionTerm`` evaluates, so every gradient through ``rollout`` uses it.
Oracles: the plain-autodiff composite ``weno5_advection_plain`` in float64,
central finite differences, and the float64 gradient for float32 runs (where
plain autodiff is wrong by order 1 at cells whose smoothness indicators tie).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import lsm_tpu as lsm
from lsm_tpu.core.narrowband import NarrowBandField
from lsm_tpu.models import shapes
from lsm_tpu.ops import stencils as st
from lsm_tpu.terms.terms import _eval_vector_field

INTEGRATORS = [lsm.ForwardEuler(), lsm.RK2(), lsm.RK3()]
INTEGRATOR_IDS = ["fe", "rk2", "rk3"]


@jax.tree_util.register_pytree_node_class
class _AutodiffAdvection(lsm.AdvectionTerm):
    """The WENO5 advection term with the plain-autodiff backward."""

    def rhs(self, phi, t):
        p = phi.pad(self.pad_width)
        u = _eval_vector_field(self.velocity, phi, t)
        return st.weno5_advection_plain(p, u, tuple(phi.spacing), tuple(phi.shape))


def _padded_and_velocity(ndim, dtype=jnp.float64):
    if ndim == 2:
        grid = lsm.Grid((0.0, 0.0), (1.0, 1.0), (24, 20))
        phi = lsm.sample(shapes.zalesak_disk(), grid, lsm.Periodic(), dtype=dtype)
        vel = lsm.sample(lambda X, Y: (0.5 - Y + 0 * X, X - 0.5 + 0 * Y), grid,
                         vector=True, dtype=dtype)
    else:
        grid = lsm.Grid((0.0,) * 3, (1.0,) * 3, (12, 10, 14))
        phi = lsm.sample(shapes.zalesak_sphere(), grid, lsm.Extrapolation(1), dtype=dtype)
        vel = lsm.sample(lambda X, Y, Z: (0.5 - Y + 0 * (X + Z), X - 0.5 + 0 * (Y + Z),
                                          0.1 + 0 * (X + Y + Z)),
                         grid, vector=True, dtype=dtype)
    u = tuple(vel.values[d] for d in range(ndim))
    return grid, phi.pad(st.PAD_WENO5), u


@pytest.mark.parametrize("ndim", [2, 3])
def test_forward_equals_plain_composite(ndim):
    grid, p, u = _padded_and_velocity(ndim)
    args = (tuple(grid.spacing), tuple(grid.shape))
    hand = st.weno5_advection(p, u, *args)
    plain = st.weno5_advection_plain(p, u, *args)
    np.testing.assert_array_equal(np.asarray(hand), np.asarray(plain))
    # and the per-axis fused forward/backward returns the same value
    g = jnp.ones(grid.shape)
    H = sum(st.weno5_upwind_fwd_bwd(st.weno5_pair_diffs(p, ax, h, 3, grid.shape),
                                    u[ax], g)[0]
            for ax, h in enumerate(grid.spacing))
    np.testing.assert_allclose(np.asarray(H), np.asarray(plain), rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("ndim", [2, 3])
def test_vjp_matches_autodiff_f64(ndim):
    """Cotangents of the padded field AND of every velocity component."""
    grid, p, u = _padded_and_velocity(ndim)
    args = (tuple(grid.spacing), tuple(grid.shape))
    g = jnp.asarray(np.random.default_rng(3).standard_normal(grid.shape))
    _, vh = jax.vjp(lambda pp, uu: st.weno5_advection(pp, uu, *args), p, u)
    _, va = jax.vjp(lambda pp, uu: st.weno5_advection_plain(pp, uu, *args), p, u)
    for a, b in zip(jax.tree_util.tree_leaves(vh(g)), jax.tree_util.tree_leaves(va(g))):
        scale = float(jnp.abs(b).max())
        assert scale > 0
        assert float(jnp.abs(a - b).max()) < 1e-11 * scale


@pytest.mark.parametrize("ndim", [2, 3])
def test_slabbed_backward_matches_one_block(ndim, monkeypatch):
    """The backward scans over axis-0 slabs (bounded temporaries on large
    grids); with several slabs the overlapping halo rows must add up to the
    one-slab result, for both the padded-field and the velocity cotangents."""
    grid, p, u = _padded_and_velocity(ndim)
    args = (tuple(grid.spacing), tuple(grid.shape))
    g = jnp.asarray(np.random.default_rng(4).standard_normal(grid.shape))

    def cotangents():
        _, vjp = jax.vjp(lambda pp, uu: st.weno5_advection(pp, uu, *args), p, u)
        return jax.tree_util.tree_leaves(vjp(g))

    whole = cotangents()
    row = int(np.prod(grid.shape[1:]))
    monkeypatch.setattr(st, "BWD_SLAB_CELLS", 4 * row)
    assert st._slab_rows(grid.shape) == 4
    for a, b in zip(cotangents(), whole):
        # same terms, summed in another order where halos overlap
        scale = float(jnp.abs(b).max())
        assert float(jnp.abs(a - b).max()) < 1e-12 * scale


def test_hand_backward_f32_accuracy_at_tie_cells():
    """Pinned: at WENO-symmetric cells (|v1| == |v5|
    etc. — ubiquitous on smooth radial fields) the f32 AUTODIFF backward of
    ``weno5_upwind`` is wrong by order 1 (the eps-path multiplies a
    catastrophically-cancelled ``dr`` by ``r^2 ~ 1e21``), while the hand
    backward (``weno5_upwind_fwd_bwd``) matches the f64 ground truth. Both
    agree exactly in f64 (also asserted)."""
    dmv = [0.00313568115234375, 0.003143310546875, 0.00313568115234375, 0.0,
           -0.00313568115234375, -0.003143310546875]
    gv = 1.2142245769500732

    def run(dtype):
        dm = [jnp.asarray([v], dtype) for v in dmv]
        u = jnp.asarray([-0.5], dtype)
        g = jnp.asarray([gv], dtype)
        _, vjp = jax.vjp(lambda d: st.weno5_upwind(d, u), tuple(dm))
        ddm_ad = vjp(g)[0]
        _, ddm_hand, _ = st.weno5_upwind_fwd_bwd(dm, u, g)
        return (np.array([float(d[0]) for d in ddm_ad]),
                np.array([float(d[0]) for d in ddm_hand]))

    ad64, hand64 = run(jnp.float64)
    np.testing.assert_allclose(hand64, ad64, rtol=1e-10, atol=1e-14)

    ad32, hand32 = run(jnp.float32)
    scale = np.abs(ad64).max()
    assert np.abs(hand32 - ad64).max() < 1e-2 * scale  # hand f32 ~ truth
    assert np.abs(ad32 - ad64).max() > scale  # f32 autodiff: order-1 wrong


# -- gradients through rollout ---------------------------------------------------------


def _setup(band, dtype=jnp.float64):
    grid = lsm.Grid((-1.0, -1.0), (1.0, 1.0), (20, 20))
    rng = np.random.default_rng(7)
    base = lsm.sample(lambda X, Y: jnp.sqrt((X + 0.013) ** 2 + (Y - 0.021) ** 2) - 0.493,
                      grid, lsm.Extrapolation(1), dtype=dtype)
    values = base.values + jnp.asarray(rng.standard_normal(grid.shape), dtype) * 1e-3
    vel = lsm.sample(lambda X, Y: (-Y + 0.1 + 0 * X, X + 0 * Y), grid, vector=True,
                     dtype=dtype)

    def field(v):
        if band:
            return NarrowBandField(v, grid, base.bcs, nlayers=3, _normalized=True)
        return base.with_values(v)

    return grid, field, values, vel


def _loss_fn(integrator, band, term_cls=lsm.AdvectionTerm, nsteps=3, dtype=jnp.float64):
    grid, field, values, vel = _setup(band, dtype)
    dt = 0.3 * grid.min_spacing

    def loss(v, u):
        term = term_cls(vel.with_values(u))
        out, _ = lsm.rollout(integrator, (term,), field(v), 0.0, dt, nsteps)
        return jnp.sum(out.values ** 2)

    return loss, values, vel.values


@pytest.mark.parametrize("band", [False, True], ids=["dense", "band"])
@pytest.mark.parametrize("integrator", INTEGRATORS, ids=INTEGRATOR_IDS)
def test_rollout_gradient_matches_finite_differences(integrator, band):
    loss, v0, u0 = _loss_fn(integrator, band)
    gv, gu = jax.jit(jax.grad(loss, argnums=(0, 1)))(v0, u0)
    rng = np.random.default_rng(0)
    eps = 1e-6
    for x0, g, which in ((v0, gv, 0), (u0, gu, 1)):
        for _ in range(3):
            ij = tuple(int(rng.integers(0, s)) for s in x0.shape)
            up = x0.at[ij].add(eps)
            dn = x0.at[ij].add(-eps)
            args_up = (up, u0) if which == 0 else (v0, up)
            args_dn = (dn, u0) if which == 0 else (v0, dn)
            fd = (float(loss(*args_up)) - float(loss(*args_dn))) / (2 * eps)
            assert abs(float(g[ij]) - fd) < 1e-5 * max(1.0, abs(fd)), (which, ij)


@pytest.mark.parametrize("band", [False, True], ids=["dense", "band"])
@pytest.mark.parametrize("integrator", INTEGRATORS, ids=INTEGRATOR_IDS)
def test_rollout_gradient_matches_f64_autodiff(integrator, band):
    """f64: the hand adjoint and plain autodiff give the same gradient (tie-free
    data); f32 with the hand adjoint stays close to that f64 gradient."""
    loss_h, v0, u0 = _loss_fn(integrator, band)
    loss_a, _, _ = _loss_fn(integrator, band, term_cls=_AutodiffAdvection)
    gh = jax.grad(loss_h, argnums=(0, 1))(v0, u0)
    ga = jax.grad(loss_a, argnums=(0, 1))(v0, u0)
    for a, b in zip(gh, ga):
        scale = float(jnp.abs(b).max())
        assert scale > 0
        assert float(jnp.abs(a - b).max()) < 1e-11 * scale

    loss32, _, _ = _loss_fn(integrator, band, dtype=jnp.float32)
    g32 = jax.grad(loss32, argnums=(0, 1))(v0.astype(jnp.float32), u0.astype(jnp.float32))
    for a, b in zip(g32, ga):
        assert a.dtype == jnp.float32
        err = float(jnp.linalg.norm(a.astype(jnp.float64) - b) / jnp.linalg.norm(b))
        assert err < 1e-4, err


def test_f32_rollout_gradient_uses_hand_adjoint():
    """On a radial field (WENO indicators tie around the circle) the f32
    rollout gradient matches f64 only through the hand adjoint; with the
    plain-autodiff backward the same check fails. Guards ``AdvectionTerm``
    against being switched back to autodiff."""
    grid = lsm.Grid((-1.0, -1.0), (1.0, 1.0), (32, 32))
    h = grid.min_spacing

    def grad(term_cls, dtype):
        phi = lsm.sample(lambda X, Y: jnp.sqrt(X**2 + Y**2) - 0.5, grid,
                         lsm.Extrapolation(1), dtype=dtype)
        term = term_cls(lambda xs, t: (-xs[1] + 0.3 + 0 * xs[0], xs[0] + 0 * xs[1]))

        def loss(v):
            out, _ = lsm.rollout(lsm.RK3(), (term,), phi.with_values(v), 0.0,
                                 0.3 * h, 4)
            return jnp.sum(lsm.smooth_heaviside(-out.values, h) ** 2)

        return np.asarray(jax.grad(loss)(phi.values), np.float64)

    ref = grad(_AutodiffAdvection, jnp.float64)
    err = lambda g: (np.linalg.norm(g - ref) / np.linalg.norm(ref)
                     if np.isfinite(g).all() else np.inf)
    assert err(grad(lsm.AdvectionTerm, jnp.float32)) < 1e-3
    assert err(grad(_AutodiffAdvection, jnp.float32)) > 1e-3


@pytest.mark.parametrize("which", ["forward", "gradient"])
def test_flat_region_f32_no_nan(which):
    """A uniform field makes every WENO stencil flat: zero Hamiltonian, and a
    finite (zero) gradient, in float32."""
    grid = lsm.Grid((0.0, 0.0), (1.0, 1.0), (16, 16))
    phi = lsm.sample(lambda X, Y: 0.0 * X + 0.0 * Y + 1.0, grid, lsm.Periodic(),
                     dtype=jnp.float32)
    term = lsm.AdvectionTerm(lambda xs, t: (1.0 + 0 * xs[0], -1.0 + 0 * xs[1]))
    if which == "forward":
        out = term.rhs(phi, 0.0)
        assert out.dtype == jnp.float32
        assert bool(jnp.all(jnp.isfinite(out)))
        assert float(jnp.abs(out).max()) < 1e-6
    else:
        def loss(v):
            out, _ = lsm.rollout(lsm.RK3(), (term,), phi.with_values(v), 0.0, 0.01, 2)
            return jnp.sum(out.values ** 2)

        g = jax.grad(loss)(phi.values)
        assert bool(jnp.all(jnp.isfinite(g)))


@pytest.mark.parametrize("integrator", INTEGRATORS, ids=INTEGRATOR_IDS)
def test_rollout_remat_gradients_match(integrator):
    """Step-level rematerialization is value- and gradient-neutral: plain,
    per-step remat and chunked two-level remat give the same gradient."""
    grid, field, v0, vel = _setup(band=False)
    term = lsm.AdvectionTerm(vel)
    dt = 0.3 * grid.min_spacing

    def grad_with(remat, remat_chunk=None):
        def loss(v):
            out, _ = lsm.rollout(integrator, (term,), field(v), 0.0, dt, 5,
                                 remat=remat, remat_chunk=remat_chunk)
            return jnp.sum(out.values ** 2)

        return jax.grad(loss)(v0)

    g_plain = grad_with(False)
    scale = max(float(jnp.abs(g_plain).max()), 1.0)
    assert float(jnp.abs(g_plain).max()) > 0
    for g in (grad_with(True), grad_with(True, remat_chunk=2)):
        assert float(jnp.abs(g - g_plain).max()) < 1e-12 * scale
