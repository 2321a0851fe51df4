"""Interpolation / Bernstein / NewtonSDF oracles.

Mirrors reference ``test/test-interpolation.jl`` (Bernstein closed forms,
h-convergence at order k => O(h^(k+1))) and ``test/test-reinitializer.jl``
(NewtonSDF spot checks and global accuracy, ``reinitialize!`` accuracy and
h-convergence at order k => observed order >= k + 0.5).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from lsm_tpu import (
    Extrapolation,
    Grid,
    InterpolatedField,
    NewtonSDF,
    hausdorff_distance,
    reinitialize_newton,
    sample,
    volume,
)
from lsm_tpu.interp.bernstein import (
    bernstein_bounds,
    bernstein_derivative,
    bernstein_eval,
    bernstein_face,
    bernstein_split,
)
from conftest import convergence_orders


def test_bernstein_closed_form():
    # 1D: coefficients (0, 0, 1) on [0,1] is B_2^2(t) = t^2
    c = jnp.asarray([0.0, 0.0, 1.0])
    for t in (0.0, 0.3, 0.5, 1.0):
        assert np.isclose(float(bernstein_eval(c, (0.0,), (1.0,), (t,))), t**2)
    # on [1, 3]: t -> (x-1)/2
    assert np.isclose(float(bernstein_eval(c, (1.0,), (3.0,), (2.0,))), 0.25)
    # 2D tensor product: c[i,j] = i-th x basis only => p(x,y) = x * y on unit box
    c2 = jnp.asarray([[0.0, 0.0], [0.0, 1.0]])
    for x, y in [(0.2, 0.7), (1.0, 1.0), (0.0, 0.9)]:
        assert np.isclose(float(bernstein_eval(c2, (0.0, 0.0), (1.0, 1.0), (x, y))), x * y)


def test_bernstein_derivative_split_face():
    c = jnp.asarray([1.0, 4.0, 2.0])  # quadratic on [0,2]
    lo, hi = (0.0,), (2.0,)
    d = bernstein_derivative(c, 1, 0, lo, hi)
    # derivative of the Bernstein curve: value check against autodiff at points
    import jax

    f = lambda x: bernstein_eval(c, lo, hi, x)
    for t in (0.1, 0.9, 1.7):
        got = float(bernstein_eval(d, lo, hi, (t,)))
        ref = float(jax.grad(lambda x: f((x,)))(t))
        assert np.isclose(got, ref), (got, ref)
    # split: halves agree with the parent on their sub-boxes
    left, right = bernstein_split(c, 1, 0, 0.5)
    assert np.isclose(
        float(bernstein_eval(left, (0.0,), (1.0,), (0.6,))), float(f((0.6,)))
    )
    assert np.isclose(
        float(bernstein_eval(right, (1.0,), (2.0,), (1.4,))), float(f((1.4,)))
    )
    # face restriction in 2D
    c2 = jnp.asarray([[1.0, 2.0], [3.0, 4.0]])
    face = bernstein_face(c2, 2, 0, 0)  # x = lo face -> coefficients [1, 2]
    assert np.allclose(np.asarray(face), [1.0, 2.0])
    # bounds
    m, M = bernstein_bounds(c2, 2)
    assert float(m) == 1.0 and float(M) == 4.0


def test_interpolation_exact_on_polynomials():
    # degree-k interpolation reproduces degree-k polynomials exactly
    grid = Grid((-0.3, 0.5), (1.7, 2.1), (12, 10))
    for order in (1, 2, 3):
        phi = sample(lambda X, Y: (X**order + Y**order + X * Y**(order - 1)), grid,
                     Extrapolation(order))
        cf = InterpolatedField(phi, order)
        pts = np.random.default_rng(0).uniform([-0.3, 0.5], [1.7, 2.1], (50, 2))
        vals = np.asarray(cf(jnp.asarray(pts)))
        exact = pts[:, 0] ** order + pts[:, 1] ** order + pts[:, 0] * pts[:, 1] ** (order - 1)
        assert np.abs(vals - exact).max() < 1e-10, order


def test_interpolation_h_convergence():
    # smooth non-polynomial field: order-k interpolation converges O(h^(k+1))
    ns = [16, 32, 64]
    rng = np.random.default_rng(42)
    pts = rng.uniform(-0.8, 0.8, (200, 2))
    f = lambda X, Y: jnp.sin(2 * X) * jnp.cos(Y) + 0.3 * X * Y
    exact = np.sin(2 * pts[:, 0]) * np.cos(pts[:, 1]) + 0.3 * pts[:, 0] * pts[:, 1]
    for order in (2, 3):
        errors = []
        for n in ns:
            grid = Grid((-1.0, -1.0), (1.0, 1.0), (n, n))
            cf = InterpolatedField(sample(f, grid, Extrapolation(order)), order)
            vals = np.asarray(cf(jnp.asarray(pts)))
            errors.append(np.abs(vals - exact).max())
        assert min(convergence_orders(errors, ns)) >= order + 0.5, (order, errors)


def test_interpolation_gradient_hessian():
    grid = Grid((-1.0, -1.0), (1.0, 1.0), (40, 40))
    cf = InterpolatedField(sample(lambda X, Y: X**2 + 3 * X * Y, grid, Extrapolation(2)), 2)
    pt = jnp.asarray([0.21, -0.37])
    v, g = cf.value_and_gradient(pt)
    x, y = 0.21, -0.37
    assert np.isclose(float(v), x**2 + 3 * x * y, atol=1e-10)
    assert np.allclose(np.asarray(g), [2 * x + 3 * y, 3 * x], atol=1e-9)
    v2, g2, H = cf.value_gradient_hessian(pt)
    assert np.allclose(np.asarray(H), [[2.0, 3.0], [3.0, 0.0]], atol=1e-7)


def test_proven_empty():
    grid = Grid((-1.0, -1.0), (1.0, 1.0), (21, 21))
    cf = InterpolatedField(sample(lambda X, Y: jnp.sqrt(X**2 + Y**2) - 0.5, grid, Extrapolation(2)), 2)
    empty_surface = np.asarray(cf.proven_empty(surface=True))
    # cells near the interface are not provably empty; far cells are
    centers_x, centers_y = np.meshgrid(
        np.linspace(-1, 1, 21)[:-1] + 0.05, np.linspace(-1, 1, 21)[:-1] + 0.05, indexing="ij"
    )
    r = np.sqrt(centers_x**2 + centers_y**2)
    assert not empty_surface[np.abs(r - 0.5) < 0.05].any()
    assert empty_surface[np.abs(r - 0.5) > 0.3].all()
    # no-interior test
    empty_interior = np.asarray(cf.proven_empty(surface=False))
    assert not empty_interior[r < 0.3].any()
    assert empty_interior[r > 0.8].all()


def test_newton_sdf_2d_circle():
    grid = Grid((-1.0, -1.0), (1.0, 1.0), (50, 50))
    r = 0.5
    phi = sample(lambda X, Y: jnp.sqrt(X**2 + Y**2) - r, grid)
    sdf = NewtonSDF(phi, upsample=4)
    assert np.isclose(float(sdf(jnp.asarray([0.0, 0.0]))), -r, atol=2e-5)
    assert np.isclose(float(sdf(jnp.asarray([r, 0.0]))), 0.0, atol=2e-5)
    assert np.isclose(float(sdf(jnp.asarray([1.0, 0.0]))), 1 - r, atol=2e-5)
    # global accuracy over a subsample of grid nodes
    X, Y = [np.asarray(c) for c in grid.dense_coords()]
    nodes = np.stack([X.ravel(), Y.ravel()], -1)[::10]
    vals = np.asarray(sdf(jnp.asarray(nodes)))
    exact = np.sqrt(nodes[:, 0] ** 2 + nodes[:, 1] ** 2) - r
    assert np.abs(vals - exact).max() < 1e-5


def test_newton_sdf_3d_sphere():
    grid = Grid((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), (25, 25, 25))
    r = 0.45
    phi = sample(lambda X, Y, Z: jnp.sqrt(X**2 + Y**2 + Z**2) - r, grid)
    sdf = NewtonSDF(phi, upsample=3)
    assert np.isclose(float(sdf(jnp.asarray([r, 0.0, 0.0]))), 0.0, atol=1e-4)
    assert np.isclose(float(sdf(jnp.asarray([0.0, 0.0, 0.0]))), -r, atol=1e-4)
    X, Y, Z = [np.asarray(c) for c in grid.dense_coords()]
    nodes = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1)[::20]
    vals = np.asarray(sdf(jnp.asarray(nodes)))
    exact = np.sqrt((nodes**2).sum(-1)) - r
    assert np.abs(vals - exact).max() < 5e-3


def test_newton_sdf_samples_on_interface():
    grid = Grid((-1.0, -1.0), (1.0, 1.0), (20, 20))
    phi = sample(lambda X, Y: jnp.sqrt(X**2 + Y**2) - 0.5, grid)
    sdf = NewtonSDF(phi, upsample=3)
    pts, valid = sdf.sample_points()
    assert int(valid.sum()) > 0
    resid = np.abs(np.asarray(sdf.cf(pts)))[np.asarray(valid)]
    assert resid.max() < 1e-6


def test_reinitialize_newton_2d():
    # reference: phi = x^2+y^2-0.25 -> exact SDF within ~solver tolerance
    grid = Grid((-1.0, -1.0), (1.0, 1.0), (100, 100))
    phi = sample(lambda X, Y: (X**2 + Y**2) - 0.25, grid)
    assert abs(float(volume(phi)) - np.pi / 4) < 1e-2
    out = reinitialize_newton(phi)
    X, Y = [np.asarray(c) for c in grid.dense_coords()]
    exact = np.sqrt(X**2 + Y**2) - 0.5
    err = np.abs(np.asarray(out.values) - exact).max()
    assert err < 1e-4, err
    assert abs(float(volume(out)) - np.pi / 4) < 1e-2


def test_reinitialize_newton_h_convergence():
    r = 0.5
    ns = [20, 40, 80]
    for order in (2, 3):
        errors = []
        for n in ns:
            grid = Grid((-1.0, -1.0), (1.0, 1.0), (n, n))
            phi = sample(
                lambda X, Y: jnp.sqrt(X**2 + Y**2) - r, grid, Extrapolation(order)
            )
            out = reinitialize_newton(phi, order=order, upsample=6)
            X, Y = [np.asarray(c) for c in grid.dense_coords()]
            exact = np.sqrt(X**2 + Y**2) - r
            errors.append(np.abs(np.asarray(out.values) - exact).max())
        orders = convergence_orders(errors, ns)
        assert min(orders) >= order + 0.5, (order, errors, orders)


def test_hausdorff_distance():
    grid = Grid((-1.0, -1.0), (1.0, 1.0), (60, 60))
    s1 = NewtonSDF(sample(lambda X, Y: jnp.sqrt(X**2 + Y**2) - 0.5, grid))
    s2 = NewtonSDF(sample(lambda X, Y: jnp.sqrt(X**2 + Y**2) - 0.4, grid))
    d = float(hausdorff_distance(s1, s2))
    assert np.isclose(d, 0.1, atol=2e-3)


def test_lazy_matches_eager():
    # lazy on-demand coefficients must equal the eager all-cell table
    grid = Grid((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), (14, 12, 10))
    phi = sample(
        lambda X, Y, Z: jnp.sin(X) * jnp.cos(Y) + 0.3 * Z**2, grid, Extrapolation(3)
    )
    eager = InterpolatedField(phi, 3, lazy=False)
    lazy = InterpolatedField(phi, 3, lazy=True)
    assert lazy.is_lazy and not eager.is_lazy
    rng = np.random.default_rng(7)
    pts = jnp.asarray(rng.uniform(-0.99, 0.99, size=(200, 3)))
    np.testing.assert_allclose(
        np.asarray(lazy(pts)), np.asarray(eager(pts)), atol=1e-13
    )
    ve, ge, He = eager.value_gradient_hessian(pts)
    vl, gl, Hl = lazy.value_gradient_hessian(pts)
    np.testing.assert_allclose(np.asarray(gl), np.asarray(ge), atol=1e-12)
    np.testing.assert_allclose(np.asarray(Hl), np.asarray(He), atol=1e-10)
    # all-cell extrema (chunked in the lazy path) agree
    ml, Ml = lazy.cell_extrema(chunk=64)
    me, Me = eager.cell_extrema()
    np.testing.assert_allclose(np.asarray(ml), np.asarray(me), atol=1e-13)
    np.testing.assert_allclose(np.asarray(Ml), np.asarray(Me), atol=1e-13)


def test_newton_sdf_lazy_and_chunked_queries():
    # force the lazy interpolant + multi-chunk closest_point path
    grid = Grid((-1.0, -1.0), (1.0, 1.0), (60, 60))
    r = 0.5
    phi = sample(lambda X, Y: jnp.sqrt(X**2 + Y**2) - r, grid)
    old = InterpolatedField.LAZY_THRESHOLD
    InterpolatedField.LAZY_THRESHOLD = 0  # force lazy
    try:
        sdf = NewtonSDF(phi, upsample=3)
        assert sdf.cf.is_lazy
        X, Y = [np.asarray(c) for c in grid.dense_coords()]
        nodes = jnp.asarray(np.stack([X.ravel(), Y.ravel()], -1))
        vals = np.asarray(sdf.closest_point(nodes, chunk=512)[0])
        exact_cp = nodes / jnp.linalg.norm(nodes, axis=-1, keepdims=True) * r
        err = np.abs(vals - np.asarray(exact_cp)).max()
        assert err < 1e-4
    finally:
        InterpolatedField.LAZY_THRESHOLD = old


def test_newton_sdf_jittable_build_matches_host_build():
    """max_cut_cells makes the whole NewtonSDF construction traceable
    (capacity-bounded cut-cell gather), so the high-order
    reinit can run inside compiled evolutions. The jitted build must equal
    the host build exactly when the capacity suffices."""
    import jax

    from lsm_tpu import (Extrapolation, Grid, reinitialize_newton, sample)

    grid = Grid((-1.0, -1.0), (1.0, 1.0), (32, 32))
    phi = sample(
        lambda X, Y: (jnp.sqrt(X**2 + Y**2) - 0.5) * (1.2 + 0.3 * jnp.sin(2 * X)),
        grid, Extrapolation(2),
    )
    host = reinitialize_newton(phi, order=3)

    @jax.jit
    def build(values):
        return reinitialize_newton(
            phi.with_values(values), order=3, max_cut_cells=300).values

    out = build(phi.values)
    np.testing.assert_allclose(np.asarray(out), np.asarray(host.values),
                               rtol=0, atol=1e-13)


def test_jump_flood_seed_matches_brute_force_nearest():
    """The jump-flood seed grid's best candidate must be (near-)optimal: its
    distance to the query may exceed the true nearest-sample distance only by
    the one-node flood approximation (the replacement for the reference
    KDTree, sdf.jl:71-73)."""
    import numpy as np

    from lsm_tpu.interp.sdf import NewtonSDF

    grid = Grid((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), (21, 21, 21))
    phi = sample(lambda X, Y, Z: jnp.sqrt(X**2 + Y**2 + Z**2) - 0.55, grid)
    sdf = NewtonSDF(phi, upsample=2)
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.uniform(-1, 1, size=(512, 3)))
    # brute force truth
    S = np.asarray(sdf.samples)[np.asarray(sdf.valid)]
    d_true = np.sqrt(((np.asarray(q)[:, None, :] - S[None]) ** 2).sum(-1)).min(1)
    cand = np.asarray(sdf._nearest_seed_positions(q, k=1))[:, 0, :]
    d_jfa = np.sqrt(((np.asarray(q) - cand) ** 2).sum(-1))
    h = float(max(grid.spacing))
    assert (d_jfa <= d_true + 1.5 * h).all()
    # for queries near the interface the seed should be essentially optimal
    near = d_true < 3 * h
    assert (d_jfa[near] <= d_true[near] + 1.0 * h).all()
