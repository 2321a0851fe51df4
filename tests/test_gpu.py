"""Parity on a GPU: the float32 stage and gradient against float64 on the card.

Marked ``gpu``; the ``gpu_device`` fixture skips them where JAX's first device
is not a GPU. Run on the card with
``LSM_GPU_TESTS=1 python -m pytest -m gpu tests/test_gpu.py``.
"""

import pytest
import jax
import jax.numpy as jnp

import lsm_tpu as lsm
from lsm_tpu.models import shapes

pytestmark = pytest.mark.gpu

N = 128


def _setup(dtype):
    grid = lsm.Grid((0.0,) * 3, (1.0,) * 3, (N,) * 3)
    phi = lsm.sample(shapes.zalesak_sphere(), grid, lsm.Periodic(), dtype=jnp.float32)
    term = lsm.AdvectionTerm(lambda xs, t: (0.5 - xs[1] + 0 * xs[0], xs[0] - 0.5 + 0 * xs[1],
                                            0 * xs[2]))
    return grid, phi.with_values(phi.values.astype(dtype)), term


def test_rk3_step_f32_matches_f64(gpu_device):
    out = {}
    for dtype in (jnp.float32, jnp.float64):
        grid, phi, term = _setup(dtype)
        dt = 0.25 * grid.min_spacing
        new, _ = lsm.step(lsm.RK3(), (term,), phi, 0.0, dt)
        out[dtype] = new.values
    assert out[jnp.float32].dtype == jnp.float32
    err = float(jnp.max(jnp.abs(out[jnp.float32].astype(jnp.float64) - out[jnp.float64])))
    assert err < 1e-6  # one step: a few f32 roundings of O(1) values


def test_rollout_gradient_f32_matches_f64(gpu_device):
    grads = {}
    for dtype in (jnp.float32, jnp.float64):
        grid, phi, term = _setup(dtype)
        h = grid.min_spacing

        def loss(v):
            out, _ = lsm.rollout(lsm.RK3(), (term,), phi.with_values(v), 0.0, 0.25 * h, 4)
            return jnp.sum(lsm.smooth_heaviside(-out.values, h) ** 2)

        grads[dtype] = jax.grad(loss)(phi.values)
    g32, g64 = grads[jnp.float32].astype(jnp.float64), grads[jnp.float64]
    assert bool(jnp.all(jnp.isfinite(g32)))
    err = float(jnp.linalg.norm(g32 - g64) / jnp.linalg.norm(g64))
    assert err < 1e-3, err  # hand adjoint; plain f32 autodiff is order-1 off here
