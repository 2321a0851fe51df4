"""Benchmark of the public path on one GPU: forward, gradient and narrow band.

Times three things at ``BENCH_N``^3 (default 512) in float32, each after one
warm-up call, each ending in ``block_until_ready``:

- ``forward``: ``LevelSetEquation.integrate`` of the 3D Zalesak sphere with
  WENO5 advection and forward Euler, ``BENCH_STEPS`` adaptive steps (default
  30), the velocity streamed from device memory as a field. Its minimum device
  memory traffic is 20 B per cell-update (read phi 4 B and three velocity
  components 12 B, write phi 4 B), so ``vs_roofline`` is the rate over
  ``hbm_bytes_per_s / 20``.
- ``grad_step``: ``jax.value_and_grad`` of a sum-of-squares loss through
  ``lsm.rollout`` (forward Euler, same problem), per step.
- ``band``: the 3-layer narrow band of a sphere through ``integrate``.

Prints one JSON line naming the platform, ``device_kind``, device count and
the card's name and power limit. Fails without a GPU, and on a device that is
not in ``PEAKS``.
"""

import json
import os
import subprocess
import time

import jax
import jax.numpy as jnp

import lsm_tpu as lsm
from lsm_tpu.models import shapes
from lsm_tpu.platform import require_gpu, use_compile_cache

#: published peaks by ``device_kind``: NVIDIA H100 SXM data sheet (dense rates,
#: no sparsity; float32 outside the tensor cores)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12},
}

BYTES_PER_CELL_UPDATE = 20.0


def _peaks(dev):
    if dev.device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {dev.device_kind!r}")
    return PEAKS[dev.device_kind]


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()


def _zalesak(n):
    grid = lsm.Grid((0.0,) * 3, (1.0,) * 3, (n,) * 3)
    phi = lsm.sample(shapes.zalesak_sphere(), grid, lsm.Periodic(), dtype=jnp.float32)
    vel = lsm.sample(lambda X, Y, Z: (0.5 - Y + 0.0 * (X + Z), X - 0.5 + 0.0 * (Y + Z),
                                      0.0 * (X + Y + Z)),
                     grid, vector=True, dtype=jnp.float32)
    return grid, phi, lsm.AdvectionTerm(vel)


def _end_time(term, phi, integrator, nsteps):
    """``tf`` reached in ``nsteps`` adaptive steps (steady velocity, so the CFL
    step never changes; the last step is a half step)."""
    return (nsteps - 0.5) * integrator.cfl * float(lsm.compute_cfl((term,), phi, 0.0))


def _time_integrate(term, ic, integrator, tf):
    def run():
        eq = lsm.LevelSetEquation(terms=term, ic=ic, integrator=integrator)
        t0 = time.perf_counter()
        eq.integrate(tf)
        jax.block_until_ready(eq.state.values)
        return time.perf_counter() - t0

    run()  # compile
    return run()


def bench_forward(n, steps, peaks):
    grid, phi, term = _zalesak(n)
    integrator = lsm.ForwardEuler()
    elapsed = _time_integrate(term, phi, integrator, _end_time(term, phi, integrator, steps))
    rate = float(grid.num_nodes) * steps / elapsed
    return {"step_ms": elapsed / steps * 1e3, "cell_updates_per_s": rate,
            "vs_roofline": rate / (peaks["hbm_bytes_per_s"] / BYTES_PER_CELL_UPDATE)}


def bench_grad(n, steps):
    grid, phi, term = _zalesak(n)
    dt = lsm.ForwardEuler().cfl * float(lsm.compute_cfl((term,), phi, 0.0))

    def loss(values, vel_values):
        t = lsm.AdvectionTerm(term.velocity.with_values(vel_values))
        out, _ = lsm.rollout(lsm.ForwardEuler(), (t,), phi.with_values(values), 0.0, dt,
                             steps)
        return jnp.sum(out.values ** 2)

    vg = jax.jit(jax.value_and_grad(loss))
    args = (phi.values, term.velocity.values)
    jax.block_until_ready(vg(*args))  # compile
    t0 = time.perf_counter()
    jax.block_until_ready(vg(*args))
    elapsed = time.perf_counter() - t0
    return {"step_ms": elapsed / steps * 1e3,
            "cell_updates_per_s": float(grid.num_nodes) * steps / elapsed}


def bench_band(n, steps):
    grid = lsm.Grid((-1.0,) * 3, (1.0,) * 3, (n,) * 3)
    phi = lsm.sample(lambda X, Y, Z: jnp.sqrt(X**2 + Y**2 + Z**2) - 0.5, grid,
                     lsm.Extrapolation(2), dtype=jnp.float32)
    nb = lsm.NarrowBandField.from_field(phi, nlayers=3)
    term = lsm.AdvectionTerm(lambda xs, t: (-xs[1] + 0.0 * xs[0], xs[0] + 0.0 * xs[1],
                                            0.0 * xs[2]))
    integrator = lsm.ForwardEuler()
    elapsed = _time_integrate(term, nb, integrator, _end_time(term, nb, integrator, steps))
    return {"step_ms": elapsed / steps * 1e3, "band_nodes": int(nb.active_count())}


def main():
    dev = require_gpu()
    use_compile_cache()
    peaks = _peaks(dev)
    n = int(os.environ.get("BENCH_N", "512"))
    steps = int(os.environ.get("BENCH_STEPS", "30"))
    forward = bench_forward(n, steps, peaks)
    result = {
        "metric": f"cell-updates/s ({n}^3 WENO5 advection, forward Euler, integrate)",
        "value": forward["cell_updates_per_s"],
        "unit": "cell-updates/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": _card()},
        "forward": forward,
        "grad_step": bench_grad(n, max(3, steps // 3)),
        "band": bench_band(n, steps),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
