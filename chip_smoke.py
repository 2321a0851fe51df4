"""Smoke test of the level-set engine on an NVIDIA GPU, at production size.

Drives the public entry points in float32 and checks every result against a
plain reference. One process, one card (``--four``: four cards):

1. dense    — 3D Zalesak sphere, WENO5 + RK3, periodic BCs, rigid rotation,
              512^3, 20 adaptive CFL steps through ``LevelSetEquation.integrate``.
              Reference: the same run in float64 on the card.
2. band     — sphere of radius 0.5 on [-1,1]^3 at 512^3, ``Extrapolation(2)``,
              a 3-layer ``NarrowBandField`` through ``integrate``. Reference: the
              dense run of the same problem, near the interface.
3. gradient — ``jax.value_and_grad`` through ``lsm.rollout`` (RK3, 8 steps,
              remat) at 512^3. Reference: the float64 gradient of the same
              rollout. Plus, at 64^3, the hand-derived WENO5 adjoint against
              plain float32 autodiff at tie cells.

``--four`` runs only the sharded path on a 4-card mesh (``make_mesh(4)``):
``make_sharded_evolve`` on a 1024x512x512 grid, dense and banded, and a sharded
differentiable rollout, each against the single-card run of the same problem.

Usage::

    python chip_smoke.py          # one GPU
    python chip_smoke.py --four   # four GPUs, sharded phases only

Every check raises on failure. The last line of stdout is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a GPU the script raises before printing any result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np

N = 512  # grid edge of the one-card phases
NSTEPS = 20  # adaptive steps of the integrate() phases
GRAD_STEPS = 8
FOUR_SHAPE = (1024, 512, 512)  # global grid of the --four phases


def _say(msg):
    print(msg, flush=True)


def _gib(nbytes):
    return f"{nbytes / 2**30:.2f} GiB"


def _card_header(jax, devices):
    """Card name and power limit from nvidia-smi (a child that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    for line in out.splitlines():
        _say(f"card: {line.strip()}")
    _say(f"jax {jax.__version__}; device_kind {devices[0].device_kind}; "
         f"device count {len(devices)}")


def _peak(dev):
    return dev.memory_stats()["peak_bytes_in_use"]


def _check(ok, what):
    if not ok:
        raise AssertionError(what)
    _say(f"  ok: {what}")


def _rotation_zalesak(xs, t):
    """Rigid rotation about the axis x = y = 0.5 (the Zalesak flow field)."""
    x, y, z = xs
    zero = 0.0 * (x + y + z)
    return (0.5 - y + zero, x - 0.5 + zero, zero)


def _rotation_origin(xs, t):
    """Rigid rotation about the z axis through the origin."""
    x, y, z = xs
    zero = 0.0 * (x + y + z)
    return (-y + zero, x + zero, zero)


def _sphere(radius):
    def f(X, Y, Z):
        import jax.numpy as jnp

        return jnp.sqrt(X**2 + Y**2 + Z**2) - radius

    return f


def _steps_to(lsm, term, phi, integrator, nsteps):
    """``tf`` reached in exactly ``nsteps`` adaptive steps: the velocity is
    steady, so the CFL step is the same every step; the last is a half step."""
    dt = integrator.cfl * float(lsm.compute_cfl((term,), phi, 0.0))
    return (nsteps - 0.5) * dt


def _integrate(lsm, jax, term, ic, tf):
    eq = lsm.LevelSetEquation(terms=term, ic=ic, integrator=lsm.RK3())
    t0 = time.perf_counter()
    eq.integrate(tf)
    jax.block_until_ready(eq.state.values)
    return eq, time.perf_counter() - t0


# -- phase 1: dense ----------------------------------------------------------------


def phase_dense(lsm, jax, jnp, dev):
    from lsm_tpu.models import shapes

    _say(f"[dense] Zalesak sphere {N}^3, WENO5 + RK3, periodic, {NSTEPS} adaptive steps")
    grid = lsm.Grid((0.0,) * 3, (1.0,) * 3, (N,) * 3)
    h = grid.min_spacing
    term = lsm.AdvectionTerm(_rotation_zalesak)
    phi32 = lsm.sample(shapes.zalesak_sphere(), grid, lsm.Periodic(), dtype=jnp.float32)
    tf = _steps_to(lsm, term, phi32, lsm.RK3(), NSTEPS)

    eq, first = _integrate(lsm, jax, term, phi32, tf)
    _say(f"  first integrate (compile + run): {first:.2f} s")
    eq, warm = _integrate(lsm, jax, term, phi32, tf)
    cells = float(grid.num_nodes) * NSTEPS
    _say(f"  warm: {warm / NSTEPS * 1e3:.3f} ms/step, {cells / warm:.4e} cell-updates/s "
         f"({NSTEPS} steps in {warm:.4f} s)")
    _say(f"  peak_bytes_in_use: {_peak(dev)} ({_gib(_peak(dev))})")
    # the device loop runs its clock in the state's dtype
    _check(eq.state.dtype == jnp.float32 and eq.current_time == float(np.float32(tf)),
           "float32 state reached tf")
    out32 = eq.state.values
    vol32 = float(lsm.volume(eq.state))
    del eq

    phi64 = lsm.sample(shapes.zalesak_sphere(), grid, lsm.Periodic(), dtype=jnp.float64)
    eq64, t64 = _integrate(lsm, jax, term, phi64, tf)
    _say(f"  float64 reference run (compile + run): {t64:.2f} s")
    out64 = eq64.state.values
    vol64 = float(lsm.volume(eq64.state))
    vol0 = float(lsm.volume(phi64))
    del eq64, phi64

    near = jnp.abs(out64) < 3 * h
    err = float(jnp.max(jnp.where(near, jnp.abs(out32.astype(jnp.float64) - out64), 0.0)))
    dvol = abs(vol32 - vol64) / abs(vol64)
    _say(f"  max |phi32 - phi64| within 3h of the interface: {err:.3e}")
    _say(f"  relative volume change f32 vs f64: {dvol:.3e} "
         f"(volume loss of the scheme itself over the run: {(vol64 - vol0) / vol0:.3e})")
    # f32 rounding over 20 steps x 3 stages: each stage perturbs phi by a few
    # units in the last place of the stencil values (|phi| <= 6h in the 3h band
    # plus stencil reach), so the drift stays near 60 * eps * O(1) = 1e-5
    _check(err < 1e-5, f"dense f32 matches f64 near the interface (tol 1e-5): {err:.3e}")
    # the volume is a sum of 1.3e8 smoothed Heaviside terms: a pairwise sum
    # rounds at ~27 levels (27 eps = 3e-6) on top of the trajectory drift
    _check(dvol < 1e-5, f"dense f32 volume matches f64 (rel tol 1e-5): {dvol:.3e}")


# -- phase 2: band -----------------------------------------------------------------


def phase_band(lsm, jax, jnp, dev):
    _say(f"[band] sphere r=0.5 on [-1,1]^3 at {N}^3, 3-layer narrow band, "
         f"Extrapolation(2), {NSTEPS} adaptive steps")
    grid = lsm.Grid((-1.0,) * 3, (1.0,) * 3, (N,) * 3)
    h = grid.min_spacing
    term = lsm.AdvectionTerm(_rotation_origin)
    phi = lsm.sample(_sphere(0.5), grid, lsm.Extrapolation(2), dtype=jnp.float32)
    nb = lsm.NarrowBandField.from_field(phi, nlayers=3)
    # the band's CFL bound reduces over its active nodes only
    tf = _steps_to(lsm, term, nb, lsm.RK3(), NSTEPS)
    active = int(nb.active_count())
    _say(f"  active nodes: {active} ({active / grid.num_nodes:.4f} of the grid)")

    eq, first = _integrate(lsm, jax, term, nb, tf)
    _say(f"  first integrate (compile + run): {first:.2f} s")
    eq, warm = _integrate(lsm, jax, term, nb, tf)
    _say(f"  warm: {warm / NSTEPS * 1e3:.3f} ms/step ({NSTEPS} steps in {warm:.4f} s)")
    _check(isinstance(eq.state, lsm.NarrowBandField), "integrate kept the narrow band")
    band = eq.state
    del eq, nb

    dense, t_dense = _integrate(lsm, jax, term, phi, tf)
    _say(f"  dense run of the same problem (compile + run): {t_dense:.2f} s")
    _say(f"  peak_bytes_in_use: {_peak(dev)} ({_gib(_peak(dev))})")
    # the oracle of the reference suite (test-levelsetequation.jl:144-154):
    # active nodes within half the band width of the interface
    gamma = 3 * h
    mask = band.active_mask & (jnp.abs(band.values) < gamma / 2)
    err = float(jnp.max(jnp.where(mask, jnp.abs(band.values - dense.state.values), 0.0)))
    _say(f"  max |band - dense| near the interface: {err:.3e}")
    _check(bool(jnp.any(mask)), "band has active nodes near the interface")
    _check(err < 1e-3, f"band matches dense near the interface (reference tol 1e-3): {err:.3e}")


# -- phase 3: gradient -------------------------------------------------------------


def _grad_fn(lsm, jax, jnp, grid, nsteps):
    """``value_and_grad`` of a sum-of-squares loss of the final shape's smoothed
    indicator, through an RK3 rollout of the rotating Zalesak sphere.

    The loss weighs the interface, as a shape-optimization loss does. A loss
    over the whole field (sum of phi^2) is ill-conditioned in float32 on fine
    grids whatever the adjoint: one rounding of phi far from the interface
    moves the exact WENO5 gradient by O(eps |phi| n^2).
    """
    term = lsm.AdvectionTerm(_rotation_zalesak)
    h = grid.min_spacing

    def loss(values, dt):
        phi = lsm.MeshField(values, grid, lsm.Periodic())
        out, _ = lsm.rollout(lsm.RK3(), (term,), phi, 0.0, dt, nsteps)
        return jnp.sum(lsm.smooth_heaviside(-out.values, h) ** 2)

    return jax.jit(jax.value_and_grad(loss)), term


def _rel_l2(a, b):
    import jax.numpy as jnp

    a = a.astype(jnp.float64)
    return float(jnp.linalg.norm(a - b) / jnp.linalg.norm(b))


def _tie_cell_check(lsm, jax, jnp):
    """Hand adjoint vs plain autodiff of the WENO5 Hamiltonian in float32, both
    against float64, on a radial field (WENO indicators tie across the sphere)."""
    from lsm_tpu.models import shapes
    from lsm_tpu.ops import stencils as st

    n = 64
    grid = lsm.Grid((0.0,) * 3, (1.0,) * 3, (n,) * 3)
    phi = lsm.sample(shapes.zalesak_sphere(), grid, lsm.Periodic(), dtype=jnp.float32)
    padded = phi.pad(st.PAD_WENO5)
    xs = grid.coords(dtype=jnp.float32)
    u = tuple(jnp.broadcast_to(c, grid.shape) for c in _rotation_zalesak(xs, 0.0))
    g = jax.random.normal(jax.random.PRNGKey(0), grid.shape, jnp.float32)
    spacing, shape = tuple(grid.spacing), tuple(grid.shape)

    def vjp(fn, dtype):
        up = tuple(c.astype(dtype) for c in u)
        _, back = jax.vjp(lambda p: fn(p, up, spacing, shape), padded.astype(dtype))
        return back(g.astype(dtype))[0]

    ref = vjp(st.weno5_advection_plain, jnp.float64)
    hand = _rel_l2(vjp(st.weno5_advection, jnp.float32), ref)
    plain = vjp(st.weno5_advection_plain, jnp.float32)
    finite = bool(jnp.all(jnp.isfinite(plain)))
    plain_err = _rel_l2(plain, ref) if finite else float("inf")
    _say(f"  tie cells ({n}^3 Hamiltonian VJP vs f64): hand adjoint f32 rel-L2 "
         f"{hand:.3e}, plain f32 autodiff rel-L2 {plain_err:.3e}")
    _check(hand < 1e-2 and hand < 0.1 * plain_err,
           "hand adjoint is within 1e-2 of f64 and 10x closer than plain f32 autodiff")


def phase_gradient(lsm, jax, jnp, dev):
    _say(f"[gradient] value_and_grad through rollout (RK3, {GRAD_STEPS} steps, remat), "
         f"Zalesak sphere {N}^3")
    from lsm_tpu.models import shapes

    def setup(n, dtype):
        grid = lsm.Grid((0.0,) * 3, (1.0,) * 3, (n,) * 3)
        vg, term = _grad_fn(lsm, jax, jnp, grid, GRAD_STEPS)
        phi = lsm.sample(shapes.zalesak_sphere(), grid, lsm.Periodic(), dtype=jnp.float32)
        dt = lsm.RK3().cfl * float(lsm.compute_cfl((term,), phi, 0.0))
        return grid, vg, phi.values.astype(dtype), dt

    grid, vg32, v32, dt = setup(N, jnp.float32)
    t0 = time.perf_counter()
    loss32, g32 = jax.block_until_ready(vg32(v32, dt))
    _say(f"  first call (compile + run): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    loss32, g32 = jax.block_until_ready(vg32(v32, dt))
    warm = time.perf_counter() - t0
    _say(f"  warm value_and_grad: {warm * 1e3:.2f} ms ({warm / GRAD_STEPS * 1e3:.3f} ms/step, "
         f"{float(grid.num_nodes) * GRAD_STEPS / warm:.4e} cell-updates/s fwd+bwd)")
    _say(f"  peak_bytes_in_use: {_peak(dev)} ({_gib(_peak(dev))})")
    _check(bool(jnp.isfinite(loss32)) and bool(jnp.all(jnp.isfinite(g32))),
           "loss and gradient are finite")
    gmax = float(jnp.max(jnp.abs(g32)))
    _check(gmax > 0, f"gradient is non-zero (max |g| = {gmax:.3e})")

    # float64 reference from the same (float32) initial field, at the largest
    # size whose compiled footprint fits the memory left on the card
    n_ref = N
    vg64 = _grad_fn(lsm, jax, jnp, grid, GRAD_STEPS)[0]
    spec = jax.ShapeDtypeStruct((N,) * 3, jnp.float64)
    compiled = vg64.lower(spec, dt).compile()
    mem = compiled.memory_analysis()
    stats = dev.memory_stats()
    free = stats["bytes_limit"] - stats["bytes_in_use"]
    need = None if mem is None else (
        mem.temp_size_in_bytes + mem.argument_size_in_bytes + mem.output_size_in_bytes)
    _say(f"  f64 {N}^3 footprint: {'unknown' if need is None else _gib(need)}, "
         f"free: {_gib(free)}")
    if need is not None and need < 0.9 * free:
        loss64, g64 = jax.block_until_ready(compiled(v32.astype(jnp.float64), dt))
    else:
        del g32, compiled
        n_ref = N // 2
        grid, vg32, v32, dt = setup(n_ref, jnp.float32)
        loss32, g32 = vg32(v32, dt)
        vg64 = _grad_fn(lsm, jax, jnp, grid, GRAD_STEPS)[0]
        loss64, g64 = jax.block_until_ready(vg64(v32.astype(jnp.float64), dt))
    _say(f"  float64 reference at {n_ref}^3")
    dl = abs(float(loss32) - float(loss64)) / abs(float(loss64))
    err = _rel_l2(g32, g64)
    _say(f"  loss rel diff {dl:.3e}; gradient rel-L2 diff {err:.3e} at {n_ref}^3")
    _check(dl < 1e-5, f"f32 loss matches f64 (rel tol 1e-5): {dl:.3e}")
    # measured on the CPU backend: 3.3e-4 at 64^3, 6.1e-4 at 128^3, growing
    # ~1.9x per doubling (input rounding moves the exact gradient)
    _check(err < 1e-2, f"f32 gradient matches f64 (rel-L2 tol 1e-2): {err:.3e}")
    del g32, g64
    _tie_cell_check(lsm, jax, jnp)


# -- --four: the sharded path --------------------------------------------------------


def phase_four(lsm, jax, jnp, devices):
    from lsm_tpu.parallel import make_mesh, make_sharded_evolve, shard_field, constrain

    mesh = make_mesh(4)
    _say(f"[four] mesh {dict(zip(mesh.axis_names, mesh.devices.shape))} over "
         f"{[d.id for d in mesh.devices.flat]}")
    grid = lsm.Grid((0.0, 0.0, 0.0), (2.0, 1.0, 1.0), FOUR_SHAPE)
    h = grid.min_spacing
    bc = lsm.Extrapolation(2)

    def sphere(X, Y, Z):
        return jnp.sqrt((X - 1.0) ** 2 + (Y - 0.5) ** 2 + (Z - 0.5) ** 2) - 0.3

    phi = lsm.sample(sphere, grid, bc, dtype=jnp.float32)
    # coordinate callables cannot see shard-local coordinates: the sharded
    # path takes the velocity as a field, sharded alongside phi
    vel = lsm.sample(lambda X, Y, Z: (0.5 - Y + 0.0 * (X + Z), X - 1.0 + 0.0 * (Y + Z),
                                      0.0 * (X + Y + Z)),
                     grid, vector=True, dtype=jnp.float32)
    terms = (lsm.AdvectionTerm(vel),)
    terms_sh = (lsm.AdvectionTerm(shard_field(vel, mesh)),)
    nsteps = 10

    def on_all_cards(arr, what):
        used = {s.device.id for s in arr.addressable_shards}
        _check(len(used) == 4 and len({d.id for d in arr.sharding.device_set}) == 4,
               f"{what} is spread over four cards {sorted(used)}")

    def dense_and_band(field, is_band, what):
        ev = make_sharded_evolve(lsm.RK3(), mesh, grid, is_band=is_band)
        tf = _steps_to(lsm, terms[0], field, lsm.RK3(), nsteps)
        field_sh = shard_field(field, mesh)
        t0 = time.perf_counter()
        out, t, n = jax.block_until_ready(ev(terms_sh, field_sh, 0.0, tf))
        _say(f"  {what} sharded first call (compile + run): {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        out, t, n = jax.block_until_ready(ev(terms_sh, field_sh, 0.0, tf))
        warm = time.perf_counter() - t0
        _say(f"  {what} sharded warm: {warm / int(n) * 1e3:.3f} ms/step ({int(n)} steps)")
        on_all_cards(out.values, f"{what} result")
        ref, _, t_ref, n_ref = lsm.evolve(lsm.RK3(), terms, field, 0.0, tf)
        ref = jax.block_until_ready(ref)
        _check(int(n) == int(n_ref) == nsteps and float(t) == float(t_ref),
               f"{what}: same step count ({int(n)}) and final time as one card")
        err = float(jnp.max(jnp.abs(out.values - ref.values)))
        _say(f"  {what}: max |sharded - single| = {err:.3e}")
        # same arithmetic per cell; only XLA's fusion order differs by device
        _check(err < 1e-5, f"{what} sharded matches single card (tol 1e-5)")
        if is_band:
            _check(bool(jnp.all(out.mask == ref.mask)), f"{what}: band masks agree")

    dense_and_band(phi, False, "dense")
    dense_and_band(lsm.NarrowBandField.from_field(phi, nlayers=3), True, "band")

    # differentiable rollout, auto-SPMD: shard_field + constrain, as a
    # shape-optimization step would run it
    nsteps_g = 4
    dt = lsm.RK3().cfl * float(lsm.compute_cfl(terms, phi, 0.0))

    def loss(values, vel_values, sharded):
        if sharded:
            values = constrain(values, mesh, 3)
        f = phi.with_values(values)
        term = lsm.AdvectionTerm(vel.with_values(vel_values))
        out, _ = lsm.rollout(lsm.RK3(), (term,), f, 0.0, dt, nsteps_g)
        v = constrain(out.values, mesh, 3) if sharded else out.values
        return jnp.sum(lsm.smooth_heaviside(-v, h) ** 2)

    vg = jax.jit(jax.value_and_grad(loss), static_argnums=(2,))
    l1, g1 = jax.block_until_ready(vg(phi.values, vel.values, False))
    ps, vs = shard_field(phi, mesh), shard_field(vel, mesh)
    t0 = time.perf_counter()
    l4, g4 = jax.block_until_ready(vg(ps.values, vs.values, True))
    _say(f"  sharded value_and_grad first call (compile + run): {time.perf_counter() - t0:.2f} s")
    on_all_cards(g4, "sharded gradient")
    dl = abs(float(l4) - float(l1)) / abs(float(l1))
    err = float(jnp.linalg.norm(g4 - g1) / jnp.linalg.norm(g1))
    _say(f"  rollout: loss rel diff {dl:.3e}, gradient rel-L2 diff {err:.3e}")
    _check(bool(jnp.all(jnp.isfinite(g4))) and float(jnp.max(jnp.abs(g4))) > 0,
           "sharded gradient is finite and non-zero")
    _check(dl < 1e-5 and err < 1e-3,
           "sharded rollout loss (tol 1e-5) and gradient (rel-L2 tol 1e-3) match one card")
    for d in devices[:4]:
        _say(f"  device {d.id} peak_bytes_in_use: {_peak(d)} ({_gib(_peak(d))})")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the sharded phases on four GPUs")
    args = parser.parse_args()

    import jax

    jax.config.update("jax_enable_x64", True)  # for the float64 references
    import jax.numpy as jnp

    import lsm_tpu as lsm
    from lsm_tpu.platform import require_gpu, use_compile_cache

    dev = require_gpu()
    use_compile_cache()
    devices = jax.devices()
    if args.four and len(devices) < 4:
        raise RuntimeError(f"--four needs 4 GPUs, found {len(devices)}")
    _card_header(jax, devices)

    t0 = time.perf_counter()
    if args.four:
        phase_four(lsm, jax, jnp, devices)
    else:
        phase_dense(lsm, jax, jnp, dev)
        phase_band(lsm, jax, jnp, dev)
        phase_gradient(lsm, jax, jnp, dev)
    _say(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(devices)}}),
        flush=True)


if __name__ == "__main__":
    main()
