"""Whole-array finite-difference / WENO stencil operators.

The reference's pointwise per-node operators (``src/derivatives.jl``) as
whole-array JAX functions: every operator maps a *ghost-padded* array ``p`` (pad
width ``g`` on each side of every spatial axis, produced by ``MeshField.pad`` /
``pad_ghost``) to an interior-shaped array, expressed as shifted dense slices that
XLA fuses into a few elementwise loops.

Required pad widths: first derivatives and centered second derivatives need
``g >= 1``; the mixed second derivative needs corner ghosts with ``g >= 1``; the
second-order ENO combinations need ``g >= 2``; WENO5 needs ``g >= 3``
(reference stencil reach: ``derivatives.jl:89-121``).

The WENO5 advection Hamiltonian has two entry points with the same forward:
:func:`weno5_advection_plain` (differentiated by autodiff) and
:func:`weno5_advection` (a ``jax.custom_vjp`` whose backward is the hand-derived
adjoint :func:`weno5_upwind_fwd_bwd`). The terms use the latter: in float32 the
autodiff backward is wrong by order 1 at cells where the WENO smoothness
indicators tie, and the hand adjoint is not.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import math
from functools import partial

import jax
import jax.numpy as jnp

__all__ = [
    "PAD_D0",
    "PAD_ENO2",
    "PAD_WENO5",
    "shift",
    "d0",
    "dp",
    "dm",
    "d2c",
    "d2pp",
    "d2mm",
    "d2_mixed",
    "weno5m",
    "weno5p",
    "weno5_upwind",
    "weno5_upwind_fwd_bwd",
    "weno5_advection",
    "weno5_advection_plain",
    "minmod",
    "eno2_onesided",
    "godunov_norms",
]

PAD_D0 = 1
PAD_ENO2 = 2
PAD_WENO5 = 3


def shift(p: jnp.ndarray, offsets, g: int, shape: Sequence[int]) -> jnp.ndarray:
    """Interior-shaped view ``phi[I + offsets]`` of a padded array.

    ``offsets`` is a per-spatial-dim tuple of integer shifts and ``g`` the ghost
    width. Leading (component) axes of ``p`` beyond ``len(shape)`` are passed
    through.
    """
    nspatial = len(shape)
    lead = p.ndim - nspatial
    sl = [slice(None)] * lead
    for d in range(nspatial):
        off = g + offsets[d]
        sl.append(slice(off, off + shape[d]))
    return p[tuple(sl)]


def _axis_offset(axis: int, k: int, ndim: int) -> Tuple[int, ...]:
    return tuple(k if d == axis else 0 for d in range(ndim))


def _s(p, axis, k, g, shape):
    return shift(p, _axis_offset(axis, k, len(shape)), g, shape)


# -- first derivatives (derivatives.jl:28-57) --------------------------------------


def d0(p, axis, h, g, shape):
    """Centered first derivative along ``axis``."""
    return (_s(p, axis, 1, g, shape) - _s(p, axis, -1, g, shape)) / (2.0 * h)


def dp(p, axis, h, g, shape):
    """Forward first derivative along ``axis``."""
    return (_s(p, axis, 1, g, shape) - _s(p, axis, 0, g, shape)) / h


def dm(p, axis, h, g, shape):
    """Backward first derivative along ``axis``."""
    return (_s(p, axis, 0, g, shape) - _s(p, axis, -1, g, shape)) / h


# -- second derivatives (derivatives.jl:124-175) -----------------------------------


def d2c(p, axis, h, g, shape):
    """Centered second derivative along ``axis``."""
    return (
        _s(p, axis, 1, g, shape) - 2.0 * _s(p, axis, 0, g, shape) + _s(p, axis, -1, g, shape)
    ) / (h * h)


def d2pp(p, axis, h, g, shape):
    """One-sided (forward) second derivative along ``axis``."""
    return (
        _s(p, axis, 0, g, shape) - 2.0 * _s(p, axis, 1, g, shape) + _s(p, axis, 2, g, shape)
    ) / (h * h)


def d2mm(p, axis, h, g, shape):
    """One-sided (backward) second derivative along ``axis``."""
    return (
        _s(p, axis, -2, g, shape) - 2.0 * _s(p, axis, -1, g, shape) + _s(p, axis, 0, g, shape)
    ) / (h * h)


def d2_mixed(p, ax1, ax2, h1, h2, g, shape):
    """Mixed second derivative d^2/dx_ax1 dx_ax2 (``derivatives.jl:144-149``)."""
    n = len(shape)

    def two(a_k, b_k):
        off = [0] * n
        off[ax1] += a_k
        off[ax2] += b_k
        return shift(p, tuple(off), g, shape)

    return (two(1, 1) - two(1, -1) - two(-1, 1) + two(-1, -1)) / (4.0 * h1 * h2)


# -- WENO5 (derivatives.jl:61-121, Osher-Fedkiw sec. 3.4) --------------------------


def _weno_core(v1, v2, v3, v4, v5):
    """Classic fifth-order WENO reconstruction from five one-sided differences
    ordered from the upwind end inward (Jiang-Shu smoothness indicators, weights
    0.1/0.6/0.3, fudge factor ``1e-6 * max(v_i^2) + 1e-99``)."""
    d1 = (1.0 / 3.0) * v1 - (7.0 / 6.0) * v2 + (11.0 / 6.0) * v3
    d2 = -(1.0 / 6.0) * v2 + (5.0 / 6.0) * v3 + (1.0 / 3.0) * v4
    d3 = (1.0 / 3.0) * v3 + (5.0 / 6.0) * v4 - (1.0 / 6.0) * v5
    s1 = (13.0 / 12.0) * (v1 - 2.0 * v2 + v3) ** 2 + 0.25 * (v1 - 4.0 * v2 + 3.0 * v3) ** 2
    s2 = (13.0 / 12.0) * (v2 - 2.0 * v3 + v4) ** 2 + 0.25 * (v2 - v4) ** 2
    s3 = (13.0 / 12.0) * (v3 - 2.0 * v4 + v5) ** 2 + 0.25 * (3.0 * v3 - 4.0 * v4 + v5) ** 2
    vmax = jnp.maximum(
        jnp.maximum(jnp.maximum(v1 * v1, v2 * v2), jnp.maximum(v3 * v3, v4 * v4)), v5 * v5
    )
    # absolute floor. The reference's 1e-99 flushes to zero below float64, and a
    # uniform stencil (all v_i = 0) then yields inf * 0 = NaN; worse, the
    # *gradient* of the weights contains (s + eps)^-3 terms, so the floor must
    # keep eps^-3 finite in the working dtype (differentiability through flat
    # regions). Any |v| above ~1e3*sqrt(floor) keeps the adaptive 1e-6*vmax term
    # dominant, so the WENO weights are unchanged where the field varies.
    floor = 1.0e-36 if jnp.result_type(v1) == jnp.float64 else 1.0e-12
    eps = 1.0e-6 * vmax + floor
    a1 = 0.1 / (s1 + eps) ** 2
    a2 = 0.6 / (s2 + eps) ** 2
    a3 = 0.3 / (s3 + eps) ** 2
    inv = 1.0 / (a1 + a2 + a3)
    return (a1 * d1 + a2 * d2 + a3 * d3) * inv


def _weno_eps(vmax, dtype):
    # absolute floor: see the note in _weno_core.
    floor = 1.0e-36 if dtype == jnp.float64 else 1.0e-12
    return 1.0e-6 * vmax + floor


def _weno_combine(s1, s2, s3, eps, d1, d2, d3):
    """Weighted combination with ONE division (plus one shared reciprocal).

    Classic form needs four divisions (three ``a_i = g_i/(s_i+eps)^2`` plus the
    normalization). Rewrite with ``b_i = (s_i+eps)/eps >= 1``:
    ``a_i \\propto g_i * (b_j b_k)^2`` (j,k the other two), so the weights
    ``a_i / sum(a)`` are unchanged (the common ``prod(b)^2 / eps^4`` cancels).
    The ``1/eps`` normalization keeps every intermediate in fp32 range:
    ``1 <= b_i <= ~26/1e-6`` so ``(b_j b_k)^2 <= ~5e29 < fp32 max``, and a flat
    stencil gives ``b_i = 1`` -> exact 0.1/0.6/0.3 weights (never 0/0).
    """
    r = 1.0 / eps
    b1 = s1 * r + 1.0
    b2 = s2 * r + 1.0
    b3 = s3 * r + 1.0
    q1 = 0.1 * (b2 * b3) ** 2
    q2 = 0.6 * (b1 * b3) ** 2
    q3 = 0.3 * (b1 * b2) ** 2
    qsum = q1 + q2 + q3
    w = 1.0 / qsum
    return (q1 * d1 + q2 * d2 + q3 * d3) * w


def weno5_upwind(dm, u):
    """Upwinded WENO5 advection contribution ``u * (u>0 ? weno5- : weno5+)``
    along one axis, from the six shared backward differences ``dm`` (see
    :func:`weno5_pair_diffs`) and that axis's velocity component ``u``.

    Instead of evaluating BOTH biased reconstructions and selecting the output
    (``u * where(u>0, weno5m, weno5p)``), select the five stencil *inputs* by
    the sign of ``u`` and run ONE core — the plus-biased core is the minus core
    on the reflected stencil ``(dm5,dm4,dm3,dm2,dm1)``, so five ``where``s
    replace an entire second set of smoothness indicators, weights, and
    candidates (about half the arithmetic). Identical result: at ``u == 0`` both forms pick the plus branch and
    multiply by zero.

    Arithmetic layout: the Jiang-Shu indicators and the 3rd-order candidates
    are expressed through the shared first/second difference tables
    ``e_k = v_{k+1}-v_k`` / ``c_k = e_{k+1}-e_k`` (algebraically identical to
    the textbook form, ~25% fewer operations).
    """
    cond = u > 0
    v1 = jnp.where(cond, dm[0], dm[5])
    v2 = jnp.where(cond, dm[1], dm[4])
    v3 = jnp.where(cond, dm[2], dm[3])
    v4 = jnp.where(cond, dm[3], dm[2])
    v5 = jnp.where(cond, dm[4], dm[1])
    e2 = v3 - v2
    e3 = v4 - v3
    c1 = e2 - (v2 - v1)
    c2 = e3 - e2
    c3 = (v5 - v4) - e3
    # candidates anchored at v3: d1 = v3 + e2/2 + c1/3, etc. (same 1/3,-7/6,
    # 11/6... coefficients after expansion)
    d1 = v3 + 0.5 * e2 + (1.0 / 3.0) * c1
    d2 = v3 + 0.5 * e3 - (1.0 / 6.0) * c2
    d3 = v3 + 0.5 * e3 - (1.0 / 6.0) * c3
    c13 = 13.0 / 12.0
    t1 = c1 + 2.0 * e2  # = v1 - 4 v2 + 3 v3
    t2 = e2 + e3        # = v4 - v2 (squared below, sign irrelevant)
    t3 = c3 - 2.0 * e3  # = 3 v3 - 4 v4 + v5
    s1 = c13 * (c1 * c1) + 0.25 * (t1 * t1)
    s2 = c13 * (c2 * c2) + 0.25 * (t2 * t2)
    s3 = c13 * (c3 * c3) + 0.25 * (t3 * t3)
    vmax = jnp.maximum(
        jnp.maximum(jnp.maximum(v1 * v1, v2 * v2), jnp.maximum(v3 * v3, v4 * v4)),
        v5 * v5,
    )
    eps = _weno_eps(vmax, jnp.result_type(v1))
    return u * _weno_combine(s1, s2, s3, eps, d1, d2, d3)


def weno5_upwind_fwd_bwd(dm, u, g):
    """Forward value AND hand-derived cotangents of :func:`weno5_upwind` in
    one pass: ``(H, ddm[6], du)`` with ``H = u * core``, ``g`` the cotangent of
    ``H`` and ``du = core * g`` the cotangent of ``u``.

    The mechanical ``jax.vjp`` reverse of the WENO chain costs ~2.7x the
    forward and, in float32, is wrong by order 1 at cells whose smoothness
    indicators tie (the eps path multiplies a catastrophically cancelled
    ``dr`` by ``r^2 ~ 1e21``). This explicit backward reuses every forward
    intermediate, costs ~1.3x, and matches the float64 gradient there.

    Same branch structure as ``jax.vjp(weno5_upwind)``; the ``vmax`` maximum
    tree replicates JAX's tie-splitting semantics (0.5/0.5 on exact ties —
    ``lax._balanced_eq``), so flat regions where all ``v_i^2`` tie give the
    same subgradients as autodiff.
    """
    cond = u > 0
    v1 = jnp.where(cond, dm[0], dm[5])
    v2 = jnp.where(cond, dm[1], dm[4])
    v3 = jnp.where(cond, dm[2], dm[3])
    v4 = jnp.where(cond, dm[3], dm[2])
    v5 = jnp.where(cond, dm[4], dm[1])
    # -- forward (identical arithmetic to weno5_upwind) --
    e2 = v3 - v2
    e3 = v4 - v3
    c1 = e2 - (v2 - v1)
    c2 = e3 - e2
    c3 = (v5 - v4) - e3
    d1 = v3 + 0.5 * e2 + (1.0 / 3.0) * c1
    d2 = v3 + 0.5 * e3 - (1.0 / 6.0) * c2
    d3 = v3 + 0.5 * e3 - (1.0 / 6.0) * c3
    c13 = 13.0 / 12.0
    t1 = c1 + 2.0 * e2
    t2 = e2 + e3
    t3 = c3 - 2.0 * e3
    s1 = c13 * (c1 * c1) + 0.25 * (t1 * t1)
    s2 = c13 * (c2 * c2) + 0.25 * (t2 * t2)
    s3 = c13 * (c3 * c3) + 0.25 * (t3 * t3)
    sq1, sq2, sq3, sq4, sq5 = v1 * v1, v2 * v2, v3 * v3, v4 * v4, v5 * v5
    m12 = jnp.maximum(sq1, sq2)
    m34 = jnp.maximum(sq3, sq4)
    m14 = jnp.maximum(m12, m34)
    vmax = jnp.maximum(m14, sq5)
    eps = _weno_eps(vmax, jnp.result_type(v1))
    r = 1.0 / eps
    b1 = s1 * r + 1.0
    b2 = s2 * r + 1.0
    b3 = s3 * r + 1.0
    p1 = b2 * b3
    p2 = b1 * b3
    p3 = b1 * b2
    q1 = 0.1 * (p1 * p1)
    q2 = 0.6 * (p2 * p2)
    q3 = 0.3 * (p3 * p3)
    qsum = q1 + q2 + q3
    w = 1.0 / qsum
    core = (q1 * d1 + q2 * d2 + q3 * d3) * w
    H = u * core

    # -- backward (reverse of the chain above, intermediates reused) --
    du = core * g
    gc = u * g
    wgc = w * gc
    dd1 = q1 * wgc
    dd2 = q2 * wgc
    dd3 = q3 * wgc
    # core = num*w, w = 1/qsum: dq_i = (d_i - core) * w * gc
    dq1 = (d1 - core) * wgc
    dq2 = (d2 - core) * wgc
    dq3 = (d3 - core) * wgc
    dp1 = 0.2 * p1 * dq1
    dp2 = 1.2 * p2 * dq2
    dp3 = 0.6 * p3 * dq3
    db1 = b3 * dp2 + b2 * dp3
    db2 = b3 * dp1 + b1 * dp3
    db3 = b2 * dp1 + b1 * dp2
    ds1 = r * db1
    ds2 = r * db2
    ds3 = r * db3
    dr = s1 * db1 + s2 * db2 + s3 * db3
    dvmax = -1.0e-6 * (r * r) * dr  # through eps = 1e-6*vmax + floor
    # maximum-tree backward, JAX tie semantics: on a==b both sides get 0.5

    def mbwd(a, b, ans, gm):
        ga = gm * jnp.where(a == ans, jnp.where(b == ans, 0.5, 1.0), 0.0)
        gb = gm * jnp.where(b == ans, jnp.where(a == ans, 0.5, 1.0), 0.0)
        return ga, gb

    dm14, dsq5 = mbwd(m14, sq5, vmax, dvmax)
    dm12, dm34 = mbwd(m12, m34, m14, dm14)
    dsq1, dsq2 = mbwd(sq1, sq2, m12, dm12)
    dsq3, dsq4 = mbwd(sq3, sq4, m34, dm34)
    dv1 = 2.0 * v1 * dsq1
    dv2 = 2.0 * v2 * dsq2
    dv3 = 2.0 * v3 * dsq3
    dv4 = 2.0 * v4 * dsq4
    dv5 = 2.0 * v5 * dsq5
    # s_i = c13*c_i^2 + 0.25*t_i^2
    dc1 = 2.0 * c13 * c1 * ds1
    dc2 = 2.0 * c13 * c2 * ds2
    dc3 = 2.0 * c13 * c3 * ds3
    dt1 = 0.5 * t1 * ds1
    dt2 = 0.5 * t2 * ds2
    dt3 = 0.5 * t3 * ds3
    # t1 = c1 + 2 e2 ; t2 = e2 + e3 ; t3 = c3 - 2 e3
    dc1 = dc1 + dt1
    de2 = 2.0 * dt1 + dt2
    de3 = dt2 - 2.0 * dt3
    dc3 = dc3 + dt3
    # candidates
    dv3 = dv3 + dd1 + dd2 + dd3
    de2 = de2 + 0.5 * dd1
    de3 = de3 + 0.5 * (dd2 + dd3)
    dc1 = dc1 + (1.0 / 3.0) * dd1
    dc2 = dc2 - (1.0 / 6.0) * dd2
    dc3 = dc3 - (1.0 / 6.0) * dd3
    # c1 = e2 - (v2 - v1); c2 = e3 - e2; c3 = (v5 - v4) - e3
    de2 = de2 + dc1 - dc2
    de3 = de3 + dc2 - dc3
    dv1 = dv1 + dc1
    dv2 = dv2 - dc1
    dv4 = dv4 - dc3
    dv5 = dv5 + dc3
    # e2 = v3 - v2; e3 = v4 - v3
    dv3 = dv3 + de2 - de3
    dv2 = dv2 - de2
    dv4 = dv4 + de3
    # undo the input selection
    zero = jnp.zeros((), jnp.result_type(v1))
    ddm = (
        jnp.where(cond, dv1, zero),
        jnp.where(cond, dv2, dv5),
        jnp.where(cond, dv3, dv4),
        jnp.where(cond, dv4, dv3),
        jnp.where(cond, dv5, dv2),
        jnp.where(cond, zero, dv1),
    )
    return H, ddm, du


def weno5_pair_diffs(p, axis, h, g, shape):
    """The six backward differences ``D- at I-2 .. I+3`` along ``axis`` feeding
    :func:`weno5_upwind` (shared between both biases: ``D+ at I+m == D- at I+m+1``)."""
    s = [_s(p, axis, k, g, shape) for k in range(-3, 4)]  # offsets -3..3
    inv_h = 1.0 / h
    return [(s[k + 1] - s[k]) * inv_h for k in range(6)]


def weno5_advection_plain(padded, u, spacing, shape):
    """WENO5 advection Hamiltonian ``sum_d u_d * (u_d > 0 ? weno5- : weno5+)``
    on a field padded by ``PAD_WENO5``; ``u`` holds one interior-shaped velocity
    component per axis. Differentiated by plain autodiff: the reference that
    :func:`weno5_advection` is checked against."""
    out = 0.0
    for ax, h in enumerate(spacing):
        dm = weno5_pair_diffs(padded, ax, h, PAD_WENO5, shape)
        out = out + weno5_upwind(dm, u[ax])
    return out


@partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def weno5_advection(padded, u, spacing, shape):
    """:func:`weno5_advection_plain` with the hand-derived adjoint as its VJP.

    ``spacing`` and ``shape`` are static tuples. The backward recomputes the
    forward from the inputs (no residuals beyond ``padded`` and ``u``) through
    :func:`weno5_upwind_fwd_bwd`, and maps the difference-table cotangents back
    onto ``padded`` with the VJP of the (linear) difference construction.
    """
    return weno5_advection_plain(padded, u, spacing, shape)


#: cells per slab of the backward pass: XLA materializes a few dozen
#: temporaries of the slab's size, so a whole 512^3 grid at once needs more
#: memory than an 80 GB card holds
BWD_SLAB_CELLS = 1 << 24


def _weno5_advection_fwd(padded, u, spacing, shape):
    return weno5_advection_plain(padded, u, spacing, shape), (padded, u)


def _vjp_block(padded, u, g, spacing, shape):
    d_padded = jnp.zeros_like(padded)
    d_u = []
    for ax, h in enumerate(spacing):
        dm, dm_vjp = jax.vjp(
            lambda p: tuple(weno5_pair_diffs(p, ax, h, PAD_WENO5, shape)), padded
        )
        _, ddm, du = weno5_upwind_fwd_bwd(dm, u[ax], g)
        d_padded = d_padded + dm_vjp(tuple(ddm))[0]
        d_u.append(du)
    return d_padded, tuple(d_u)


def _slab_rows(shape) -> int:
    """Rows of axis 0 per backward slab: the largest divisor of ``shape[0]``
    whose slab holds at most ``BWD_SLAB_CELLS`` cells (at least one row)."""
    row = math.prod(shape[1:])
    best = 1
    for rows in range(1, shape[0] + 1):
        if shape[0] % rows == 0 and rows * row <= BWD_SLAB_CELLS:
            best = rows
    return best


def _weno5_advection_bwd(spacing, shape, res, g):
    # scan over slabs of axis 0 (one slab on small grids); each reads its rows
    # plus the stencil halo and adds its cotangent into the overlapping padded
    # rows it read
    padded, u = res
    rows = _slab_rows(shape)
    G = PAD_WENO5
    slab_shape = (rows,) + tuple(shape[1:])

    def body(carry, i):
        d_padded, d_u = carry
        r0 = i * rows
        take = lambda a, n: jax.lax.dynamic_slice_in_dim(a, r0, n, axis=0)
        dp, du = _vjp_block(take(padded, rows + 2 * G), tuple(take(c, rows) for c in u),
                            take(g, rows), spacing, slab_shape)
        d_padded = jax.lax.dynamic_update_slice_in_dim(
            d_padded, take(d_padded, rows + 2 * G) + dp, r0, axis=0)
        d_u = tuple(jax.lax.dynamic_update_slice_in_dim(a, b, r0, axis=0)
                    for a, b in zip(d_u, du))
        return (d_padded, d_u), None

    init = (jnp.zeros_like(padded), tuple(jnp.zeros(shape, g.dtype) for _ in u))
    (d_padded, d_u), _ = jax.lax.scan(body, init, jnp.arange(shape[0] // rows))
    return d_padded, type(u)(d_u)


weno5_advection.defvjp(_weno5_advection_fwd, _weno5_advection_bwd)


def weno5m(p, axis, h, g, shape):
    """Left-biased fifth-order WENO derivative along ``axis`` (``weno5-``).

    Uses the five backward differences at ``I-2 .. I+2``; needs ``g >= 3``.
    """
    s = [_s(p, axis, k, g, shape) for k in range(-3, 3)]  # offsets -3..2
    diffs = [(s[k + 1] - s[k]) / h for k in range(5)]  # D- at I-2..I+2
    return _weno_core(*diffs)


def weno5p(p, axis, h, g, shape):
    """Right-biased fifth-order WENO derivative along ``axis`` (``weno5+``).

    Uses the five forward differences at ``I+2 .. I-2`` (upwind end first).
    """
    s = [_s(p, axis, k, g, shape) for k in range(-2, 4)]  # offsets -2..3
    diffs = [(s[k + 1] - s[k]) / h for k in range(5)]  # D+ at I-2..I+2
    return _weno_core(diffs[4], diffs[3], diffs[2], diffs[1], diffs[0])


# -- ENO2 / Godunov building blocks (levelsetterms.jl:156-187,252-265) -------------


def minmod(x, y):
    """Minmod limiter: zero when signs differ, else the smaller magnitude."""
    same = x * y > 0.0
    pick = jnp.where(jnp.abs(x) <= jnp.abs(y), x, y)
    return jnp.where(same, pick, 0.0)


def eno2_onesided(p, axis, h, g, shape):
    """Second-order ENO one-sided derivatives ``(A, B)`` along ``axis``:

    ``A = D- + 0.5 h minmod(D2--, D2_0)`` and ``B = D+ - 0.5 h minmod(D2++, D2_0)``
    (reference ``levelsetterms.jl:156-170``). Needs ``g >= 2``.
    """
    c = d2c(p, axis, h, g, shape)
    A = dm(p, axis, h, g, shape) + 0.5 * h * minmod(d2mm(p, axis, h, g, shape), c)
    B = dp(p, axis, h, g, shape) - 0.5 * h * minmod(d2pp(p, axis, h, g, shape), c)
    return A, B


def safe_sqrt(x):
    """``sqrt`` with a finite derivative at 0 (double-where guard).

    Forward-identical to ``jnp.sqrt`` for ``x >= 0``; the VJP at ``x == 0``
    is 0 (a valid subgradient) instead of ``0 * inf = NaN``. Godunov norms
    are EXACTLY zero on locally monotone/flat profiles, so the bare sqrt
    poisons gradients of every normal-motion/eikonal term there."""
    safe = x > 0
    return jnp.where(safe, jnp.sqrt(jnp.where(safe, x, 1.0)), 0.0)


def godunov_norms(p, spacing, g, shape):
    """Godunov upwind gradient magnitudes ``(|grad+|, |grad-|)`` with ENO2 one-sided
    derivatives (Osher-Fedkiw eq. 6.28; reference ``levelsetterms.jl:156-170``):

    ``|grad+|^2 = sum_d max(A,0)^2 + min(B,0)^2`` — for outward motion (v > 0)
    ``|grad-|^2 = sum_d min(A,0)^2 + max(B,0)^2`` — for inward motion (v < 0)
    """
    gp2 = 0.0
    gm2 = 0.0
    for ax, h in enumerate(spacing):
        A, B = eno2_onesided(p, ax, h, g, shape)
        gp2 = gp2 + jnp.maximum(A, 0.0) ** 2 + jnp.minimum(B, 0.0) ** 2
        gm2 = gm2 + jnp.minimum(A, 0.0) ** 2 + jnp.maximum(B, 0.0) ** 2
    return safe_sqrt(gp2), safe_sqrt(gm2)
