"""High-order quadrature on implicitly defined domains (cut cells).

JAX replacement for the reference's ImplicitIntegration extension
(``/root/reference/ext/ImplicitIntegrationExt.jl``): per active cell, build the
local Bernstein patch of the level set and generate a quadrature for the volume
``{phi < 0}`` or the surface ``{phi = 0}`` by Saye-style dimension reduction
(Saye 2015, "High-order quadrature methods for implicitly defined surfaces and
volumes in hyperrectangles"):

1. prune cells via the Bernstein convex-hull bound,
2. find a *height* direction in which the patch is provably monotone
   (sign-definite derivative bounds),
3. adaptively bisect (de Casteljau) until each sub-box is in a *uniform column
   regime* (bottom/top face restrictions sign-definite => each column carries
   exactly one root, so the column mass is a smooth function over the base),
4. tensor Gauss-Legendre over the base; per base node a monotone 1-D
   root solve along the height; volume columns get a mapped 1-D Gauss rule,
   surface nodes get weight ``w_base * |grad phi| / |d phi/d height|``.

This is host-side numpy by design: the recursion is data-dependent and runs
once per (re)meshing query, not in the evolution hot loop — exactly how the
reference treats it (a weak-dependency extension living outside the PDE path).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.field import MeshField
from ..interp.interpolation import InterpolatedField

__all__ = ["quadrature", "integrate", "cell_quadrature"]

_MAX_DEPTH = 16


# -- numpy Bernstein helpers (host-side twins of interp/bernstein.py) --------------


def _basis(deg: int, t: np.ndarray) -> np.ndarray:
    k = np.arange(deg + 1)
    binom = np.asarray([math.comb(deg, i) for i in k], dtype=float)
    t = np.asarray(t, dtype=float)[..., None]
    return binom * t**k * (1 - t) ** (deg - k)


def _eval_point(coeffs: np.ndarray, t) -> float:
    out = coeffs
    for d, td in enumerate(t):
        out = np.tensordot(_basis(out.shape[0] - 1, np.asarray(td)), out, axes=[[-1], [0]])
    return float(out)


def _derivative(coeffs: np.ndarray, axis: int, width: float) -> np.ndarray:
    n = coeffs.shape[axis]
    up = np.take(coeffs, range(1, n), axis=axis)
    lo = np.take(coeffs, range(0, n - 1), axis=axis)
    return (n - 1) / width * (up - lo)


def _decasteljau(n: int, t: float = 0.5):
    L = np.zeros((n, n))
    R = np.zeros((n, n))
    tri = np.eye(n)
    L[0] = tri[0]
    R[n - 1] = tri[n - 1]
    for k in range(1, n):
        tri = (1 - t) * tri[:-1] + t * tri[1:]
        L[k] = tri[0]
        R[n - 1 - k] = tri[-1]
    return L, R


def _split(coeffs: np.ndarray, axis: int):
    n = coeffs.shape[axis]
    L, R = _decasteljau(n)
    moved = np.moveaxis(coeffs, axis, -1)
    return (
        np.moveaxis(moved @ L.T, -1, axis),
        np.moveaxis(moved @ R.T, -1, axis),
    )


def _face(coeffs: np.ndarray, axis: int, side: int) -> np.ndarray:
    idx = 0 if side == 0 else coeffs.shape[axis] - 1
    return np.take(coeffs, idx, axis=axis)


def _gauss(order: int) -> Tuple[np.ndarray, np.ndarray]:
    x, w = np.polynomial.legendre.leggauss(max(order, 1))
    return 0.5 * (x + 1.0), 0.5 * w  # on [0, 1]


def _root_1d(c: np.ndarray, lo_val: float) -> float:
    """Unique root of a monotone 1-D Bernstein polynomial on [0,1] (bisection)."""
    a, b = 0.0, 1.0
    fa = c[0]
    for _ in range(64):
        m = 0.5 * (a + b)
        fm = _eval_point(c, (m,))
        if (fm < 0) == (fa < 0):
            a, fa = m, fm
        else:
            b = m
    return 0.5 * (a + b)


def _roots_1d_batch(cs: np.ndarray) -> np.ndarray:
    """Vectorized bisection: ``cs`` shape (npoints, deg+1), each monotone with a
    sign change on [0,1]."""
    npts, n = cs.shape
    a = np.zeros(npts)
    b = np.ones(npts)
    fa = cs[:, 0].copy()
    for _ in range(64):
        m = 0.5 * (a + b)
        B = _basis(n - 1, m)  # (npts, n)
        fm = np.einsum("ij,ij->i", B, cs)
        left = (fm < 0) == (fa < 0)
        a = np.where(left, m, a)
        fa = np.where(left, fm, fa)
        b = np.where(left, b, m)
    return 0.5 * (a + b)


def _tensor_gauss(lo, hi, order, ndim):
    x, w = _gauss(order)
    grids = np.meshgrid(*([x] * ndim), indexing="ij")
    ws = np.meshgrid(*([w] * ndim), indexing="ij")
    pts = np.stack([g.ravel() for g in grids], -1)
    wts = np.prod(np.stack([g.ravel() for g in ws], -1), axis=-1)
    scale = np.prod(hi - lo)
    return lo + pts * (hi - lo), wts * scale


def _eval_batch(coeffs: np.ndarray, tpts: np.ndarray) -> np.ndarray:
    """Evaluate an ndim-patch at unit points (npts, ndim)."""
    vals = np.broadcast_to(coeffs, (tpts.shape[0],) + coeffs.shape)
    for d in range(coeffs.ndim):
        B = _basis(vals.shape[1] - 1, tpts[:, d])  # (npts, n)
        vals = np.einsum("pi,pi...->p...", B, vals)
    return vals


def _member(v, sign):
    """Membership of a value under a signed constraint (sign 0 = kink tracker
    only, always satisfied)."""
    if sign == 0:
        return True
    return v <= 0 if sign < 0 else v >= 0


def _prune(psis):
    """Drop constraints that hold everywhere; detect empty regions.

    Returns (kept, empty): ``empty=True`` when some hard constraint can never
    hold on the box.
    """
    kept = []
    for c, sign in psis:
        m, M = c.min(), c.max()
        if sign < 0:
            if m > 0:
                return [], True
            if M <= 0:
                continue  # satisfied everywhere
        elif sign > 0:
            if M < 0:
                return [], True
            if m >= 0:
                continue
        else:  # kink tracker: only matters if it changes sign
            if m > 0 or M < 0:
                continue
        kept.append((c, sign))
    return kept, False


def _monotone_height(psis, lo, hi, ndim):
    """Direction in which every constraint is sign-definite monotone; returns
    (k, sigmas) or (None, None)."""
    best_k, best_margin, best_sig = None, 0.0, None
    for k in range(ndim):
        sigmas = []
        margin = np.inf
        ok = True
        for c, _ in psis:
            dc = _derivative(c, k, hi[k] - lo[k])
            dmin, dmax = dc.min(), dc.max()
            if dmin > 0:
                sigmas.append(1)
                margin = min(margin, dmin)
            elif dmax < 0:
                sigmas.append(-1)
                margin = min(margin, -dmax)
            else:
                ok = False
                break
        if ok and margin > best_margin:
            best_k, best_margin, best_sig = k, margin, sigmas
    return best_k, best_sig


def _columns_1d(psis, base_t, k, ndim):
    """Column (1-D Bernstein) restrictions of each constraint at the unit base
    points ``base_t`` (nb, ndim-1): list of (cs (nb, deg+1), sign)."""
    base_dims = [d for d in range(ndim) if d != k]
    out = []
    for c, sign in psis:
        cs = np.moveaxis(c, k, -1)
        cs = np.broadcast_to(cs, (base_t.shape[0],) + cs.shape)
        for j, d in enumerate(base_dims):
            B = _basis(cs.shape[1] - 1, base_t[:, j])
            cs = np.einsum("pi,pi...->p...", B, cs)
        out.append((np.ascontiguousarray(cs), sign))
    return out


def _interval_quad_1d(col_psis, order):
    """Per-column 1-D quadrature of the member region on the unit interval.

    ``col_psis``: list of (values (nb, deg+1), sign), each column monotone.
    Returns (t_nodes (nb, nseg*order), w_nodes) with zero weights on
    non-member segments.
    """
    nb = col_psis[0][0].shape[0]
    npsi = len(col_psis)
    # one root per (column, constraint); clamp no-crossing columns to an end
    roots = np.ones((nb, npsi))
    for i, (cs, _) in enumerate(col_psis):
        crosses = (cs[:, 0] < 0) != (cs[:, -1] < 0)
        r = _roots_1d_batch(cs)
        roots[:, i] = np.where(crosses, r, np.where(cs[:, 0] < 0, 1.0, 1.0))
        # no-crossing columns: the constraint has constant sign; root placed at 1
        # (segment structure unaffected)
    cuts = np.concatenate(
        [np.zeros((nb, 1)), np.sort(roots, axis=1), np.ones((nb, 1))], axis=1
    )  # (nb, npsi+2)
    x, w = _gauss(order)
    nseg = cuts.shape[1] - 1
    t_all = np.empty((nb, nseg * len(x)))
    w_all = np.zeros((nb, nseg * len(x)))
    for si in range(nseg):
        a = cuts[:, si]
        b = cuts[:, si + 1]
        mid = 0.5 * (a + b)
        member = np.ones(nb, dtype=bool)
        for cs, sign in col_psis:
            if sign == 0:
                continue
            B = _basis(cs.shape[1] - 1, mid)
            v = np.einsum("ij,ij->i", B, cs)
            member &= (v <= 0) if sign < 0 else (v >= 0)
        seg = b - a
        sl = slice(si * len(x), (si + 1) * len(x))
        t_all[:, sl] = a[:, None] + x[None, :] * seg[:, None]
        w_all[:, sl] = np.where(member[:, None], w[None, :] * seg[:, None], 0.0)
    return t_all, w_all


def _quadgen_region(psis, lo, hi, order, depth):
    """Quadrature of the region {s_i psi_i <= / >= 0} on [lo, hi] (Saye-style
    dimension reduction with signed constraints; sign-0 constraints track
    integrand kinks without constraining membership)."""
    ndim = lo.shape[0]
    empty = (np.zeros((0, ndim)), np.zeros((0,)))
    psis, is_empty = _prune(psis)
    if is_empty:
        return empty
    if not psis:
        return _tensor_gauss(lo, hi, order, ndim)

    if ndim == 1:
        t, w = _interval_quad_1d([(c[None, :], s) for c, s in psis], order)
        pts = lo[0] + t[0] * (hi[0] - lo[0])
        return pts[:, None], w[0] * (hi[0] - lo[0])

    k, sigmas = _monotone_height(psis, lo, hi, ndim)
    if k is None:
        if depth >= _MAX_DEPTH:
            # critical-point fallback: midpoint membership decides the box
            mid_ok = all(
                _member(_eval_point(c, (0.5,) * ndim), s) for c, s in psis
            )
            return _tensor_gauss(lo, hi, order, ndim) if mid_ok else empty
        axis = int(np.argmax(hi - lo))
        cl_cr = [_split(c, axis) for c, _ in psis]
        mid = 0.5 * (lo[axis] + hi[axis])
        hi_l = hi.copy(); hi_l[axis] = mid
        lo_r = lo.copy(); lo_r[axis] = mid
        p1, w1 = _quadgen_region(
            [(cc[0], s) for cc, (_, s) in zip(cl_cr, psis)], lo, hi_l, order, depth + 1
        )
        p2, w2 = _quadgen_region(
            [(cc[1], s) for cc, (_, s) in zip(cl_cr, psis)], lo_r, hi, order, depth + 1
        )
        return np.concatenate([p1, p2]), np.concatenate([w1, w2])

    # reduce: necessary-condition face keeps the sign, other face tracks kinks
    base_psis = []
    for (c, sign), sigma in zip(psis, sigmas):
        bot = _face(c, k, 0)
        top = _face(c, k, 1)
        if sign == 0:
            base_psis += [(bot, 0), (top, 0)]
        elif (sign < 0) == (sigma > 0):
            base_psis += [(bot, sign), (top, 0)]
        else:
            base_psis += [(top, sign), (bot, 0)]

    base_dims = [d for d in range(ndim) if d != k]
    base_lo = lo[base_dims]
    base_hi = hi[base_dims]
    bpts, bwts = _quadgen_region(base_psis, base_lo, base_hi, order, depth)
    if len(bwts) == 0:
        return empty
    # unit base coordinates of the base nodes
    base_t = (bpts - base_lo) / (base_hi - base_lo)
    col_psis = _columns_1d(psis, base_t, k, ndim)
    t_col, w_col = _interval_quad_1d(col_psis, order)

    nb, nn = t_col.shape
    pts = np.empty((nb * nn, ndim))
    for j, d in enumerate(base_dims):
        pts[:, d] = np.repeat(bpts[:, j], nn)
    pts[:, k] = (lo[k] + t_col * (hi[k] - lo[k])).ravel()
    wts = (bwts[:, None] * w_col * (hi[k] - lo[k])).ravel()
    keep = wts != 0
    return pts[keep], wts[keep]


def _quadgen_surface(coeffs, lo, hi, order, depth):
    """Surface quadrature of {phi = 0} on the box: one explicit reduction, the
    base handled by the constrained region quadrature."""
    ndim = coeffs.ndim
    empty = (np.zeros((0, ndim)), np.zeros((0,)))
    m, M = coeffs.min(), coeffs.max()
    if m > 0 or M < 0:
        return empty
    k, sigmas = _monotone_height([(coeffs, -1)], lo, hi, ndim)
    if k is None:
        if depth >= _MAX_DEPTH:
            return empty  # tiny critical-point patch
        axis = int(np.argmax(hi - lo))
        cl, cr = _split(coeffs, axis)
        mid = 0.5 * (lo[axis] + hi[axis])
        hi_l = hi.copy(); hi_l[axis] = mid
        lo_r = lo.copy(); lo_r[axis] = mid
        p1, w1 = _quadgen_surface(cl, lo, hi_l, order, depth + 1)
        p2, w2 = _quadgen_surface(cr, lo_r, hi, order, depth + 1)
        return np.concatenate([p1, p2]), np.concatenate([w1, w2])

    sigma = sigmas[0]
    bot = _face(coeffs, k, 0)
    top = _face(coeffs, k, 1)
    # base region where the column has a root: lower-end value <= 0 <= upper-end
    if sigma > 0:
        base_psis = [(bot, -1), (top, +1)]
    else:
        base_psis = [(top, -1), (bot, +1)]
    base_dims = [d for d in range(ndim) if d != k]
    base_lo = lo[base_dims]
    base_hi = hi[base_dims]
    bpts, bwts = _quadgen_region(base_psis, base_lo, base_hi, order, 0)
    if len(bwts) == 0:
        return empty
    base_t = (bpts - base_lo) / (base_hi - base_lo)
    (cs, _), = _columns_1d([(coeffs, -1)], base_t, k, ndim)
    roots = _roots_1d_batch(cs)

    nb = bpts.shape[0]
    pts = np.empty((nb, ndim))
    for j, d in enumerate(base_dims):
        pts[:, d] = bpts[:, j]
    pts[:, k] = lo[k] + roots * (hi[k] - lo[k])
    t_unit = np.empty((nb, ndim))
    for j, d in enumerate(base_dims):
        t_unit[:, d] = base_t[:, j]
    t_unit[:, k] = roots
    grad2 = np.zeros(nb)
    dk = None
    for d in range(ndim):
        dc = _derivative(coeffs, d, hi[d] - lo[d])
        g = _eval_batch(dc, t_unit)
        grad2 = grad2 + g**2
        if d == k:
            dk = np.abs(g)
    wts = bwts * np.sqrt(grad2) / np.maximum(dk, 1e-300)
    return pts, wts


def _quadgen(coeffs, lo, hi, order, surface, depth):
    lo = np.asarray(lo, float)
    hi = np.asarray(hi, float)
    if surface:
        return _quadgen_surface(np.asarray(coeffs, float), lo, hi, order, depth)
    return _quadgen_region([(np.asarray(coeffs, float), -1)], lo, hi, order, depth)


def cell_quadrature(coeffs: np.ndarray, lo, hi, order: int, surface: bool):
    """Quadrature of ``{phi < 0}`` / ``{phi = 0}`` for one Bernstein patch."""
    return _quadgen(np.asarray(coeffs, float), lo, hi, order, surface, 0)


def quadrature(
    phi,
    *,
    interpolation_order: int = 3,
    quadrature_order: int = 4,
    surface: bool = False,
):
    """Per-cut-cell quadratures of the implicit domain (reference
    ``LSM.quadrature``): returns ``{cell multi-index: (points, weights)}``.

    ``phi`` may be a MeshField (wrapped at ``interpolation_order``) or an
    :class:`InterpolatedField`. Narrow-band volume integrals are rejected
    (interior cells are not in the band — reference parity,
    ``ImplicitIntegrationExt.jl:92-101``).
    """
    from ..core.narrowband import NarrowBandField

    if isinstance(phi, InterpolatedField):
        cf = phi
    else:
        cf = InterpolatedField(phi, interpolation_order)
    base = cf.field
    if isinstance(base, NarrowBandField) and not surface:
        raise ValueError(
            "volume integrals (surface=False) are not supported on a narrow band; "
            "use a full MeshField, or surface=True for surface integrals"
        )

    grid = cf.grid
    ndim = grid.ndim
    coeffs = np.asarray(cf.coeffs)
    cells_shape = grid.cells_shape
    flat = coeffs.reshape((-1,) + coeffs.shape[ndim:])
    mins = flat.reshape(flat.shape[0], -1).min(-1)
    maxs = flat.reshape(flat.shape[0], -1).max(-1)
    if surface:
        candidates = np.where(~((mins * maxs) > 0))[0]
    else:
        candidates = np.where(~(mins > 0))[0]

    if isinstance(base, NarrowBandField):
        import itertools

        m = np.asarray(base.active_mask)
        corners_all = np.ones(cells_shape, bool)
        for c in itertools.product((0, 1), repeat=ndim):
            idx = tuple(slice(ci, ci + n) for ci, n in zip(c, cells_shape))
            corners_all &= m[idx]
        mask_flat = corners_all.reshape(-1)
        candidates = np.asarray([i for i in candidates if mask_flat[i]])

    h = np.asarray(grid.spacing)
    glo = np.asarray(grid.lo)
    out = {}
    for flat_idx in candidates:
        cell = np.unravel_index(flat_idx, cells_shape)
        lo = glo + np.asarray(cell) * h
        hi = lo + h
        pts, wts = cell_quadrature(flat[flat_idx], lo, hi, quadrature_order, surface)
        if len(wts):
            out[tuple(int(c) for c in cell)] = (pts, wts)
    return out


def integrate(f, quads) -> float:
    """Sum ``f`` over all per-cell quadratures; ``f`` maps (npts, ndim) -> (npts,)
    (``None``: the constant 1, i.e. the measure)."""
    total = 0.0
    for pts, wts in quads.values():
        vals = f(pts) if f is not None else 1.0
        total += float(np.sum(wts * vals))
    return total
