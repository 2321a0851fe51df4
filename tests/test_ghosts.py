"""Ghost-cell fill for every boundary-condition kind, against an independent
numpy oracle: ``MeshField.pad``, the narrow band's pad, and the sharded halo
pads (``HaloField`` / ``ShardedNarrowBandField`` under ``shard_map`` on the
8-device CPU mesh, where interior faces come from ``ppermute``).

The oracle builds each ghost layer from the reference's definitions
(``boundaryconditions.jl:90-153``): periodic wrap with the duplicated endpoint,
mirror about the boundary node, and degree-P extrapolation by evaluating the
interpolating polynomial of the P+1 boundary nodes (a Vandermonde solve, not
the library's closed-form Lagrange weights).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

import lsm_tpu as lsm
from lsm_tpu.core import bc as B
from lsm_tpu.core.narrowband import NarrowBandField
from lsm_tpu.parallel import HaloField, ShardedNarrowBandField, make_mesh

SHAPE = (16, 8, 7)
MESH_SHAPE = (4, 2)

CASES = {
    "periodic": B.Periodic(),
    "symmetry": B.Symmetry(),
    "neumann": B.Extrapolation(0),
    "linear": B.Extrapolation(1),
    "quadratic": B.Extrapolation(2),
    "cubic": B.Extrapolation(3),
    "mixed-periodic": [(B.Symmetry(), B.Extrapolation(1)), B.Periodic(),
                       (B.Extrapolation(3), B.Symmetry())],
    "mixed": [(B.Symmetry(), B.Extrapolation(1)), B.Extrapolation(3),
              (B.Extrapolation(2), B.Symmetry())],
}
BAND_CASES = [k for k, v in CASES.items() if "periodic" not in k]


def _ghost_np(v, bc, axis, k, side):
    """Ghost value at distance ``k`` outside one face of ``axis``."""
    n = v.shape[axis]
    take = lambda i: np.take(v, i, axis=axis)
    if isinstance(bc, B.Periodic):
        return take(n - 1 - k if side == "left" else k)
    if isinstance(bc, B.Symmetry):
        return take(k if side == "left" else n - 1 - k)
    deg = bc.degree
    nodes = np.arange(deg + 1)
    vander = np.vander(nodes.astype(float), deg + 1, increasing=True)
    coef_of_values = np.linalg.inv(vander)  # polynomial coefficients from values
    basis = coef_of_values.T @ (float(-k) ** np.arange(deg + 1))
    idx = nodes if side == "left" else n - 1 - nodes
    return sum(w * take(i) for w, i in zip(basis, idx))


def _pad_np(v, bcs, width):
    v = np.asarray(v, np.float64)
    for axis, (left, right) in enumerate(bcs):
        lo = [_ghost_np(v, left, axis, k, "left") for k in range(width, 0, -1)]
        hi = [_ghost_np(v, right, axis, k, "right") for k in range(1, width + 1)]
        v = np.concatenate([np.expand_dims(g, axis) for g in lo] + [v]
                           + [np.expand_dims(g, axis) for g in hi], axis=axis)
    return v


def _values():
    rng = np.random.default_rng(0)
    return jnp.asarray(rng.standard_normal(SHAPE))


def _sphere_values():
    """A signed distance whose band touches every face of the grid."""
    grid = lsm.Grid((0.0,) * 3, (1.0,) * 3, SHAPE)
    X, Y, Z = grid.dense_coords()
    return grid, jnp.sqrt((X - 0.1) ** 2 + (Y - 0.5) ** 2 + (Z - 0.9) ** 2) - 0.45


def _bcs(case):
    return B.normalize_bcs(CASES[case], 3)


@pytest.mark.parametrize("width", [1, 2, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_meshfield_pad(case, width):
    grid = lsm.Grid((0.0,) * 3, (1.0,) * 3, SHAPE)
    v = _values()
    phi = lsm.MeshField(v, grid, _bcs(case))
    np.testing.assert_allclose(np.asarray(phi.pad(width)),
                               _pad_np(v, _bcs(case), width), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", BAND_CASES)
def test_band_pad(case):
    grid, v = _sphere_values()
    nb = NarrowBandField(v, grid, _bcs(case), nlayers=3, _normalized=True)
    assert 0 < int(nb.active_count()) < v.size
    np.testing.assert_allclose(np.asarray(nb.pad(3)), _pad_np(v, _bcs(case), 3),
                               rtol=1e-12, atol=1e-12)


def _sharded_pad(make_local, leaves):
    mesh = make_mesh(8, mesh_shape=MESH_SHAPE, axis_names=("x", "y"))
    spec = P("x", "y", None)
    out_spec = P("x", "y", None)

    def local(*ls):
        return make_local(*ls).pad(3)

    padded = shard_map(local, mesh=mesh, in_specs=(spec,) * len(leaves),
                       out_specs=out_spec, check_vma=False)(*leaves)
    # reassemble: each shard returned its own padded block; strip and stitch
    n0, n1 = SHAPE[0] // MESH_SHAPE[0], SHAPE[1] // MESH_SHAPE[1]
    blocks = np.asarray(padded).reshape(
        MESH_SHAPE[0], n0 + 6, MESH_SHAPE[1], n1 + 6, SHAPE[2] + 6)
    return blocks, n0, n1


def _check_blocks(blocks, n0, n1, full):
    for i in range(MESH_SHAPE[0]):
        for j in range(MESH_SHAPE[1]):
            want = full[i * n0:i * n0 + n0 + 6, j * n1:j * n1 + n1 + 6, :]
            np.testing.assert_allclose(blocks[i, :, j], want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_halo_pad(case):
    """Each shard's padded block is the matching window of the global pad:
    interior faces from neighbours, physical faces from the BCs."""
    grid = lsm.Grid((0.0,) * 3, (1.0,) * 3, SHAPE)
    v = _values()
    bcs = _bcs(case)
    blocks, n0, n1 = _sharded_pad(
        lambda lv: HaloField(lv, grid, bcs, ("x", "y", None), (*MESH_SHAPE, 1)), (v,))
    _check_blocks(blocks, n0, n1, _pad_np(v, bcs, 3))


@pytest.mark.parametrize("case", BAND_CASES)
def test_sharded_band_pad(case):
    grid, v = _sphere_values()
    bcs = _bcs(case)
    nb = NarrowBandField(v, grid, bcs, nlayers=3, _normalized=True)

    def make(lv, m, cm):
        return ShardedNarrowBandField(lv, grid, bcs, m, 3, cm, ("x", "y", None),
                                      (*MESH_SHAPE, 1))

    blocks, n0, n1 = _sharded_pad(make, (v, nb.mask, nb.compute_mask))
    _check_blocks(blocks, n0, n1, _pad_np(v, bcs, 3))
