"""Node-centered fields on a Cartesian grid.

JAX analogue of the reference's dense ``MeshField``
(``/root/reference/src/meshfield.jl:33-312``): values are a dense ``jnp`` array (the
*dynamic* pytree leaf), while the grid and the normalized boundary conditions are
static metadata. Vector-valued fields (the reference's ``SVector`` values,
``meshfield.jl:3-9``) are stored with a leading component axis of length ``ndim``.

Out-of-grid "ghost" reads happen through :func:`lsm_tpu.core.bc.pad_ghost` — a field
exposes ``pad(width)`` returning the ghost-extended array every stencil consumes.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from .bc import bcs_str, normalize_bcs, pad_ghost
from .grid import Grid

__all__ = ["MeshField", "sample"]


@jax.tree_util.register_pytree_node_class
class MeshField:
    """Dense node-centered field: ``values`` + static ``grid`` and ``bcs``.

    ``values.shape == grid.shape`` for scalar fields, or ``(ndim, *grid.shape)``
    for vector fields (leading component axis).
    """

    def __init__(self, values: jnp.ndarray, grid: Grid, bcs=None, _normalized=False):
        if not _normalized:
            bcs = normalize_bcs(bcs, grid.ndim)
        self.values = values
        self.grid = grid
        self.bcs = bcs

    # -- pytree protocol ----------------------------------------------------------

    def tree_flatten(self):
        return (self.values,), (self.grid, self.bcs)

    @classmethod
    def tree_unflatten(cls, aux, children):
        grid, bcs = aux
        return cls(children[0], grid, bcs, _normalized=True)

    # -- basic protocol -----------------------------------------------------------

    @property
    def ndim(self) -> int:
        return self.grid.ndim

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.grid.shape

    @property
    def is_vector(self) -> bool:
        return self.values.ndim == self.grid.ndim + 1

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def spacing(self) -> Tuple[float, ...]:
        return self.grid.spacing

    def has_bcs(self) -> bool:
        return self.bcs is not None

    @property
    def active_mask(self):
        """Boolean active-node mask, or None when every node is active (dense)."""
        return None

    def update_band(self):
        """Re-tube the narrow band; no-op on a full grid (reference
        ``update_band!(phi::AbstractMeshField)``)."""
        return self

    def with_bcs(self, bc, *, replace: bool = False) -> "MeshField":
        """Return a copy with boundary conditions attached (reference
        ``_add_boundary_conditions``, ``meshfield.jl:150-153``)."""
        if self.bcs is not None and not replace:
            raise ValueError("field already has boundary conditions")
        return MeshField(self.values, self.grid, normalize_bcs(bc, self.ndim), _normalized=True)

    def with_values(self, values: jnp.ndarray) -> "MeshField":
        return MeshField(values, self.grid, self.bcs, _normalized=True)

    def pad(self, width: int) -> jnp.ndarray:
        """Ghost-padded values array with ``width`` layers on every side.

        Vector fields pad the spatial axes only; the component axis is untouched.
        """
        if self.bcs is None:
            raise ValueError(
                "field has no boundary conditions; stencils reaching off-grid need them"
            )
        if self.is_vector:
            bcs = ((None, None),) + self.bcs  # axis 0 is the component axis
            return pad_ghost(self.values, bcs, width, axes=range(1, self.values.ndim))
        return pad_ghost(self.values, self.bcs, width)

    # -- convenience --------------------------------------------------------------

    def map(self, fn: Callable[[jnp.ndarray], jnp.ndarray]) -> "MeshField":
        return self.with_values(fn(self.values))

    def __neg__(self) -> "MeshField":
        return self.with_values(-self.values)

    def __repr__(self) -> str:
        kind = "vector" if self.is_vector else "scalar"
        nodes = " x ".join(str(n) for n in self.shape)
        return (
            f"MeshField ({kind}, {self.values.dtype})\n"
            f"  |- grid: {nodes} nodes in R^{self.ndim}\n"
            f"  `- bcs:  {bcs_str(self.bcs)}"
        )


def sample(
    fn: Callable,
    grid: Grid,
    bc=None,
    dtype=None,
    vector: bool = False,
) -> MeshField:
    """Sample ``fn`` at the grid nodes into a :class:`MeshField`.

    ``fn`` receives the tuple of (broadcastable) coordinate arrays and must return a
    single array (scalar field) or a length-``ndim`` sequence of arrays (vector
    field). Mirrors the function-sampling constructor ``meshfield.jl:178-211``.
    """
    dtype = dtype or jnp.result_type(float)
    xs = grid.coords(dtype=dtype)
    out = fn(*xs)
    if vector or isinstance(out, (tuple, list)):
        comps = [jnp.broadcast_to(jnp.asarray(c, dtype=dtype), grid.shape) for c in out]
        values = jnp.stack(comps, axis=0)
    else:
        values = jnp.broadcast_to(jnp.asarray(out, dtype=dtype), grid.shape)
    return MeshField(values, grid, bc)
