"""lsm_tpu — a differentiable level-set engine in JAX.

A JAX/XLA implementation of the capabilities of ``maltezfaria/LevelSetMethods.jl``:
implicit interfaces as zero contours of a level-set function on a uniform
Cartesian grid, evolved by Hamilton-Jacobi PDEs ``phi_t + sum_n term_n = 0``
(Osher & Fedkiw), with whole-array stencils that XLA fuses, device-mesh
sharding with halo exchange, and end-to-end differentiability (the WENO5
advection Hamiltonian carries a hand-derived adjoint).

Public API (mirrors the reference's 34 exports, snake_cased where idiomatic):
see ``SURVEY.md`` section 1 for the layer map this build follows.
"""

from .core.grid import Grid
from .core.bc import (
    BoundaryCondition,
    Periodic,
    Extrapolation,
    Neumann,
    LinearExtrapolation,
    Symmetry,
    normalize_bcs,
)
from .core.field import MeshField, sample
from .core.narrowband import NarrowBandField
from .terms.terms import (
    AdvectionTerm,
    NormalMotionTerm,
    CurvatureTerm,
    EikonalReinitializationTerm,
    compute_cfl,
)
from .integrators.explicit import ForwardEuler, RK2, RK3, TimeIntegrator
from .integrators.semi_implicit import SemiImplicitI2OE
from .integrators.loop import evolve, rollout, step
from .equation import LevelSetEquation
from .interp.interpolation import InterpolatedField
from .interp.sdf import NewtonSDF, reinitialize_newton, hausdorff_distance
from .reinit.eikonal import reinitialize
from .reinit.velocity_extension import extend_along_normals
from .geometry.quadrature import quadrature, integrate
from .geometry.queries import (
    volume,
    perimeter,
    curvature,
    gradient,
    grad_norm,
    normal,
    hessian,
    union,
    intersection,
    complement,
    difference,
    smooth_heaviside,
    smooth_delta,
)

__version__ = "0.1.0"

__all__ = [
    "Grid",
    "BoundaryCondition",
    "Periodic",
    "Extrapolation",
    "Neumann",
    "LinearExtrapolation",
    "Symmetry",
    "normalize_bcs",
    "MeshField",
    "NarrowBandField",
    "sample",
    "AdvectionTerm",
    "NormalMotionTerm",
    "CurvatureTerm",
    "EikonalReinitializationTerm",
    "compute_cfl",
    "ForwardEuler",
    "RK2",
    "RK3",
    "SemiImplicitI2OE",
    "TimeIntegrator",
    "evolve",
    "rollout",
    "step",
    "LevelSetEquation",
    "InterpolatedField",
    "NewtonSDF",
    "reinitialize_newton",
    "hausdorff_distance",
    "reinitialize",
    "extend_along_normals",
    "quadrature",
    "integrate",
    "volume",
    "perimeter",
    "curvature",
    "gradient",
    "grad_norm",
    "normal",
    "hessian",
    "union",
    "intersection",
    "complement",
    "difference",
    "smooth_heaviside",
    "smooth_delta",
]
