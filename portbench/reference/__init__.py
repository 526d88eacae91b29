"""The plain reference of the benchmark: the level-0 operator, the divergence
right-hand side, the residual and the velocity projection of the
nonhydrostatic pressure equation on a terrain-following grid, in plain
PyTorch, in the precision of its inputs (float64 for the check).

It follows the reference Fortran solver mgroms (``mg_zr_zw.f90``,
``mg_define_matrix.f90``, ``mg_compute_rhs.f90``, ``mg_relax.f90``
``compute_residual_3D_8``, ``mg_correct_uvw.f90``) through a frozen copy of
the term order of the program's level-0 assembly, physical walls on all four
sides, no land mask.  It imports torch alone: nothing of the program under
test, nothing of JAX.  It works the operator and the right-hand side out
from the case fields and the velocities the benchmark hands to both sides,
and reads the program's pressure and velocities only to judge them.
"""

from .operator import Metrics, assemble, residual         # noqa: F401
from .physics import divergence, project                  # noqa: F401
