"""hifir_tpu — a multilevel ILU (HIF) preconditioning framework in JAX.

The factorization runs on the host (native C++ kernels); the preconditioner
apply and the Krylov solvers run on the accelerator (one H100, or four over
NVLink).  Brand-new JAX/XLA implementation with the capabilities of the
reference ``hifirworks/hifir`` C++ library (multilevel incomplete LDU with
scalability-oriented dropping and inverse-based condition control, wrapped in
iterative refinement and Krylov drivers).  See SURVEY.md for the layer map.
"""

from .version import __version__, version
from .options import (Options, Params, get_default_options,
                      REORDER_OFF, REORDER_AUTO, REORDER_AMD, REORDER_RCM,
                      PIVOTING_OFF, PIVOTING_ON, PIVOTING_AUTO,
                      VERBOSE_NONE, VERBOSE_WARN, VERBOSE_INFO, VERBOSE_PRE, VERBOSE_FAC,
                      VERBOSE_PRE_TIME, VERBOSE_MEM, VERBOSE_INFO2)
from .ds import CSR
from .api import HIF
from .nsp import NspFilter
from . import capi
