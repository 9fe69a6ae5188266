"""Device compute kernels: ELL SpMV, level-scheduled trsv (plain jnp/lax)."""
from .spmv import ELL, ell_from_csr, ell_matvec, ell_matvec_mrhs
from .trsv import TrsvSchedule, build_trsv_schedule, trsv_apply, trsv_apply_mrhs
