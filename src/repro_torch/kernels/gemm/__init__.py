from .epilogue import EPILOGUE_NONE, Epilogue, rope_rotate  # noqa: F401
from .prologue import PROLOGUE_NONE, Prologue, norm_prologue  # noqa: F401
from .ref import (gemm_fused_ref, ln_rows_ref, norm_rows_ref,  # noqa: F401
                  rms_rows_ref)
from .ops import (BWD_MODES, KERNEL, check_backward,  # noqa: F401
                  check_chain, default_bwd_mode, gemm_fused, kernel_saves,
                  rope_store_fits)
from .ref import gemm_fused_bwd_ref  # noqa: F401
from .backward import (DA_KERNEL, DB_KERNEL, G_KERNEL,  # noqa: F401
                       gemm_bwd_da_ref, gemm_bwd_db_ref, gemm_bwd_g_ref,
                       gemm_fused_bwd)
