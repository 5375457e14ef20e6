from .epilogue import EPILOGUE_NONE, Epilogue, rope_rotate  # noqa: F401
from .prologue import PROLOGUE_NONE, Prologue, norm_prologue  # noqa: F401
from .ref import gemm_fused_ref  # noqa: F401
from .ops import KERNEL, gemm_fused  # noqa: F401
