from .ref import (dropout_keep_mask_ref,  # noqa: F401
                  fused_dropout_residual_layernorm_ref, lowbias32)
from .kernel import KERNEL, fused_norm_launch  # noqa: F401
from .ops import dropout_residual_layernorm  # noqa: F401
