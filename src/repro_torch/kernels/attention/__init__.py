from .epilogue import cap_logits, softmax_finalize  # noqa: F401
from .ref import attention_ref, decode_ref, ring_positions  # noqa: F401
from .ops import (KERNEL as FWD_KERNEL, attention,  # noqa: F401
                  flash_attention_fwd, flash_attention_fwd_ref)
from .decode import (BLOCK_KV, KERNEL as DECODE_KERNEL,  # noqa: F401
                     PAGED_KERNEL as DECODE_PAGED_KERNEL, attention_decode,
                     attention_decode_paged, combine_splits,
                     decode_partials_paged_ref, decode_partials_ref,
                     flash_decode, flash_decode_paged)
from .backward import (KERNEL as BWD_KERNEL, attention_delta,  # noqa: F401
                       flash_attention_bwd, flash_attention_bwd_ref)
