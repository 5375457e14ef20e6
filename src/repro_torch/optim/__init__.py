from .compression import compressed_psum, ef_compress, ef_init  # noqa: F401
from .optimizer import (AdamWConfig, adamw_init, adamw_update,  # noqa: F401
                        clip_by_global_norm, constant_schedule,
                        cosine_schedule, global_norm, wsd_schedule)
