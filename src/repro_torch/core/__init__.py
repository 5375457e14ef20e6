"""The policy and autotune layer on Hopper (the reference's ``repro.core``).

* :mod:`.tiles` -- shared-memory and register budgets, the legal tiles
* :mod:`.grid_swizzle` -- Algorithm 1, the GEMM kernels' walk window
* :mod:`.cache_model` -- the cache simulator (Tab. 4 / Eq. 1), H100's L2
* :mod:`.schedule` -- the producer/consumer warpgroup schedule
* :mod:`.perf_model` -- H100 roofline constants, the chain byte models
* :mod:`.policy` -- KernelPolicy: tiles x splits x window x dtypes x chains
* :mod:`.autotune` -- candidates, the analytic ranking, pretuned tables
* :mod:`.calibrate` -- measured tables: the card's wall clock, the drift gate
"""
from .tiles import TileSpec, native_tiling, is_aligned  # noqa: F401
from .grid_swizzle import SwizzleConfig, ROW_MAJOR  # noqa: F401
from .schedule import (Schedule, PINGPONG, INTERLEAVE,  # noqa: F401
                       WAVE_SPECIALIZED, get_schedule)
from .perf_model import H100, ChipSpec, roofline, RooflineTerms  # noqa: F401
from .policy import KernelPolicy, make_policy  # noqa: F401
from .autotune import (OpSignature, candidate_policies, score_policy,  # noqa: F401
                       select_policy, policy_cache_stats, clear_policy_cache,
                       policies_for_model)
