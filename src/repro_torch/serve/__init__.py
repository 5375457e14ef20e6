from .engine import (Engine, GenerationResult, PagedEngine,  # noqa: F401
                     Request, RequestQueue)
from .topology import ShardedPagedEngine  # noqa: F401
