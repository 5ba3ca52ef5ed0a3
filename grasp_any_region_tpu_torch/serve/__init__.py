from .engine import ContinuousBatchingEngine, EngineConfig, StepEvent  # noqa: F401
from .paged_cache import PageAllocator, PagedKV, init_paged_kv  # noqa: F401
from .server import GARServer  # noqa: F401
