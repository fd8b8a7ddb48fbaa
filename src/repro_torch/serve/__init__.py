"""Serving of the port: paged KV cache, open-loop workload and the
continuous-batching engine (whole-prompt prefill, greedy decoding)."""
from .engine import FinishedRequest, ServeConfig, ServeEngine, ServeReport
from .live_db import StaticParams, serving_params
from .paged_cache import (PageAllocator, init_paged_cache, make_evict_fn,
                          make_join_fn, page_classes)
from .workload import Request, open_loop_requests

__all__ = ["FinishedRequest", "PageAllocator", "Request", "ServeConfig",
           "ServeEngine", "ServeReport", "StaticParams", "init_paged_cache",
           "make_evict_fn", "make_join_fn", "open_loop_requests",
           "page_classes", "serving_params"]
