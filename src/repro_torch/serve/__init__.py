"""Serving of the port: paged KV cache, prompt-prefix cache, open-loop
workloads, the continuous-batching engine (whole-prompt or chunked
prefill, greedy or nucleus sampling) and its parameter handles (frozen, or
live under a trainer's publishes)."""
from .engine import FinishedRequest, ServeConfig, ServeEngine, ServeReport
from .live_db import (LiveParamDB, ReadRecord, StaticParams, serving_leaf,
                      serving_params)
from .paged_cache import (PageAllocator, init_paged_cache, make_activate_fn,
                          make_copy_page_fn, make_evict_fn, make_join_fn,
                          page_classes)
from .prefix_cache import PrefixCache
from .workload import Request, open_loop_requests, shared_prefix_requests

__all__ = ["FinishedRequest", "LiveParamDB", "PageAllocator", "PrefixCache",
           "ReadRecord", "Request", "ServeConfig", "ServeEngine",
           "ServeReport", "StaticParams",
           "init_paged_cache", "make_activate_fn", "make_copy_page_fn",
           "make_evict_fn", "make_join_fn", "open_loop_requests",
           "page_classes", "serving_leaf", "serving_params",
           "shared_prefix_requests"]
