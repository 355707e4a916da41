"""Continuous-batching serving (DeepSpeed-MII / FastGen parity): requests,
the page pool and prefix cache, the SplitFuse scheduler, the metrics, the
speculative-decoding math, and the slot engine (``ServingEngine``, imported
on first use: the inference engine imports ``spec`` from this package)."""

from .metrics import ServingMetrics
from .paging import PagePool, PrefixCache, chain_hashes
from .request import Request, RequestState, RequestStatus, request_rng
from .scheduler import Scheduler, StepPlan

__all__ = ["PagePool", "PrefixCache", "Request", "RequestState", "RequestStatus",
           "Scheduler", "ServingEngine", "ServingMetrics", "StepPlan",
           "chain_hashes", "request_rng"]


def __getattr__(name):
    if name == "ServingEngine":
        from .engine import ServingEngine

        return ServingEngine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
