"""Serving stack of the port: paged KV allocator, the reference's
host-Python scheduler, the eager PyTorch executor with the CUDA/Triton
kernels, sampling, speculative proposers and the fault-tolerance layer,
behind the ``ServingEngine`` facade; the async streaming front door
(``AsyncFrontend``) over it, and the legacy engine kept as the measured
baseline."""

from . import errors
from .engine import ServingEngine
from .errors import (AdmissionRejected, BackpressureRejected,
                     BucketOverflow, DeadlineExceeded, FaultInjected,
                     PoolExhausted, RequestFailed, ServingError)
from .executor import Executor
from .faults import FaultInjector, FaultSpec
from .frontend import AsyncFrontend, StreamEvent
from .kv_cache import PagedKVCache, PagePool
from .legacy import LegacyServingEngine
from .sampling import SamplingParams
from .scheduler import Request, RequestState, Scheduler, StepPlan
from .spec import DraftModelProposer, FixedProposer, NgramProposer, \
    Proposer
from .watchdog import Violation, Watchdog

__all__ = ["ServingEngine", "PagedKVCache", "PagePool", "Scheduler",
           "Executor", "Request", "StepPlan", "RequestState", "errors",
           "ServingError", "AdmissionRejected", "BackpressureRejected",
           "PoolExhausted", "BucketOverflow", "DeadlineExceeded",
           "RequestFailed", "FaultInjected", "FaultInjector", "FaultSpec",
           "Watchdog", "Violation", "SamplingParams", "Proposer",
           "NgramProposer", "FixedProposer", "DraftModelProposer",
           "AsyncFrontend", "StreamEvent", "LegacyServingEngine"]
