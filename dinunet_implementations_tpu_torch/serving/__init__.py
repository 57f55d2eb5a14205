"""Serving: the inference engine (a batched lane, and an O(1) streaming
lane for the unidirectional ICA-LSTM), the replicated fleet with sharded
session affinity, the publish plane (shadow scoring, hot-swap, rollback)
and the max-delay autotuner, each with the span tracer and the telemetry
sink; ``python -m dinunet_implementations_tpu_torch.serving`` is the
serving CLI (``__main__.py``)."""

from .admission import AutotunerDaemon, DelayAutotuner
from .engine import InferenceEngine, ServingError
from .fleet import ReplicaSet, home_slot
from .microbatch import (
    ChainedFuture,
    Microbatcher,
    RequestError,
    RequestFuture,
    ServingClosed,
)
from .publish import CheckpointWatcher, PublishController, PublishDaemon
from .session import SessionError, SessionTable, init_carry_table

__all__ = [
    "AutotunerDaemon",
    "ChainedFuture",
    "CheckpointWatcher",
    "DelayAutotuner",
    "InferenceEngine",
    "Microbatcher",
    "PublishController",
    "PublishDaemon",
    "ReplicaSet",
    "RequestError",
    "RequestFuture",
    "ServingClosed",
    "ServingError",
    "SessionError",
    "SessionTable",
    "home_slot",
    "init_carry_table",
]
