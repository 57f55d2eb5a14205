"""Serving: the batched lane of the ICA-LSTM inference engine."""

from .engine import InferenceEngine, ServingError
from .microbatch import Microbatcher, RequestError, RequestFuture, ServingClosed

__all__ = [
    "InferenceEngine",
    "Microbatcher",
    "RequestError",
    "RequestFuture",
    "ServingClosed",
    "ServingError",
]
