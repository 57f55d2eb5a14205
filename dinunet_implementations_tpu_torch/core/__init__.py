from .config import ICAArgs, NNComputation, TrainConfig
from .device import resolve_device

__all__ = ["ICAArgs", "NNComputation", "TrainConfig", "resolve_device"]
