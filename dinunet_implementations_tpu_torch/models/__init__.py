from .icalstm import BiLSTM, ICALstm, LSTMCell
from .layers import BatchNorm, TorchLinearInit, compute_dtype_of, dense, masked_moments

__all__ = [
    "BatchNorm",
    "BiLSTM",
    "ICALstm",
    "LSTMCell",
    "TorchLinearInit",
    "compute_dtype_of",
    "dense",
    "masked_moments",
]
