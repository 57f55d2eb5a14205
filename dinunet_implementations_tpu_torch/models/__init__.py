from .icalstm import BiLSTM, ICALstm, LSTMCell
from .layers import BatchNorm, TorchLinearInit, compute_dtype_of, dense, masked_moments
from .msannet import MSANNet

__all__ = [
    "BatchNorm",
    "BiLSTM",
    "ICALstm",
    "LSTMCell",
    "MSANNet",
    "TorchLinearInit",
    "compute_dtype_of",
    "dense",
    "masked_moments",
]
