from .icalstm import BiLSTM, ICALstm, ICALstmStream, LSTMCell
from .layers import BatchNorm, TorchLinearInit, compute_dtype_of, dense, masked_moments
from .msannet import MSANNet

__all__ = [
    "BatchNorm",
    "BiLSTM",
    "ICALstm",
    "ICALstmStream",
    "LSTMCell",
    "MSANNet",
    "TorchLinearInit",
    "compute_dtype_of",
    "dense",
    "masked_moments",
]
