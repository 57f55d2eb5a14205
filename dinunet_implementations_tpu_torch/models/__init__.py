from .cnn3d import SMRI3DNet, space_to_depth_222
from .icalstm import BiLSTM, ICALstm, ICALstmStream, LSTMCell
from .layers import (
    BatchNorm,
    LayerNorm,
    TorchLinearInit,
    compute_dtype_of,
    dense,
    masked_moments,
)
from .msannet import MSANNet
from .transformer import MultimodalNet, dot_product_attention

__all__ = [
    "BatchNorm",
    "BiLSTM",
    "ICALstm",
    "ICALstmStream",
    "LayerNorm",
    "LSTMCell",
    "MSANNet",
    "MultimodalNet",
    "SMRI3DNet",
    "TorchLinearInit",
    "compute_dtype_of",
    "dense",
    "dot_product_attention",
    "masked_moments",
    "space_to_depth_222",
]
