"""dinunet-tpu on PyTorch and CUDA: the port of ``dinunet_implementations_tpu``
to one NVIDIA H100.

It mirrors the JAX package's layout (``models/``, ``ops/``, ``serving/``,
``trainer/``, ``runner/``), so each module sits at the relative path of the
module it is held against, and imports nothing of the JAX package. The
first slice serves the ICA-LSTM classifier through a hand-written CUDA
kernel for the LSTM recurrence (``ops/lstm_cuda.py``, ``csrc/lstm_fwd.cu``).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from .core.config import ICAArgs, NNComputation, TrainConfig
from .models.icalstm import ICALstm
from .serving import InferenceEngine
from .weights import icalstm_params_from_jax

__all__ = [
    "ICAArgs",
    "ICALstm",
    "InferenceEngine",
    "NNComputation",
    "TrainConfig",
    "icalstm_params_from_jax",
]
