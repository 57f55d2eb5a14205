"""dinunet-tpu on PyTorch and CUDA: the port of ``dinunet_implementations_tpu``
to one NVIDIA H100.

It mirrors the JAX package's layout (``models/``, ``ops/``, ``serving/``,
``trainer/``, ``runner/``, ``data/``, ``engines/``, …), so each module sits
at the relative path of the module it is held against, and imports nothing
of the JAX package. It serves the FreeSurfer MLP (MSANNet, the default
task), the ICA-LSTM classifier (for the unidirectional one also as a
stream, per session; with hot-swaps, publish and rollback, and a replica
fleet: ``serving/``), the 3D-CNN of sMRI volumes (SMRI3DNet) and the
multimodal FS+ICA transformer (MultimodalNet), and trains them by federated dSGD,
rankDAD or powerSGD with every site on one card (from Python,
``runner.FedRunner`` / ``runner.SiteRunner``, or the command line,
``python -m dinunet_implementations_tpu_torch.runner.cli``), through
hand-written CUDA kernels for the LSTM recurrence forward and backward
(``ops/lstm_cuda.py``, ``csrc/lstm_fwd.cu``, ``csrc/lstm_bwd.cu``) and for
rankDAD's power iteration (``ops/poweriter_cuda.py``,
``csrc/poweriter.cu``). Entry points run on the card unless the caller
passes ``device="cpu"``.
"""

from .core.config import (
    FSArgs,
    ICAArgs,
    MultimodalArgs,
    NNComputation,
    SMRI3DArgs,
    TrainConfig,
)
from .models.cnn3d import SMRI3DNet
from .models.icalstm import ICALstm
from .models.msannet import MSANNet
from .models.transformer import MultimodalNet
from .serving import InferenceEngine
from .weights import params_from_jax

#: the package version, the project's (pyproject.toml), written into the
#: telemetry manifest
__version__ = "0.18.0"

__all__ = [
    "FSArgs",
    "ICAArgs",
    "ICALstm",
    "InferenceEngine",
    "MSANNet",
    "MultimodalArgs",
    "MultimodalNet",
    "NNComputation",
    "SMRI3DArgs",
    "SMRI3DNet",
    "TrainConfig",
    "params_from_jax",
]
