"""The subset of the training configuration that the serving slice reads.

Field names and defaults are those of the JAX package's ``core/config.py``
(``ICAArgs`` and the ``TrainConfig`` fields ``task_id``, ``ica_args`` and
``seed``). The port keeps its own copy: it imports nothing of the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass, field


class NNComputation:
    """Task identifiers (the reference's ``comps/__init__.py:7-10``)."""

    TASK_FREE_SURFER = "FS-Classification"
    TASK_ICA = "ICA-Classification"
    TASK_SMRI_3D = "sMRI-3D-Classification"
    TASK_MULTIMODAL = "Multimodal-Classification"

    ALL = (TASK_FREE_SURFER, TASK_ICA, TASK_SMRI_3D, TASK_MULTIMODAL)


@dataclass
class ICAArgs:
    """ICA classification parameters: 100 components, 980 timepoints cut
    into windows of 10, an encoder to 256 and a BiLSTM of total width 348
    (the shipped workload's value)."""

    num_class: int = 2
    num_components: int = 100
    temporal_size: int = 980
    window_size: int = 10
    input_size: int = 256
    hidden_size: int = 348
    bidirectional: bool = True
    # "bfloat16" runs the encoder and LSTM products in bf16 with f32
    # accumulation; "" = full f32
    compute_dtype: str = ""


@dataclass
class TrainConfig:
    task_id: str = NNComputation.TASK_FREE_SURFER
    seed: int = 0
    ica_args: ICAArgs = field(default_factory=ICAArgs)
