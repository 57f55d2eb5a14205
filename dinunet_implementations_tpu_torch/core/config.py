"""The subset of the training configuration that the port reads.

Field names and defaults are those of the JAX package's ``core/config.py``
(``ICAArgs``, ``AggEngine`` and the ``TrainConfig`` fields that serving and
the dSGD and rankDAD training epochs read). The port keeps its own copy: it
imports nothing of the JAX package.
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


class AggEngine:
    """Aggregation engines (the reference's ``comps/__init__.py:13-16``);
    the port runs dSGD and rankDAD so far."""

    DECENTRALIZED_SGD = "dSGD"
    RANK_DAD = "rankDAD"
    POWER_SGD = "powerSGD"

    ALL = (DECENTRALIZED_SGD, RANK_DAD, POWER_SGD)


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
    # rankDAD (compspec.json:236-238): factor rank, power-iteration cap and
    # the relative σ-change tolerance of its early exit
    dad_reduction_rank: int = 10
    dad_num_pow_iters: int = 5
    dad_tol: float = 1e-3
    # warm-start each round's power iteration from the previous round's
    # subspace (rankDAD engine state); False = stateless cold starts
    dad_warm_start: bool = True
    # "bfloat16" runs the encoder and LSTM products in bf16 with f32
    # accumulation; "" = full f32
    compute_dtype: str = ""


@dataclass
class TrainConfig:
    task_id: str = NNComputation.TASK_FREE_SURFER
    agg_engine: str = AggEngine.DECENTRALIZED_SGD
    batch_size: int = 16
    local_iterations: int = 1  # gradient accumulation steps per round
    learning_rate: float = 1e-3
    # payload dtype of the gradient exchange: "32" | "16" (bfloat16) |
    # "16-ieee" (IEEE fp16, the reference's literal payload)
    precision_bits: str = "32"
    seed: int = 0
    optimizer: str = "adam"
    ica_args: ICAArgs = field(default_factory=ICAArgs)
    num_sites: int = 2
    # "device": the sites' inventory stays resident and each epoch gathers
    # its batches from an index plan (the only pipeline ported so far)
    pipeline: str = "device"
    # a site whose round gradient is non-finite this many consecutive rounds
    # is quarantined; 0 skips such rounds but never quarantines; -1 runs the
    # unguarded round
    quarantine_rounds: int = 3
