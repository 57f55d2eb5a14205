from .checkpoint import (
    CorruptCheckpointError,
    load_checkpoint,
    load_inference_state,
    load_meta,
    load_params,
    params_digest,
    save_checkpoint,
)
from .loop import FederatedTrainer
from .metrics import Averages, ClassificationMetrics, MulticlassMetrics, is_improvement
from .steps import (
    FederatedTask,
    Optimizer,
    TrainState,
    cross_entropy,
    eval_forward,
    init_train_state,
    make_eval_fn,
    make_optimizer,
    make_train_epoch_fn,
)

__all__ = [
    "Averages",
    "ClassificationMetrics",
    "CorruptCheckpointError",
    "FederatedTask",
    "FederatedTrainer",
    "MulticlassMetrics",
    "Optimizer",
    "TrainState",
    "cross_entropy",
    "eval_forward",
    "init_train_state",
    "is_improvement",
    "load_checkpoint",
    "load_inference_state",
    "load_meta",
    "load_params",
    "make_eval_fn",
    "make_optimizer",
    "make_train_epoch_fn",
    "params_digest",
    "save_checkpoint",
]
