from .steps import (
    FederatedTask,
    Optimizer,
    TrainState,
    cross_entropy,
    eval_forward,
    init_train_state,
    make_optimizer,
    make_train_epoch_fn,
)

__all__ = [
    "FederatedTask",
    "Optimizer",
    "TrainState",
    "cross_entropy",
    "eval_forward",
    "init_train_state",
    "make_optimizer",
    "make_train_epoch_fn",
]
