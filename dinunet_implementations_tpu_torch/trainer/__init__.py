from .steps import FederatedTask, eval_forward

__all__ = ["FederatedTask", "eval_forward"]
