from .registry import TASKS, ServingSpec, TaskSpec, build_model, build_training, get_task

__all__ = ["TASKS", "ServingSpec", "TaskSpec", "build_model", "build_training", "get_task"]
