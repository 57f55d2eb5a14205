from .registry import TASKS, ServingSpec, TaskSpec, build_model, get_task

__all__ = ["TASKS", "ServingSpec", "TaskSpec", "build_model", "get_task"]
