from .fed_runner import (
    FedDaemon,
    FedRunner,
    SiteRunner,
    discover_site_dirs,
    load_site_splits,
)
from .registry import (
    TASKS,
    ServingSpec,
    TaskSpec,
    build_engine,
    build_model,
    build_training,
    get_task,
    task_cache,
)

__all__ = ["TASKS", "FedDaemon", "FedRunner", "ServingSpec", "SiteRunner", "TaskSpec",
           "build_engine", "build_model", "build_training", "discover_site_dirs", "get_task",
           "load_site_splits", "task_cache"]
