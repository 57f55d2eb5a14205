from .fed_runner import (
    FedDaemon,
    FedRunner,
    SiteRunner,
    discover_site_dirs,
    load_site_splits,
)
from .scheduler import (
    BackfillLane,
    FleetScheduler,
    SchedulerError,
    Tenant,
    TenantSpec,
    fair_share,
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

__all__ = ["TASKS", "BackfillLane", "FedDaemon", "FedRunner", "FleetScheduler", "SchedulerError",
           "ServingSpec", "SiteRunner", "TaskSpec", "Tenant", "TenantSpec", "build_engine",
           "build_model", "build_training", "discover_site_dirs", "fair_share", "get_task",
           "load_site_splits", "task_cache"]
