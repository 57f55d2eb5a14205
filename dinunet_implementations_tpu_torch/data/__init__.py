from .api import SiteArrays, SiteInventory, stack_site_inventory
from .batching import EpochPlan, epoch_steps, plan_epoch_positions

__all__ = ["EpochPlan", "SiteArrays", "SiteInventory", "epoch_steps", "plan_epoch_positions",
           "stack_site_inventory"]
