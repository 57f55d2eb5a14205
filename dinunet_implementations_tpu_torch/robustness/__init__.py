from .health import default_health, health_summary
from .membership import MembershipError, MembershipTable
from .retry import RetryTimeout, with_retry

__all__ = ["MembershipError", "MembershipTable", "RetryTimeout", "default_health",
           "health_summary", "with_retry"]
