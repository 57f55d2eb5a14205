from .health import default_health, health_summary
from .retry import RetryTimeout, with_retry

__all__ = ["RetryTimeout", "default_health", "health_summary", "with_retry"]
