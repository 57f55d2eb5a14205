from .health import default_health

__all__ = ["default_health"]
