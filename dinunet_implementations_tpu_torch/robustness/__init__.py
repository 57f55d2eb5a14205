from .health import default_health, health_summary

__all__ = ["default_health", "health_summary"]
