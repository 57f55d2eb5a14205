from .base import Engine, mask_dead_site
from .dsgd import make_dsgd

__all__ = ["Engine", "make_dsgd", "mask_dead_site"]
