from .base import Engine, mask_dead_site
from .dsgd import make_dsgd
from .rankdad import make_rankdad

__all__ = ["Engine", "make_dsgd", "make_rankdad", "mask_dead_site"]
