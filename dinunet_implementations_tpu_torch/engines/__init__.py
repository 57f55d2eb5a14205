from .base import (
    ASYNC_NEVER_AGE,
    Engine,
    default_async_buffers,
    mask_dead_site,
    staleness_weights,
)
from .dsgd import make_dsgd
from .powersgd import make_powersgd
from .rankdad import make_rankdad


def build_engine(cfg, use_kernel: bool = True) -> Engine:
    """The aggregation engine a ``TrainConfig`` names: dSGD; rankDAD with
    the ``dad_*`` knobs of the task's args (``cfg.task_args()``, as JAX
    passes them to ``make_engine``); or powerSGD at rank
    ``dad_reduction_rank`` with its first Q drawn from ``cfg.seed``. The
    leaves stored transposed and the JAX leaf order come from the task's
    model (``weights.leaf_table``); under ``cfg.personalize`` a leaf's index
    is its place among the shared leaves, which is all the engine sees.
    Each takes the config's wire, robust and secure aggregation options and
    refuses those it does not run.
    ``use_kernel=False`` runs rankDAD's power iteration through its plain
    version (powerSGD launches no kernel of its own)."""
    from ..core.config import AggEngine
    from ..privacy.personalize import head_leaf_paths, shared_leaf_index
    from ..weights import leaf_table

    if cfg.agg_engine not in AggEngine.ALL:
        raise ValueError(f"unknown agg_engine {cfg.agg_engine!r} (have {AggEngine.ALL})")
    a, table = cfg.task_args(), leaf_table(cfg)
    wire = dict(wire_quant=cfg.wire_quant, wire_stochastic=cfg.wire_stochastic,
                dcn_wire_quant=cfg.dcn_wire_quant, robust_agg=cfg.robust_agg,
                secure_agg=cfg.secure_agg,
                robust_trim_frac=cfg.robust_trim_frac, robust_clip_mult=cfg.robust_clip_mult)
    transposed = table.transposed
    # under personalization the engine sees the shared leaves only, and JAX
    # keys a leaf by its place among them
    names = {n for n, _, _ in table.params}
    index = shared_leaf_index(table, head_leaf_paths(names, cfg.personalize, table))
    if cfg.agg_engine == AggEngine.RANK_DAD:
        return make_rankdad(a.dad_reduction_rank, a.dad_num_pow_iters, a.dad_tol,
                            cfg.precision_bits, a.dad_warm_start, use_kernel=use_kernel,
                            transposed=transposed, **wire)
    if cfg.agg_engine == AggEngine.POWER_SGD:
        return make_powersgd(a.dad_reduction_rank, cfg.precision_bits, seed=cfg.seed,
                             transposed=transposed, leaf_index=index, **wire)
    return make_dsgd(cfg.precision_bits, secure_agg_seed=cfg.secure_agg_seed, leaf_index=index,
                     transposed=transposed, **wire)


__all__ = ["ASYNC_NEVER_AGE", "Engine", "build_engine", "default_async_buffers", "make_dsgd",
           "make_powersgd", "make_rankdad", "mask_dead_site", "staleness_weights"]
