from .base import Engine, mask_dead_site
from .dsgd import make_dsgd
from .rankdad import make_rankdad


def build_engine(cfg, use_kernel: bool = True) -> Engine:
    """The aggregation engine a ``TrainConfig`` names: dSGD, or rankDAD
    with the ``ica_args`` ``dad_*`` knobs, with the config's wire options
    (each engine refuses those it does not run). ``use_kernel=False`` runs
    rankDAD's power iteration through its plain version."""
    from ..core.config import AggEngine
    from ..weights import jax_transposed_leaves

    if cfg.agg_engine not in (AggEngine.DECENTRALIZED_SGD, AggEngine.RANK_DAD):
        raise NotImplementedError(f"agg_engine {cfg.agg_engine!r} is not ported (ROADMAP A8)")
    a = cfg.ica_args
    wire = dict(wire_quant=cfg.wire_quant, robust_agg=cfg.robust_agg, secure_agg=cfg.secure_agg)
    if cfg.agg_engine == AggEngine.RANK_DAD:
        return make_rankdad(a.dad_reduction_rank, a.dad_num_pow_iters, a.dad_tol,
                            cfg.precision_bits, a.dad_warm_start, use_kernel=use_kernel,
                            transposed=jax_transposed_leaves(a.bidirectional), **wire)
    return make_dsgd(cfg.precision_bits, **wire)


__all__ = ["Engine", "build_engine", "make_dsgd", "make_rankdad", "mask_dead_site"]
