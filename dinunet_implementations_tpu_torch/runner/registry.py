"""Task registry: task id → model constructor, dataset, data handle and
serving spec, and the training pieces a config names. The port serves and
trains every task of the JAX package's registry: FreeSurfer (MSANNet),
ICA (ICALstm), sMRI (SMRI3DNet) and the multimodal FS+ICA transformer
(MultimodalNet)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import torch

from ..core.config import NNComputation, TrainConfig
from ..core.device import resolve_device
from ..data.api import DataHandle, SiteDataset
from ..data.freesurfer import FreeSurferDataset, FSVDataHandle
from ..data.ica import ICADataHandle, ICADataset
from ..data.multimodal import MultimodalDataHandle, MultimodalDataset
from ..data.smri import SMRIDataHandle, SMRIDataset
from ..engines import Engine, build_engine
from ..models.cnn3d import SMRI3DNet
from ..models.icalstm import ICALstm
from ..models.msannet import MSANNet
from ..models.transformer import MultimodalNet
from ..trainer.steps import FederatedTask, Optimizer, make_optimizer
from ..weights import LeafTable


@dataclass(frozen=True)
class ServingSpec:
    """``sample_shape(cfg)`` is one example's feature shape (no batch axis):
    the shape a request's rows carry and the row buckets pad to.
    ``stream_shape(cfg)`` is one streaming timestep's shape (None: the task
    has no recurrent session semantics); ``streaming_ok(cfg)`` gates the
    streaming lane on the config being causal: the ICA-LSTM streams iff
    ``bidirectional=False`` (the reverse direction of a biLSTM reads the
    future; models/icalstm.py ICALstmStream)."""

    sample_shape: Callable[[TrainConfig], tuple]
    stream_shape: Callable[[TrainConfig], tuple] | None = None
    streaming_ok: Callable[[TrainConfig], bool] | None = None

    def supports_streaming(self, cfg: TrainConfig) -> bool:
        return (self.stream_shape is not None
                and (self.streaming_ok is None or bool(self.streaming_ok(cfg))))


@dataclass(frozen=True)
class TaskSpec:
    """``model_cls`` is the model's class (its ``leaf_table_of`` tells its
    trees); ``leaf_table(cfg)`` its :class:`~..weights.LeafTable` at the
    config's widths."""

    task_id: str
    build_model: Callable[[TrainConfig], torch.nn.Module]
    dataset_cls: type[SiteDataset]
    handle_cls: type[DataHandle]
    model_cls: type[torch.nn.Module]
    leaf_table: Callable[[TrainConfig], LeafTable]
    serving: ServingSpec | None = None


def _ica_windows(a) -> int:
    """Window count per subject: ``temporal_size / window_size``."""
    return int(a.temporal_size / a.window_size)


def _build_msannet(cfg: TrainConfig, generator=None, use_kernel: bool = True) -> MSANNet:
    """MSANNet of the ``fs_args`` widths; ``use_kernel`` is taken for the
    builders' one signature (the model runs no kernel)."""
    a = cfg.fs_args
    return MSANNet(in_size=a.input_size, hidden_sizes=tuple(a.hidden_sizes),
                   out_size=a.num_class, generator=generator)


def _build_icalstm(cfg: TrainConfig, generator=None, use_kernel: bool = True) -> ICALstm:
    """ICALstm of the ``ica_args`` widths. ``num_layers`` is a parity
    field: one BiLSTM layer is built whatever its value, as JAX builds. A
    model axis (the ring LSTM) is refused."""
    if cfg.model_axis_size > 1:
        raise NotImplementedError("model_axis_size > 1 shards the ICA windows over a mesh's "
                                  "model axis (the ring LSTM), which is not ported: ROADMAP "
                                  "A11 (c)")
    a = cfg.ica_args
    return ICALstm(
        input_size=a.input_size,
        hidden_size=a.hidden_size,
        bidirectional=a.bidirectional,
        num_cls=a.num_class,
        num_comps=a.num_components,
        window_size=a.window_size,
        compute_dtype=a.compute_dtype or None,
        use_kernel=use_kernel,
        generator=generator,
    )


def _build_smri3d(cfg: TrainConfig, generator=None, use_kernel: bool = True) -> SMRI3DNet:
    """SMRI3DNet of the ``smri3d_args`` widths (the model runs no kernel).
    Under ``space_to_depth`` the dataset folds the volumes once at load and
    the model takes the folded 8-channel input as is."""
    a = cfg.smri3d_args
    return SMRI3DNet(channels=tuple(a.channels), num_cls=a.num_class,
                     compute_dtype=a.compute_dtype or None, space_to_depth=a.space_to_depth,
                     generator=generator)


def _build_multimodal(cfg: TrainConfig, generator=None,
                      use_kernel: bool = True) -> MultimodalNet:
    """MultimodalNet of the ``multimodal_args`` widths (the model runs no
    kernel). ``attention=""`` means ring attention iff ``model_axis_size >
    1``, as in JAX; ring attention is refused (ROADMAP A11 (c))."""
    a = cfg.multimodal_args
    attention = a.attention or ("ring" if cfg.model_axis_size > 1 else "local")
    if attention == "ring" and cfg.model_axis_size < 2:
        raise ValueError('attention="ring" needs model_axis_size >= 2 (the token axis '
                         "shards over the mesh model axis)")
    return MultimodalNet(
        fs_input_size=a.fs_input_size, num_comps=a.num_components, window_size=a.window_size,
        num_windows=_ica_windows(a), embed_dim=a.embed_dim, num_heads=a.num_heads,
        num_layers=a.num_layers, mlp_ratio=a.mlp_ratio, num_cls=a.num_class,
        attention=attention, compute_dtype=a.compute_dtype or None, generator=generator)


def _smri_sample_shape(cfg: TrainConfig) -> tuple:
    """One volume as a request carries it: folded by the pipeline to ``(D/2,
    H/2, W/2, 8)`` under ``space_to_depth``, else ``(D, H, W)``."""
    a = cfg.smri3d_args
    if a.space_to_depth:
        return tuple(d // 2 for d in a.volume_shape) + (8,)
    return tuple(a.volume_shape)


TASKS: dict[str, TaskSpec] = {
    NNComputation.TASK_FREE_SURFER: TaskSpec(
        NNComputation.TASK_FREE_SURFER, _build_msannet, FreeSurferDataset, FSVDataHandle,
        MSANNet, lambda cfg: MSANNet.leaf_table(len(cfg.fs_args.hidden_sizes)),
        serving=ServingSpec(sample_shape=lambda cfg: (cfg.fs_args.input_size,)),
    ),
    NNComputation.TASK_ICA: TaskSpec(
        NNComputation.TASK_ICA, _build_icalstm, ICADataset, ICADataHandle,
        ICALstm, lambda cfg: ICALstm.leaf_table(cfg.ica_args.bidirectional),
        serving=ServingSpec(
            sample_shape=lambda cfg: (
                _ica_windows(cfg.ica_args),
                cfg.ica_args.num_components,
                cfg.ica_args.window_size,
            ),
            # one streaming timestep is one window [C, W]
            stream_shape=lambda cfg: (cfg.ica_args.num_components, cfg.ica_args.window_size),
            streaming_ok=lambda cfg: not cfg.ica_args.bidirectional,
        ),
    ),
    NNComputation.TASK_SMRI_3D: TaskSpec(
        NNComputation.TASK_SMRI_3D, _build_smri3d, SMRIDataset, SMRIDataHandle,
        SMRI3DNet, lambda cfg: SMRI3DNet.leaf_table(len(cfg.smri3d_args.channels)),
        serving=ServingSpec(sample_shape=_smri_sample_shape),
    ),
    NNComputation.TASK_MULTIMODAL: TaskSpec(
        NNComputation.TASK_MULTIMODAL, _build_multimodal, MultimodalDataset,
        MultimodalDataHandle, MultimodalNet,
        lambda cfg: MultimodalNet.leaf_table(cfg.multimodal_args.num_layers),
        serving=ServingSpec(sample_shape=lambda cfg: (
            cfg.multimodal_args.fs_input_size + _ica_windows(cfg.multimodal_args)
            * cfg.multimodal_args.num_components * cfg.multimodal_args.window_size,)),
    ),
}


def get_task(task_id: str) -> TaskSpec:
    if task_id not in TASKS:
        raise ValueError(f"Invalid task: {task_id!r} (have {sorted(TASKS)})")
    return TASKS[task_id]


def task_cache(cfg: TrainConfig) -> dict:
    """The flat cache dict a task's dataset reads (the task-args block)."""
    return dataclasses.asdict(cfg.task_args())


def build_model(cfg: TrainConfig, device=None) -> torch.nn.Module:
    """The task's model with weights drawn from ``cfg.seed``, on ``device``
    (the card unless the caller asks for ``"cpu"``)."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(cfg.seed)
    return get_task(cfg.task_id).build_model(cfg, g).to(device)


def build_training(cfg: TrainConfig, device=None,
                   use_kernel: bool = True) -> tuple[FederatedTask, Engine, Optimizer]:
    """The task (its model's weights drawn from ``cfg.seed``, on ``device``:
    the card unless the caller asks for ``"cpu"``), the aggregation engine
    (dSGD, rankDAD or powerSGD with the task args' ``dad_*`` knobs) and the
    optimizer that ``cfg`` names, for ``make_train_epoch_fn``.
    ``use_kernel=False`` runs the LSTM and the power iteration through the
    kernels' plain versions (the sMRI and multimodal models run no kernel
    of their own: only rankDAD's power iteration changes): the reference a
    check on the card holds the kernels against."""
    engine = build_engine(cfg, use_kernel)
    device = resolve_device(device)
    g = torch.Generator().manual_seed(cfg.seed)
    model = get_task(cfg.task_id).build_model(cfg, g, use_kernel=use_kernel).to(device)
    return FederatedTask(model), engine, make_optimizer(cfg.optimizer, cfg.learning_rate)
