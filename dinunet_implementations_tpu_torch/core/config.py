"""The subset of the training configuration that the port reads.

Field names and defaults are those of the JAX package's ``core/config.py``
(``FSArgs``, ``ICAArgs``, ``SMRI3DArgs``, ``MultimodalArgs``,
``PretrainArgs``, ``AggEngine`` and the
``TrainConfig`` fields that serving, the training epochs, the federated
trainer and the runner read),
with its per-site ``inputspec.json`` resolution (:func:`load_inputspec`,
:func:`resolve_site_configs`). Options the port does not run are kept at
their "off" values so that the trainer can refuse any other value. The port
keeps its own copy: it imports nothing of the JAX package.

Resolution order, as in JAX: dataclass defaults < programmatic kwargs <
per-site inputspec values.

The reference's compatibility fields (``num_reducers``, ``pin_memory``,
``num_workers``, ``dataloader_args``) load with JAX's defaults and change
nothing, as in JAX; ``fused_poweriter`` takes None or True (rankDAD's power
iteration is always the CUDA kernel on the card) and refuses False.
:func:`export_compspec` emits the COINSTAC compspec of the GUI's fields.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Sequence


class NNComputation:
    """Task identifiers (the reference's ``comps/__init__.py:7-10``)."""

    TASK_FREE_SURFER = "FS-Classification"
    TASK_ICA = "ICA-Classification"
    TASK_SMRI_3D = "sMRI-3D-Classification"
    TASK_MULTIMODAL = "Multimodal-Classification"

    ALL = (TASK_FREE_SURFER, TASK_ICA, TASK_SMRI_3D, TASK_MULTIMODAL)


class AggEngine:
    """Aggregation engines (the reference's ``comps/__init__.py:13-16``)."""

    DECENTRALIZED_SGD = "dSGD"
    RANK_DAD = "rankDAD"
    POWER_SGD = "powerSGD"

    ALL = (DECENTRALIZED_SGD, RANK_DAD, POWER_SGD)


@dataclass
class FSArgs:
    """FreeSurfer classification parameters (the reference's
    ``compspec.json:225-250``): each site's covariate CSV (``labels_file``,
    indexed by ``data_column``, labels in ``labels_column``) and an
    MSANNet of ``input_size`` aseg volumes, ``hidden_sizes`` and
    ``num_class`` outputs."""

    labels_file: str = "site0_covariates.csv"
    data_column: str = "freesurferfile"
    labels_column: str = "isControl"
    input_size: int = 66
    hidden_sizes: tuple = (256, 128, 64, 32)
    num_class: int = 2
    dad_reduction_rank: int = 10
    dad_num_pow_iters: int = 5
    dad_tol: float = 1e-3
    # see ICAArgs.dad_warm_start
    dad_warm_start: bool = True
    split_files: tuple = ()
    # the reference's string-label rule bit for bit: EVERY string maps
    # through (s.lower() == 'true'), so "1" becomes 0; False parses numeric
    # strings as numbers (data/freesurfer.py coerce_label)
    bug_compatible_labels: bool = False


@dataclass
class ICAArgs:
    """ICA classification parameters: 100 components, 980 timepoints cut
    into windows of 10, an encoder to 256 and a BiLSTM of total width 348
    (the shipped workload's value). ``data_file`` / ``labels_file`` name a
    site's timecourses and labels CSV under its base directory."""

    data_file: str = ""
    labels_file: str = ""
    num_class: int = 2
    monitor_metric: str = "auc"
    metric_direction: str = "maximize"
    log_header: str = "Loss|AUC"
    num_components: int = 100
    temporal_size: int = 980
    window_size: int = 10
    window_stride: int = 10
    input_size: int = 256
    hidden_size: int = 348
    # kept for the reference's keys: one BiLSTM layer is built whatever
    # its value, as in JAX
    num_layers: int = 1
    bidirectional: bool = True
    # rankDAD (compspec.json:236-238): factor rank, power-iteration cap and
    # the relative σ-change tolerance of its early exit
    dad_reduction_rank: int = 10
    dad_num_pow_iters: int = 5
    dad_tol: float = 1e-3
    # warm-start each round's power iteration from the previous round's
    # subspace (rankDAD engine state); False = stateless cold starts
    dad_warm_start: bool = True
    # predefined split JSON files under each site's directory (one a fold)
    split_files: tuple = ()
    # "bfloat16" runs the encoder and LSTM products in bf16 with f32
    # accumulation; "" = full f32
    compute_dtype: str = ""


@dataclass
class SMRI3DArgs:
    """3D sMRI (T1w volume) classification parameters: each site's volumes
    ``[N, D, H, W]`` (``data_file``) and ``[index, label]`` CSV
    (``labels_file``), and an SMRI3DNet of ``channels`` stride-2 convolutions
    over ``volume_shape`` volumes. ``space_to_depth`` folds each 2x2x2 block
    into 8 channels once, when a site is read (it changes conv_0's kernel,
    so a checkpoint of the other setting does not restore)."""

    data_file: str = ""
    labels_file: str = ""
    num_class: int = 2
    volume_shape: tuple = (64, 64, 64)
    channels: tuple = (16, 32, 64, 128)
    # "bfloat16" runs the convolutions in bf16 with f32 BatchNorm and head;
    # "" = full f32
    compute_dtype: str = ""
    space_to_depth: bool = False
    dad_reduction_rank: int = 10
    dad_num_pow_iters: int = 5
    dad_tol: float = 1e-3
    dad_warm_start: bool = True  # see ICAArgs.dad_warm_start
    split_files: tuple = ()


@dataclass
class MultimodalArgs:
    """Multimodal FS+ICA transformer parameters: a site directory holds the
    FreeSurfer covariate CSV (``labels_file``, ``data_column``,
    ``labels_column``) with its aseg files and the ICA timecourses
    (``data_file``), joined row by row; ``fs_input_size`` aseg volumes and
    ``temporal_size / window_size`` windows of ``num_components x
    window_size`` become one token each, behind a CLS token, through
    ``num_layers`` pre-LN blocks of ``embed_dim`` and ``num_heads``."""

    data_file: str = ""
    labels_file: str = ""
    data_column: str = "freesurferfile"
    labels_column: str = "isControl"
    num_class: int = 2
    fs_input_size: int = 66
    num_components: int = 100
    temporal_size: int = 980
    window_size: int = 10
    window_stride: int = 10
    embed_dim: int = 256
    num_heads: int = 8
    num_layers: int = 4
    mlp_ratio: int = 4
    # "" = auto: ring attention iff model_axis_size > 1 (refused: ROADMAP
    # A11 (c)); "local" or "ring" force one
    attention: str = ""
    # "bfloat16" runs the products in bf16 with f32 softmax, LayerNorm and
    # residual stream; "" = full f32
    compute_dtype: str = ""
    dad_reduction_rank: int = 10
    dad_num_pow_iters: int = 5
    dad_tol: float = 1e-3
    dad_warm_start: bool = True  # see ICAArgs.dad_warm_start
    split_files: tuple = ()


@dataclass
class PretrainArgs:
    """Largest-site pretraining (the reference's ``compspec.json:128-148``):
    epochs, learning rate, batch size and local iterations of the warm
    start; ``validation_epochs``, ``pin_memory``, ``num_workers`` and
    ``patience`` are kept for the reference's keys and read by nothing."""

    epochs: int = 0
    learning_rate: float = 1e-3
    batch_size: int = 16
    local_iterations: int = 1
    validation_epochs: int = 1
    pin_memory: bool = False
    num_workers: int = 0
    patience: int = 51


@dataclass
class TrainConfig:
    task_id: str = NNComputation.TASK_FREE_SURFER
    mode: str = "train"  # train | test
    agg_engine: str = AggEngine.DECENTRALIZED_SGD
    # the reference's reducer count: one card reduces in place, so it is read
    # by nothing (JAX's is a no-op too)
    num_reducers: int = 2
    batch_size: int = 16
    local_iterations: int = 1  # gradient accumulation steps per round
    learning_rate: float = 1e-3
    epochs: int = 101
    # largest-site pretraining (compspec.json:120-127): with pretrain_args
    # of epochs > 0, a dSGD warm start on the largest site before the fit
    pretrain: bool = False
    pretrain_args: PretrainArgs | None = None
    validation_epochs: int = 1
    # payload dtype of the gradient exchange: "32" | "16" (bfloat16) |
    # "16-ieee" (IEEE fp16, the reference's literal payload)
    precision_bits: str = "32"
    # the reference's torch DataLoader knobs, read by nothing (as in JAX):
    # the host pipeline does not pin its batches
    pin_memory: bool = False
    num_workers: int = 0
    patience: int = 35
    split_ratio: tuple = (0.8, 0.1, 0.1)
    num_folds: int | None = None  # k-fold CV; takes precedence over split_ratio
    # trainer extras (the reference's local.py:31-37)
    num_class: int = 2
    monitor_metric: str = "auc"
    metric_direction: str = "maximize"
    log_header: str = "loss|auc"
    # warm start: a checkpoint whose params (only) start the fit; "" = init
    pretrained_path: str = ""
    # the reference's DataLoader arguments, read by nothing (drop_last is
    # what the batching does anyway)
    dataloader_args: dict = field(default_factory=lambda: {"train": {"drop_last": True}})
    seed: int = 0
    optimizer: str = "adam"
    fs_args: FSArgs = field(default_factory=FSArgs)
    ica_args: ICAArgs = field(default_factory=ICAArgs)
    smri3d_args: SMRI3DArgs = field(default_factory=SMRI3DArgs)
    multimodal_args: MultimodalArgs = field(default_factory=MultimodalArgs)
    num_sites: int = 2
    # virtual sites a rank of the process-group site mesh holds (parallel/
    # mesh.py packed_site_mesh); must divide the site count
    sites_per_device: int = 1
    # slices of the site mesh, the inter-slice wire codec ("" follows
    # wire_quant) and the mesh's model axis: more than one slice, a codec
    # of its own and a model axis above 1 are refused (ROADMAP A11 (b),
    # A11 (c))
    num_slices: int = 1
    dcn_wire_quant: str = ""
    # the mesh's model axis (sequence parallelism); above 1 the multimodal
    # task asks for ring attention (ROADMAP A11 (c))
    model_axis_size: int = 1
    # the ring LSTM's microbatches under a model axis (ROADMAP A11 (c))
    sequence_microbatches: int = 0
    # execution detail of the JAX epoch (scan xs or per-round slices); any
    # value gives the same port epoch
    rounds_scan_xs: bool = True
    # "device": the sites' inventory stays resident and each epoch gathers
    # its batches from an index plan; "host": each epoch materializes the
    # dense [S, steps, B, ...] batches on the host and copies them over
    pipeline: str = "device"
    # JAX donates the carried state's buffers to its epoch program; the
    # port's epoch never writes its input state, so any value is the same
    donate_epoch_state: bool = True
    # non-empty: the kernel libraries are built into and loaded from this
    # directory (ops/_build.py ``enable_compile_cache``), so a later process
    # loads what an earlier one built there. CLI: --compile-cache DIR
    compile_cache_dir: str = ""
    # non-empty: a torch.profiler trace of the whole fit, one a fold under
    # <profile_dir>/fold_<k>; excludes xprof_dir
    profile_dir: str = ""
    # "on": the span tracer, the per-site round metrics in
    # TrainState.telemetry and the manifest.json / metrics.jsonl / trace
    # files under <out_dir>/telemetry/fold_<k> (or telemetry_dir); "off"
    # runs the epoch exactly as without them
    telemetry: str = "off"
    telemetry_dir: str = ""
    # non-empty: a torch.profiler capture of the xprof_window epochs only
    # ((first, last), 1-based and inclusive), under <xprof_dir>/fold_<k>
    xprof_dir: str = ""
    xprof_window: tuple = (1, 1)
    # the buffered-async rounds (staleness_bound > 0: each site's last update
    # is aggregated at weight decay^age up to the bound) and the overlapped
    # rounds (each round's update applied one round late), which exclude
    # each other
    staleness_bound: int = 0
    staleness_decay: float = 0.5
    # the engines' wire codec (parallel/collectives.py WIRE_QUANTS): "none"
    # keeps the precision_bits wire, "bf16" forces bf16, "int8" / "fp8"
    # round each payload to a one-byte grid with a scale a payload;
    # wire_stochastic rounds the int8 grid stochastically
    wire_quant: str = "none"
    wire_stochastic: bool = False
    overlap_rounds: bool = False
    # a site whose round gradient is non-finite this many consecutive rounds
    # is quarantined; 0 skips such rounds but never quarantines; -1 runs the
    # unguarded round
    quarantine_rounds: int = 3
    # byzantine-robust aggregation (parallel/collectives.py ROBUST_AGGS):
    # "none" is the weighted mean; "norm_clip" clips each site's gradient
    # norm to robust_clip_mult x the live-weighted median site norm;
    # "trimmed_mean" / "coordinate_median" reduce each coordinate over the
    # sites. Any mode but "none" also runs the reputation layer
    # (robustness/health.py)
    robust_agg: str = "none"
    # the live weight trimmed from EACH tail by the trimmed mean, in [0, 0.5)
    robust_trim_frac: float = 0.2
    # norm_clip's threshold over the live-weighted median site norm
    robust_clip_mult: float = 2.5
    # the reputation layer: reputation_rounds consecutive rounds of an
    # anomaly z-score over reputation_z quarantine a site (0: score only)
    reputation_z: float = 2.0
    reputation_rounds: int = 8
    min_slices: int = 1
    # the privacy plane (privacy/): DP-SGD clips each site's round gradient
    # to dp_clip and adds dp_noise_multiplier·dp_clip of Gaussian noise
    # (0 and 0: off; noise needs a clip); the RDP accountant reports ε at
    # dp_delta and a fit stops cleanly once ε reaches dp_epsilon_budget
    # (0: no budget)
    dp_clip: float = 0.0
    dp_noise_multiplier: float = 0.0
    dp_seed: int = 0
    dp_delta: float = 1e-5
    dp_epsilon_budget: float = 0.0
    # secure-aggregation masked wires, dSGD only: "off", "mask", or the
    # pads-zeroed verification arm "mask-nopads"; the pads' seed
    secure_agg: str = "off"
    secure_agg_seed: int = 0
    # personalized per-site heads: JAX path substrings of the leaves kept
    # out of the aggregation (e.g. ("cls_fc3",)); () is off
    personalize: tuple = ()
    # rankDAD's power iteration: None (auto) and True run the CUDA kernel on
    # the card; False asks for JAX's XLA loop, which has no counterpart here
    fused_poweriter: bool | None = None

    def __post_init__(self):
        if self.fused_poweriter is False:
            raise ValueError(
                "fused_poweriter=False asks for the JAX package's XLA power-iteration loop, "
                "which has no counterpart on the card: the port always runs rankDAD's power "
                "iteration as its CUDA kernel on the card (its plain version on the CPU); "
                "leave it None or True")

    def task_args(self):
        if self.task_id == NNComputation.TASK_FREE_SURFER:
            return self.fs_args
        if self.task_id == NNComputation.TASK_ICA:
            return self.ica_args
        if self.task_id == NNComputation.TASK_SMRI_3D:
            return self.smri3d_args
        if self.task_id == NNComputation.TASK_MULTIMODAL:
            return self.multimodal_args
        raise ValueError(f"Invalid task: {self.task_id}")

    def to_dict(self) -> dict:
        """Every field as plain data (the blocks as dicts), JAX's
        ``TrainConfig.to_dict``; ``TrainConfig().with_overrides(d)`` gives
        the config back, also after a JSON round trip."""
        return dataclasses.asdict(self)

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

    def with_overrides(self, overrides: dict) -> "TrainConfig":
        """Apply a flat override dict (one site's inputspec values): a key
        naming a ``TrainConfig`` field sets it, and every key naming a
        field of the task-args block sets that too (the reference keeps one
        flat cache dict). A dict under a task-args block (``fs_args``,
        ``ica_args``, ``smri3d_args``, ``multimodal_args``, or its compspec
        key such as ``FS-Classification_args``) merges into its block, and one under
        ``pretrain_args`` into that optional block (made on first use; flat
        keys never reach it). Keys of neither are dropped, as in JAX; the
        compatibility fields (module docstring) are fields, so they stay."""
        overrides = {_COMPSPEC_KEY_ALIASES.get(k, k): v for k, v in overrides.items()}
        flat = {k: _coerce(_TRAIN_FIELDS[k], v) for k, v in overrides.items()
                if k in _TRAIN_FIELDS and k not in _BLOCK_FIELDS}
        cfg = dataclasses.replace(self, **flat)
        for args_name, args_cls in _BLOCK_FIELDS.items():
            current, given = getattr(cfg, args_name), overrides.get(args_name)
            if current is None and given is None:
                continue  # an unset optional block stays unset
            block = current or args_cls()
            fields = {f.name: f for f in dataclasses.fields(args_cls)}
            upd = {}
            if isinstance(given, dict):
                upd.update({k: _coerce(fields[k], v) for k, v in given.items() if k in fields})
            elif dataclasses.is_dataclass(given):
                block = given
            if args_name != "pretrain_args":
                upd.update({k: _coerce(fields[k], v) for k, v in overrides.items() if k in fields})
            if upd:
                block = dataclasses.replace(block, **upd)
            if block is not getattr(cfg, args_name):
                cfg = dataclasses.replace(cfg, **{args_name: block})
        return cfg


_TRAIN_FIELDS = {f.name: f for f in dataclasses.fields(TrainConfig)}
_COMPSPEC_KEY_ALIASES = {"FS-Classification_args": "fs_args",
                         "ICA-Classification_args": "ica_args",
                         "sMRI-3D-Classification_args": "smri3d_args",
                         "Multimodal-Classification_args": "multimodal_args"}
#: dataclass-typed TrainConfig fields that take dict merges
_BLOCK_FIELDS = {"fs_args": FSArgs, "ica_args": ICAArgs, "smri3d_args": SMRI3DArgs,
                 "multimodal_args": MultimodalArgs, "pretrain_args": PretrainArgs}


def _coerce(f: dataclasses.Field, v: Any) -> Any:
    """The GUI sends JSON lists where a field is a tuple: make them tuples.
    Other values are left as they are."""
    if isinstance(v, list) and (f.type or "").startswith("tuple"):
        return tuple(v)
    return v


def load_inputspec(path: str) -> list[dict]:
    """A COINSTAC simulator ``inputspec.json``: a list (one entry a site)
    of ``{"key": {"value": v}}`` envelopes, or one dict for one site.
    Returns one flat override dict a site."""
    with open(path) as fh:
        spec = json.load(fh)
    if isinstance(spec, dict):
        spec = [spec]
    out = []
    for site in spec:
        out.append({k: v.get("value") if isinstance(v, dict) and "value" in v else v
                    for k, v in site.items()})
    return out


def resolve_site_configs(base: TrainConfig, dataset_dir: str,
                         num_sites: int | None = None) -> list[TrainConfig]:
    """Per-site configs for a dataset tree: site i takes entry ``i %
    len(spec)`` of ``<dataset_dir>/inputspec.json`` (if present) over
    ``base``."""
    spec_path = os.path.join(dataset_dir, "inputspec.json")
    overrides: Sequence[dict] = [{}]
    if os.path.exists(spec_path):
        overrides = load_inputspec(spec_path)
    n = num_sites if num_sites is not None else len(overrides)
    return [base.with_overrides(overrides[i % len(overrides)]) for i in range(n)]


# -- the compspec export (the GUI's metadata) -------------------------------

#: GUI metadata for each flag: (type, source, group, order, conditional, label)
#: — preserved from reference ``compspec.json`` so the schema can be re-emitted.
COMPSPEC_META: dict[str, dict] = {
    "task_id": dict(type="select", source="owner", group="NN Params", order=3,
                    values=list(NNComputation.ALL),
                    label="Pick a NN task:"),
    "mode": dict(type="select", source="owner", group="NN Params", order=4,
                 values=["train", "test"], label="NN Mode:"),
    "agg_engine": dict(type="select", source="owner", group="NN Params", order=5,
                       values=list(AggEngine.ALL),
                       conditional=dict(variable="mode", value="train"),
                       label="Pick aggregation engine:"),
    "num_reducers": dict(type="number", source="owner", group="NN Params", order=6,
                         label="Number of reducers in the aggregator(Depends on number of sites):"),
    "batch_size": dict(type="number", source="owner", group="NN Params", order=7,
                       label="Batch size:"),
    "local_iterations": dict(
        type="number", source="owner", group="NN Params", order=8,
        label="Local gradient accumulation iterations"
              "(effective batch size = batch size * gradient accumulation iterations)"),
    "learning_rate": dict(type="number", source="owner", group="NN Params", order=9,
                          conditional=dict(variable="mode", value="train"),
                          label="Learning rate:"),
    "epochs": dict(type="number", source="owner", group="NN Params", order=10,
                   conditional=dict(variable="mode", value="train"), label="Epochs:"),
    "pretrain": dict(type="boolean", source="owner", group="NN Params", order=11,
                     label="Use the site with maximum data to pre-train locally as starting point:"),
    "pretrain_args": dict(type="object", source="owner", group="NN Params", order=12,
                          conditional=dict(variable="pretrain", value=True),
                          label="Pretraining arguments:"),
    "validation_epochs": dict(type="number", source="owner", group="NN Params", order=13,
                              conditional=dict(variable="mode", value="train"),
                              label="Run validation after every epochs:"),
    "precision_bits": dict(type="select", source="owner", group="NN Params", order=14,
                           # "16" = bfloat16; "16-ieee" = the reference's
                           # literal fp16 payload (compat)
                           values=["32", "16", "16-ieee"],
                           conditional=dict(variable="mode", value="train"),
                           label="Floating point precision for payload:"),
    "pin_memory": dict(type="boolean", source="member", group="NN Params", order=15,
                       label="Pin Memory:"),
    "num_workers": dict(type="number", source="member", group="NN Params", order=16,
                        label="Number of workers:"),
    "patience": dict(type="number", source="owner", group="NN Params", order=17,
                     conditional=dict(variable="mode", value="train"),
                     label="Early stopping patience epochs:"),
    "split_ratio": dict(type="object", source="owner", group="NN Params", order=21,
                        label="Data split ratio for train, validation, test in the same order:"),
    "num_folds": dict(type="number", source="owner", group="NN Params", order=22,
                      label="Number of folds for K-Fold Cross Validation"
                            "(Mutually exclusive with split ratio):"),
    "fs_args": dict(type="object", source="owner", group="Computation", order=23,
                    conditional=dict(variable="task_id", value="FS-Classification"),
                    label="FreeSurfer classification parameters.",
                    compspec_key="FS-Classification_args"),
    "ica_args": dict(type="object", source="owner", group="Computation", order=26,
                     conditional=dict(variable="task_id", value="ICA-Classification"),
                     label="ICA classification parameters.",
                     compspec_key="ICA-Classification_args"),
    "smri3d_args": dict(type="object", source="owner", group="Computation", order=27,
                        conditional=dict(variable="task_id", value="sMRI-3D-Classification"),
                        label="3D sMRI classification parameters.",
                        compspec_key="sMRI-3D-Classification_args"),
    "multimodal_args": dict(type="object", source="owner", group="Computation", order=28,
                            conditional=dict(variable="task_id", value="Multimodal-Classification"),
                            label="Multimodal FS+ICA transformer parameters.",
                            compspec_key="Multimodal-Classification_args"),
}


def export_compspec(cfg: TrainConfig | None = None) -> dict:
    """A COINSTAC-style compspec dict (schema and defaults) of ``cfg``'s
    GUI fields, JAX's ``export_compspec`` with the port's ``meta``."""
    cfg = cfg or TrainConfig()
    inputs: dict[str, Any] = {}
    for name, meta in COMPSPEC_META.items():
        default = getattr(cfg, name)
        if dataclasses.is_dataclass(default):
            default = dataclasses.asdict(default)
        entry = {"default": _jsonable(default),
                 **{k: v for k, v in meta.items() if k != "compspec_key"}}
        inputs[meta.get("compspec_key", name)] = entry
    return {
        "meta": {
            "name": "Decentralized Deep Artificial Neural Networks on one CUDA card",
            "id": "dinunet-tpu-torch",
            "version": "v1.0.0",
            "repository": "local",
            "description": "Federated NN training with every site on one CUDA device; "
                           "hand-written CUDA kernels on the hot path.",
        },
        "computation": {"input": inputs, "output": {}, "type": "cuda"},
    }


def _jsonable(v):
    if isinstance(v, tuple):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    return v
