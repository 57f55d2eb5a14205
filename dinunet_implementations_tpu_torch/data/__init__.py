from .api import (
    DataHandle,
    SiteArrays,
    SiteDataset,
    SiteInventory,
    build_site_dataset,
    stack_site_inventory,
)
from .batching import (
    EpochPlan,
    FedBatches,
    epoch_steps,
    materialize_plan,
    plan_epoch,
    plan_epoch_positions,
    plan_eval,
)
from .demo import (
    make_demo_tree,
    make_fs_demo_tree,
    make_hard_ica_tree,
    make_ica_demo_tree,
    make_multimodal_demo_tree,
)
from .freesurfer import FreeSurferDataset, FSVDataHandle, coerce_label, read_aseg_stats
from .ica import ICADataHandle, ICADataset, load_timecourses, window_timecourses
from .multimodal import MultimodalDataHandle, MultimodalDataset
from .smri import SMRIDataHandle, SMRIDataset, space_to_depth_222_np
from .splits import kfold_splits, load_split_file, resolve_splits, split_by_ratio

__all__ = [
    "DataHandle",
    "EpochPlan",
    "FSVDataHandle",
    "FedBatches",
    "FreeSurferDataset",
    "ICADataHandle",
    "ICADataset",
    "MultimodalDataHandle",
    "MultimodalDataset",
    "SMRIDataHandle",
    "SMRIDataset",
    "SiteArrays",
    "SiteDataset",
    "SiteInventory",
    "build_site_dataset",
    "coerce_label",
    "epoch_steps",
    "kfold_splits",
    "load_split_file",
    "load_timecourses",
    "make_demo_tree",
    "make_fs_demo_tree",
    "make_hard_ica_tree",
    "make_ica_demo_tree",
    "make_multimodal_demo_tree",
    "materialize_plan",
    "plan_epoch",
    "plan_epoch_positions",
    "plan_eval",
    "read_aseg_stats",
    "resolve_splits",
    "space_to_depth_222_np",
    "split_by_ratio",
    "stack_site_inventory",
    "window_timecourses",
]
