"""Typed configuration system (the port's own copy of
``improved_body_parts_tpu/config/configs.py``, kept field-for-field equal;
the port imports nothing from the JAX package).

Replaces the reference's class-constant configs (reference: config/config.py:8-260,
config/config2.py, config/config_dense.py, config/config_final.py) with frozen
dataclasses and a named registry.  Derived tables (limb indices, flip permutation
orders, channel layout) are *computed* from the part/limb name tables instead of
being hand-maintained arrays; tests pin them against the reference's asserted
golden values (config/config.py:87-92,121-124).

Channel layout (critical invariant, reference config/config.py:96-103):
    [0, paf_layers)                     body-part (limb) heatmaps
    [paf_layers, paf_layers+heat)       keypoint heatmaps
    [bkg_start]                         person-mask background channel
    [bkg_start+1]                       reverse-keypoint background channel
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

# COCO keypoint order (reference: config/config.py:146-148).
COCO_PARTS: Tuple[str, ...] = (
    "nose", "Leye", "Reye", "Lear", "Rear", "Lsho", "Rsho", "Lelb",
    "Relb", "Lwri", "Rwri", "Lhip", "Rhip", "Lkne", "Rkne", "Lank", "Rank",
)

# Internal (CMU-style) part order shared by canonical/3-stack/final variants
# (reference: config/config.py:61-62).
_PARTS_CANONICAL: Tuple[str, ...] = (
    "nose", "neck", "Rsho", "Relb", "Rwri", "Lsho", "Lelb", "Lwri", "Rhip",
    "Rkne", "Rank", "Lhip", "Lkne", "Lank", "Reye", "Leye", "Rear", "Lear",
)
# The dense variant swaps the eye/ear ordering (reference: config_dense.py parts).
_PARTS_DENSE: Tuple[str, ...] = (
    "nose", "neck", "Rsho", "Relb", "Rwri", "Lsho", "Lelb", "Lwri", "Rhip",
    "Rkne", "Rank", "Lhip", "Lkne", "Lank", "Reye", "Rear", "Leye", "Lear",
)

# Limb tables as (from, to) name pairs (reference: config/config.py:74-82).
_LIMBS_CANONICAL: Tuple[Tuple[str, str], ...] = tuple(zip(
    ["neck", "neck", "neck", "neck", "neck", "nose", "nose", "Reye", "Leye",
     "neck", "Rsho", "Relb", "neck", "Lsho", "Lelb",
     "neck", "Rhip", "Rkne", "neck", "Lhip", "Lkne",
     "nose", "nose", "Rsho", "Rhip", "Lsho", "Lhip", "Rear", "Lear", "Rhip"],
    ["nose", "Reye", "Leye", "Rear", "Lear", "Reye", "Leye", "Rear", "Lear",
     "Rsho", "Relb", "Rwri", "Lsho", "Lelb", "Lwri",
     "Rhip", "Rkne", "Rank", "Lhip", "Lkne", "Lank",
     "Rsho", "Lsho", "Rhip", "Lkne", "Lhip", "Rkne", "Rsho", "Lsho", "Lhip"],
))
# 3-stack 384 variant: 24 limbs (reference: config2.py limb tables).
_LIMBS_3STACK: Tuple[Tuple[str, str], ...] = tuple(zip(
    ["neck", "neck", "neck", "neck", "neck", "nose", "nose", "Reye", "Leye",
     "neck", "Rsho", "Relb", "neck", "Lsho", "Lelb",
     "neck", "Rhip", "Rkne", "neck", "Lhip", "Lkne", "Rhip", "Rsho", "Lsho"],
    ["nose", "Reye", "Leye", "Rear", "Lear", "Reye", "Leye", "Rear", "Lear",
     "Rsho", "Relb", "Rwri", "Lsho", "Lelb", "Lwri",
     "Rhip", "Rkne", "Rank", "Lhip", "Lkne", "Lank", "Lhip", "Rear", "Lear"],
))
# Densely connected skeleton: 49 limbs (reference: config_dense.py limb tables;
# header notes the redundant limbs *hurt* AP — kept for parity/ablation).
_LIMBS_DENSE_FROM = [1, 1, 1, 1, 1, 0, 14, 0, 16, 0, 0, 14, 1, 0, 15, 1, 0, 17,
                     2, 1, 5, 1, 3, 3, 2, 6, 5, 1, 2, 5, 1, 5, 2, 8, 4, 7, 8,
                     11, 2, 11, 8, 5, 9, 9, 8, 12, 12, 11, 9]
_LIMBS_DENSE_TO = [0, 14, 15, 16, 17, 14, 15, 16, 17, 15, 17, 16, 2, 2, 2, 5,
                   5, 5, 3, 3, 6, 6, 6, 4, 4, 7, 7, 8, 8, 8, 11, 11, 11, 11,
                   8, 11, 9, 9, 9, 12, 12, 12, 12, 10, 10, 10, 13, 13, 13]
_LIMBS_DENSE: Tuple[Tuple[str, str], ...] = tuple(
    (_PARTS_DENSE[f], _PARTS_DENSE[t])
    for f, t in zip(_LIMBS_DENSE_FROM, _LIMBS_DENSE_TO)
)

_LEFT_PARTS = ("Lsho", "Lelb", "Lwri", "Lhip", "Lkne", "Lank", "Leye", "Lear")
_RIGHT_PARTS = ("Rsho", "Relb", "Rwri", "Rhip", "Rkne", "Rank", "Reye", "Rear")


def _mirror_name(name: str) -> str:
    if name in _LEFT_PARTS:
        return "R" + name[1:]
    if name in _RIGHT_PARTS:
        return "L" + name[1:]
    return name


@dataclass(frozen=True)
class TransformParams:
    """Augmentation hyper-parameters (reference: config/config.py:26-49)."""
    target_dist: float = 0.6
    scale_prob: float = 0.8
    scale_min: float = 0.7
    scale_max: float = 1.3
    max_rotate_degree: float = 40.0
    center_perterb_max: float = 50.0
    flip_prob: float = 0.5
    tint_prob: float = 0.2
    sigma: float = 9.0
    keypoint_gaussian_thre: float = 0.015
    limb_gaussian_thre: float = 0.015
    paf_sigma: float = 7.0
    paf_thre_stride_mult: float = 1.0  # paf_thre = mult * stride (config.py:47)


@dataclass(frozen=True)
class SkeletonConfig:
    """Skeleton definition + channel layout.

    All derived index tables are computed in ``__post_init__`` from the name
    tables; the reference hardcodes them (config/config.py:84-124).
    """
    parts: Tuple[str, ...] = _PARTS_CANONICAL
    limbs: Tuple[Tuple[str, str], ...] = _LIMBS_CANONICAL
    width: int = 512
    height: int = 512
    stride: int = 4
    # curated subset of limbs rendered by the demo (reference:
    # config/config.py:126 ``draw_list``; canonical = [0, 5..20, 29])
    draw_limbs: Tuple[int, ...] = (0,) + tuple(range(5, 21)) + (29,)
    transform_params: TransformParams = field(default_factory=TransformParams)
    # Derived (filled in __post_init__):
    parts_dict: Dict[str, int] = field(default_factory=dict, compare=False)
    limbs_conn: Tuple[Tuple[int, int], ...] = field(default=(), compare=False)
    flip_heat_ord: Tuple[int, ...] = field(default=(), compare=False)
    flip_paf_ord: Tuple[int, ...] = field(default=(), compare=False)
    left_parts: Tuple[int, ...] = field(default=(), compare=False)
    right_parts: Tuple[int, ...] = field(default=(), compare=False)

    def __post_init__(self):
        pd = {p: i for i, p in enumerate(self.parts)}
        limbs_conn = tuple((pd[f], pd[t]) for f, t in self.limbs)
        # Keypoint flip permutation: part -> mirrored part, plus the 2
        # background channels which map to themselves
        # (golden: config/config.py:121).
        mirror = [pd[_mirror_name(p)] for p in self.parts]
        flip_heat = tuple(mirror) + (self.num_parts, self.num_parts + 1)
        # Limb flip permutation: limb -> index of the mirrored limb
        # (golden: config/config.py:122-124).
        mirrored_limbs = [(_mirror_name(f), _mirror_name(t)) for f, t in self.limbs]
        limb_index = {pair: i for i, pair in enumerate(self.limbs)}
        # A limb's scalar map is symmetric in direction, so a mirrored limb may
        # appear reversed in the table (e.g. Rhip->Lhip mirrors to itself).
        flip_paf = []
        for orig, m in zip(self.limbs, mirrored_limbs):
            if m in limb_index:
                flip_paf.append(limb_index[m])
            elif (m[1], m[0]) in limb_index:
                flip_paf.append(limb_index[(m[1], m[0])])
            else:
                raise ValueError(
                    f"limb table is not closed under L/R mirroring: limb "
                    f"{orig} mirrors to {m}, which is absent (flip ensembling "
                    f"needs every limb's mirror in the table)")
        flip_paf = tuple(flip_paf)
        object.__setattr__(self, "parts_dict", pd)
        object.__setattr__(self, "limbs_conn", limbs_conn)
        object.__setattr__(self, "flip_heat_ord", flip_heat)
        object.__setattr__(self, "flip_paf_ord", flip_paf)
        object.__setattr__(self, "left_parts", tuple(pd[p] for p in _LEFT_PARTS))
        object.__setattr__(self, "right_parts", tuple(pd[p] for p in _RIGHT_PARTS))

    # --- channel layout (reference: config/config.py:96-110) ---
    @property
    def num_parts(self) -> int:
        return len(self.parts)

    @property
    def paf_layers(self) -> int:
        return len(self.limbs)

    @property
    def heat_layers(self) -> int:
        return self.num_parts

    @property
    def num_layers(self) -> int:
        return self.paf_layers + self.heat_layers + 2

    @property
    def paf_start(self) -> int:
        return 0

    @property
    def heat_start(self) -> int:
        return self.paf_layers

    @property
    def bkg_start(self) -> int:
        return self.paf_layers + self.heat_layers

    @property
    def grid_shape(self) -> Tuple[int, int]:
        """(H, W) of the stride-4 output grid."""
        return (self.height // self.stride, self.width // self.stride)

    @property
    def parts_shape(self) -> Tuple[int, int, int]:
        h, w = self.grid_shape
        return (h, w, self.num_layers)

    @property
    def paf_thre(self) -> float:
        return self.transform_params.paf_thre_stride_mult * self.stride

    # COCO detection id -> COCO gt id mapping used when writing results
    # (reference: config/config.py:117-118). Computed from name tables.
    @property
    def dt_gt_mapping(self) -> Dict[int, int]:
        coco_index = {p: i for i, p in enumerate(COCO_PARTS)}
        return {i: coco_index.get(p) for i, p in enumerate(self.parts)}


@dataclass(frozen=True)
class ModelConfig:
    """IMHN architecture knobs (reference: config/config.py:14-16)."""
    nstack: int = 4
    inp_dim: int = 256
    increase: int = 128
    hourglass_depth: int = 4
    variant: str = "imhn"  # imhn | imhn_final | imhn_light | imhn_independent | ae
    use_bn: bool = True
    se_reduction: int = 16
    leaky_slope: float = 0.01
    # rematerialize each hourglass stack in the backward pass (memory for
    # FLOPs) — enables big per-chip batches at 512²
    remat: bool = False


@dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters (reference: config/config.py:8-23,
    train_distributed.py:123-124, 382-400)."""
    batch_size_per_device: int = 4
    learning_rate_per_device: float = 2.5e-5
    momentum: float = 0.9
    weight_decay: float = 5e-4        # train_distributed.py:124 (train.py uses 1e-4)
    nstack_weight: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    scale_weight: Tuple[float, ...] = (0.1, 0.2, 0.4, 1.6, 6.4)
    multi_task_weight: float = 0.1
    keypoint_task_weight: float = 3.0
    epochs: int = 100
    warmup_epochs: int = 3            # train_distributed.py:392-396
    lr_decay_factor: float = 0.2
    lr_step_epochs: int = 15          # /5 every 15 epochs ...
    lr_late_epoch: int = 78           # ... every 5 epochs after epoch 78
    lr_late_step_epochs: int = 5
    abnormal_loss_thre: float = 2e5   # drop batch if loss explodes (:259-261)
    max_grad_norm: float = 0.0        # 0 disables (flag kept; ref has it disabled)
    # --- large-batch recipe (train.schedule.large_batch_schedule;
    # "Extremely Large Minibatch SGD", PAPERS.md) ---
    # reference global batch the base LR was tuned at: LR scales
    # linearly by global_batch / lr_batch_ref.  0 = per-device
    # convention (ref = batch_size_per_device, i.e. LR x world_size)
    lr_batch_ref: int = 0
    # gradual-warmup epochs for the base->scaled LR ramp; 0 = reuse
    # warmup_epochs
    large_batch_warmup_epochs: int = 0
    # --- GSPMD partitioned training (parallel.partition) ---
    # run the rule-partitioned train step (state sharded per
    # partition_rules, batch over 'data', activations constrained)
    # instead of the replicated-state program
    partition: bool = False
    # named ruleset (parallel.partition.NAMED_RULESETS): "imhn" shards
    # wide conv kernels' output channels over 'model'
    partition_rules: str = "imhn"
    # 'model' mesh-axis size for make_mesh (data = devices // model)
    mesh_model_axis: int = 1
    print_freq: int = 10
    checkpoint_dir: str = "checkpoints"
    # --- checkpointing cadence + async manager (train.checkpoint) ---
    # save on epochs divisible by N (1 = every epoch); the FINAL epoch
    # of a fit always saves regardless (same always-ship rule as the
    # trailing SWA checkpoint).  Keyed on the ABSOLUTE epoch number —
    # resume-stable and aligned with milestone_every below
    save_freq: int = 1
    # run the val pass on epochs divisible by N (1 = every epoch, final
    # always); absolute-epoch-based like save_freq, so multi-process
    # collectives stay aligned
    eval_freq: int = 1
    # snapshot-then-background-write checkpointing (CheckpointManager):
    # the train loop blocks only on the device->host drain, the Orbax
    # write/commit overlap eval + the next epoch.  False = the fully
    # synchronous legacy path (the sync arm of tools/ckpt_bench.py)
    async_checkpoint: bool = True
    # retention GC over COMMITTED checkpoints: keep the last N epoch
    # dirs (0 = keep everything, GC off) ...
    keep_last_n: int = 0
    # ... plus the best checkpoint by the recorded metric (val_loss when
    # a val pass runs, else train loss) ...
    keep_best: bool = True
    # ... plus every epoch divisible by K (0 = no milestones)
    milestone_every: int = 0
    hdf5_train_data: str = "data/dataset/coco_train_dataset512.h5"
    hdf5_val_data: str = "data/dataset/coco_val_dataset512.h5"
    # normalization convention: True = divide by global batch (distributed
    # semantics, loss_model.py:39); False = caller divides (parallel twin).
    normalize_by_global_batch: bool = True
    bf16_compute: bool = True
    # kept for field-for-field equality with the JAX package, where it
    # routes the focal loss through its Pallas kernel; the port has one
    # implementation (the CUDA kernels on the card, ops/cuda_focal.py)
    use_pallas_loss: bool = False
    # --- input pipeline (data.batches / data.shm_ring) ---
    # worker transport: "shm" (persistent shared-memory slot ring, the
    # production default), "pool" (retired spawn-Pool path — its per-sample
    # pickle bytes made workers 4-6x slower than sync at 512²; kept as an
    # escape hatch), "sync" (in-process)
    input_pipeline: str = "shm"
    # image wire format: "uint8" ships warped uint8 HWC across IPC and
    # host->device (4x fewer bytes; normalized to [0,1] inside the jitted
    # step, bit-identical to f32), "f32" is the legacy [0,1] float wire
    input_wire: str = "uint8"
    # ring depth in batch slots; 0 = auto (num_workers + 2)
    input_ring_slots: int = 0
    # --- telemetry (obs/) ---
    # structured JSONL run-event sink: "" disables, "auto" writes
    # <checkpoint_dir>/events.jsonl, anything else is the path itself
    # (tools/telemetry_report.py folds the stream into a summary)
    telemetry_sink: str = ""
    # live /metrics (Prometheus text) + /snapshot (JSON) endpoint:
    # -1 disables, 0 binds an ephemeral port (logged at startup),
    # any other value is the port
    telemetry_port: int = -1
    # emit every Nth per-print_freq step record (1 = all; the data-wait/
    # compute split accumulates in counters regardless of sampling)
    telemetry_sample: int = 1
    # span-trace export (obs/trace.py -> Chrome/Perfetto trace_event
    # JSON): "" disables the export ("auto" still records into the
    # in-memory ring whenever the sink is on), "auto" writes
    # <checkpoint_dir>/trace.json, anything else is the path itself
    # (tools/trace_report.py converts + summarizes)
    telemetry_trace: str = ""
    # run-health sentinel policy on a divergent window (non-finite loss
    # or grad norm): "warn" records and keeps training, "halt" raises
    # obs.DivergenceError out of the loop, "skip_step" drops the update
    # INSIDE the jitted step (extends the abnormal_loss_thre select)
    on_divergence: str = "warn"
    # grad-norm ceiling for the sentinel; 0 = finiteness checks only
    health_grad_norm_limit: float = 0.0
    # --- heatmap distillation (train.distill; "Fast Human Pose
    # Estimation", PAPERS.md) ---
    # blend weight of the GT term:
    #   loss = alpha * focal(student, gt)
    #        + (1 - alpha) * focal(student, stop_grad(teacher))
    # 1.0 degenerates exactly to the plain supervised loss
    distill_alpha: float = 0.5
    # linear ramp of alpha from 1.0 (pure GT) down to distill_alpha over
    # the first N steps — the teacher term fades IN once the student's
    # early layers stop thrashing; 0 = constant alpha from step 0.
    # Computed on device from state.step, so the ramp costs no retraces
    distill_alpha_warmup_steps: int = 0


@dataclass(frozen=True)
class Config:
    """Bundle handed to models/losses/pipelines."""
    name: str = "canonical"
    skeleton: SkeletonConfig = field(default_factory=SkeletonConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _canonical() -> Config:
    return Config()


def _three_stack_384() -> Config:
    """3-stack 384×384 variant (reference: config/config2.py; ckpt note
    'epoch 102 AP=0.658')."""
    return Config(
        name="three_stack_384",
        skeleton=SkeletonConfig(
            parts=_PARTS_CANONICAL, limbs=_LIMBS_3STACK, width=384, height=384,
            draw_limbs=(0,) + tuple(range(5, 22)),
            transform_params=TransformParams(
                scale_min=0.75, scale_max=1.25, center_perterb_max=40.0,
                tint_prob=0.4, keypoint_gaussian_thre=0.01,
                limb_gaussian_thre=0.01),
        ),
        model=ModelConfig(nstack=3),
        train=TrainConfig(
            batch_size_per_device=8,
            nstack_weight=(1.0, 1.0, 1.0),
            scale_weight=(0.2, 0.1, 0.4, 1.0, 4.0),
            keypoint_task_weight=1.0,
            hdf5_train_data="data/dataset/coco_train_dataset384.h5",
            hdf5_val_data="data/dataset/coco_val_dataset384.h5"),
    )


def _dense_384() -> Config:
    """Densely connected skeleton experiment (reference: config/config_dense.py;
    header notes the extra limbs hurt AP)."""
    return Config(
        name="dense_384",
        skeleton=SkeletonConfig(
            parts=_PARTS_DENSE, limbs=_LIMBS_DENSE, width=384, height=384,
            draw_limbs=(0, 5, 7, 6, 8, 12, 18, 23, 15, 20, 25, 27, 36, 43,
                        30, 39, 46, 33),
            transform_params=TransformParams(
                scale_min=0.75, scale_max=1.25, center_perterb_max=40.0,
                tint_prob=0.1, keypoint_gaussian_thre=0.005,
                limb_gaussian_thre=0.1),
        ),
        model=ModelConfig(nstack=3, inp_dim=384, increase=192),
        train=TrainConfig(
            batch_size_per_device=5,
            learning_rate_per_device=1e-4,
            nstack_weight=(1.0, 1.0, 1.0),
            scale_weight=(0.2, 0.1, 0.4, 1.0, 4.0),
            multi_task_weight=0.2,
            keypoint_task_weight=6.0,
            hdf5_train_data="data/dataset/coco_train_dataset384.h5",
            hdf5_val_data="data/dataset/coco_val_dataset384.h5"),
    )


def _final_384() -> Config:
    """4-stack 384 variant with stronger augmentation for posenet_final
    (reference: config/config_final.py:32-40)."""
    return Config(
        name="final_384",
        skeleton=SkeletonConfig(
            parts=_PARTS_CANONICAL, limbs=_LIMBS_CANONICAL, width=384, height=384,
            transform_params=TransformParams(
                scale_min=0.6, scale_max=1.5, max_rotate_degree=50.0,
                tint_prob=0.35, keypoint_gaussian_thre=0.01,
                limb_gaussian_thre=0.04),
        ),
        model=ModelConfig(variant="imhn_final"),
        train=TrainConfig(
            batch_size_per_device=8,
            learning_rate_per_device=2.5e-4,
            hdf5_train_data="data/dataset/coco_train_dataset384.h5",
            hdf5_val_data="data/dataset/coco_val_dataset384.h5"),
    )


def _tiny() -> Config:
    """Framework-native smoke-test config (no reference counterpart): a
    depth-2, 2-stack, 16-channel IMHN at 128px for CPU tests and CLI
    dry-runs."""
    return Config(
        name="tiny",
        skeleton=SkeletonConfig(width=128, height=128),
        model=ModelConfig(nstack=2, inp_dim=16, increase=8,
                          hourglass_depth=2, se_reduction=4),
        train=TrainConfig(batch_size_per_device=1,
                          nstack_weight=(1.0, 1.0),
                          scale_weight=(0.5, 1.0, 2.0),
                          epochs=2, warmup_epochs=1),
    )


def _synth() -> Config:
    """Drawn-person synthetic benchmark (framework-native, no reference
    counterpart): the tiny IMHN with a hotter LR and a real batch, used by
    tools/synth_ap.py to demonstrate the full learn→decode→AP loop on the
    rendered stick-figure fixture (data/fixture.py ``drawn=True``)."""
    return Config(
        name="synth",
        skeleton=SkeletonConfig(width=128, height=128),
        model=ModelConfig(nstack=2, inp_dim=16, increase=8,
                          hourglass_depth=2, se_reduction=4),
        train=TrainConfig(batch_size_per_device=4,
                          # SGD+momentum sweep on the drawn fixture:
                          # 1e-3 converges fastest, 1e-2 diverges; near
                          # the stability edge — corpora much larger than
                          # ~100 images (3x the steps/epoch) have been
                          # observed to explode mid-run at 1e-3, so drop
                          # to 5e-4 or stretch warmup when scaling up
                          learning_rate_per_device=1e-3,
                          nstack_weight=(1.0, 1.0),
                          scale_weight=(0.5, 1.0, 2.0),
                          epochs=60, warmup_epochs=2),
    )


def _synth_deep() -> Config:
    """Production-architecture synthetic benchmark (framework-native):
    the flagship IMHN *shape* — 4 stacks, recursive depth-4 hourglass,
    BN, bf16 compute, per-stack remat, full 5-scale supervision — at a
    width (inp_dim 64) and resolution (256²) a 1-core CPU host can
    train in hours.  Bridges the toy ``synth`` config (2-stack/16-ch,
    where every learn→AP measurement before round 4 lived) and the true
    canonical config (reference: config/config.py:14-16, 4-stack/256-ch
    @512²), exercising every production training knob the toy config
    skips: cross-stack caches at depth 4, BN statistics through 4
    stacks, bf16 numerics, rematerialized backward, and the canonical
    5-scale loss pyramid with the reference's scale weights."""
    return Config(
        name="synth_deep",
        skeleton=SkeletonConfig(width=256, height=256),
        model=ModelConfig(nstack=4, inp_dim=64, increase=32,
                          hourglass_depth=4, se_reduction=16, remat=True),
        train=TrainConfig(batch_size_per_device=4,
                          # deeper + wider than synth: keep well inside
                          # the SGD stability edge (see _synth note)
                          learning_rate_per_device=5e-4,
                          nstack_weight=(1.0, 1.0, 1.0, 1.0),
                          scale_weight=(0.1, 0.2, 0.4, 1.6, 6.4),
                          epochs=30, warmup_epochs=2,
                          bf16_compute=True),
    )


def _synth_canonical() -> Config:
    """The CANONICAL-WIDTH model on the synthetic benchmark: every model
    hyperparameter exactly matches the reference flagship (reference:
    config/config.py:14-16 — nstack=4, hourglass_inp_dim=256,
    increase=128, bn=True → 128,998,760 params), with only the canvas
    reduced (512² → 192²) so a 1-core CPU host can execute a real
    multi-epoch learn→AP run (~8 s/step measured; 512² would be ~60).
    This stages the last architecture-scale claim — "the production
    model, not just the production shape, learns" — until a chip is
    available for the full-resolution run; tools/synth_ap.py
    --config synth_canonical drives it (CANONICAL_TRAIN.json).

    Width changes optimization (BN statistics, LR scale, bf16
    accumulation, memory under remat), so this is NOT redundant with
    ``synth_deep`` (inp_dim=64, 8.2M params).  LR: the reference's
    canonical 2.5e-5/process is tuned for 4×4-batch COCO epochs;
    on the ~100-record drawn corpus it would take hundreds of epochs to
    move, so the benchmark keeps synth_deep's 5e-4 stability-tested
    setting scaled down 2× for the 16× wider model (2.5e-4), with the
    reference's warmup + /5-every-15-epochs step schedule unchanged.
    """
    return Config(
        name="synth_canonical",
        skeleton=SkeletonConfig(width=192, height=192),
        # EXACTLY the canonical flagship architecture (remat, a
        # training-memory knob, on — as the flagship-shape runs use it)
        model=ModelConfig(remat=True),
        train=TrainConfig(batch_size_per_device=2,
                          learning_rate_per_device=2.5e-4,
                          epochs=18, warmup_epochs=2,
                          bf16_compute=True),
    )


def _synth_canonical_512() -> Config:
    """``synth_canonical`` at FULL resolution: the reference flagship
    exactly as trained (reference: config/config.py:14-16 — nstack=4,
    inp_dim=256, increase=128, 512² input → 128,998,760 params) on the
    synthetic drawn-person benchmark, for the ON-CHIP learn→AP run the
    round-4 verdict staged (CANONICAL_TRAIN.json was the reduced-canvas
    CPU stage).  Batch 8 is the reference package's one-chip training
    batch; LR follows
    synth_canonical's stability-tested 2.5e-4 (the reference's COCO
    2.5e-5 barely moves on a ~100-image corpus), with the reference's
    warmup + /5-every-15-epochs schedule unchanged."""
    return Config(
        name="synth_canonical_512",
        model=ModelConfig(remat=True),
        train=TrainConfig(batch_size_per_device=8,
                          learning_rate_per_device=2.5e-4,
                          epochs=30, warmup_epochs=2,
                          bf16_compute=True),
    )


def _synth_deep_student() -> Config:
    """Student twin of ``synth_deep`` (the production-SHAPE pair a CPU
    host can actually run): 2 stacks at a quarter of the width, depth-4
    hourglasses and the full 5-scale supervision kept.  The cascade
    bench's default fast tier (tools/cascade_bench.py: its fused decode
    dispatch measures ~2.8x cheaper than synth_deep's at 256px on the
    2-core host), and the distillation smoke target
    (``--distill-from <synth_deep ckpt> --teacher-config synth_deep``).
    """
    return Config(
        name="synth_deep_student",
        skeleton=SkeletonConfig(width=256, height=256),
        model=ModelConfig(nstack=2, inp_dim=16, increase=8,
                          hourglass_depth=4, se_reduction=8),
        train=TrainConfig(batch_size_per_device=4,
                          learning_rate_per_device=5e-4,
                          nstack_weight=(1.0, 1.0),
                          scale_weight=(0.1, 0.2, 0.4, 1.6, 6.4),
                          epochs=30, warmup_epochs=2,
                          bf16_compute=True,
                          distill_alpha=0.5),
    )


def _canonical_student() -> Config:
    """The distilled FAST TIER of the canonical flagship (ROADMAP open
    item 2; "Fast Human Pose Estimation" / "FasterPose", PAPERS.md): a
    2-stack, half-width IMHN trained with heatmap distillation from the
    4-stack/256-ch teacher (``tools/train.py --distill-from``), served
    as the cascade's student lane (``serve.cascade``) with escalation to
    the teacher on hard frames.  Architecture follows the papers' recipe
    — halve the stacks AND the width (~1/8 the FLOPs); the skeleton,
    channel layout and bucket geometry are the teacher's exactly, so the
    two tiers share serve buckets and the escalation decode is
    layout-compatible."""
    return Config(
        name="canonical_student",
        model=ModelConfig(nstack=2, inp_dim=128, increase=64),
        train=TrainConfig(batch_size_per_device=8,
                          nstack_weight=(1.0, 1.0),
                          distill_alpha=0.5),
    )


def _tiny_student() -> Config:
    """Student twin of ``tiny`` for CPU tests, the graftaudit registry
    and the cascade bench: ONE stack at half the width (the narrow 1-2
    stack variant of the distillation recipe, scaled to smoke size).
    Same 18-part skeleton and 128px canvas as ``tiny``, so a
    tiny_student/tiny cascade shares bucket shapes end to end."""
    return Config(
        name="tiny_student",
        skeleton=SkeletonConfig(width=128, height=128),
        model=ModelConfig(nstack=1, inp_dim=8, increase=4,
                          hourglass_depth=2, se_reduction=4),
        train=TrainConfig(batch_size_per_device=1,
                          nstack_weight=(1.0,),
                          scale_weight=(0.5, 1.0, 2.0),
                          epochs=2, warmup_epochs=1,
                          distill_alpha=0.5),
    )


def _ae() -> Config:
    """Associative-Embedding-style classic hourglass (reference:
    models/ae_pose.py, kept for ablation): ONE full-resolution output per
    stack, so the loss runs with a single scale weight.  (The reference never
    shipped a config for it — its 5-scale loss cannot consume ae outputs.)"""
    return Config(
        name="ae",
        model=ModelConfig(variant="ae"),
        train=TrainConfig(scale_weight=(1.0,)),
    )


_REGISTRY = {
    "canonical": _canonical,
    "three_stack_384": _three_stack_384,
    "dense_384": _dense_384,
    "final_384": _final_384,
    "tiny": _tiny,
    "tiny_student": _tiny_student,
    "canonical_student": _canonical_student,
    "synth": _synth,
    "synth_deep": _synth_deep,
    "synth_deep_student": _synth_deep_student,
    "synth_canonical": _synth_canonical,
    "synth_canonical_512": _synth_canonical_512,
    "ae": _ae,
}


def get_config(name: str = "canonical") -> Config:
    """Named registry (reference: config/config.py:239-260 ``GetConfig``)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown config '{name}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def available_configs() -> List[str]:
    return sorted(_REGISTRY)
