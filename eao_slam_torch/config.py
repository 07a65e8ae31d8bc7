"""Configuration of the port: the same frozen dataclasses as the reference
package's config, limited to the fields the two trackers (chunked and
interactive per-frame: geometry mode, the EAO object layer, line-alignment
yaw, vocabulary place recognition) and the offline dense phase read, with
the reference's names and defaults.
"""

from __future__ import annotations

import dataclasses
import enum

from eao_slam_torch.geometry.camera import Camera, TUM3


class DemoFlag(enum.Enum):
    """Ablation flags (mono_tum CLI contract): NONE, the object-layer flags
    IFOREST, NA, IOU, NP and EAO, LINE_IFOREST (the object layer with
    line-alignment yaw) and FULL (line mode online, then the offline dense
    phase at shutdown)."""

    NONE = "None"
    IFOREST = "iForest"
    LINE_IFOREST = "LineAndiForest"
    NA = "NA"
    IOU = "IoU"
    NP = "NP"
    EAO = "EAO"
    FULL = "Full"

    @property
    def objects_enabled(self) -> bool:
        return self != DemoFlag.NONE

    @property
    def use_iou(self) -> bool:
        # the IoU stage runs unless the flag is NA or NP (src/Object.cc:184)
        return self not in (DemoFlag.NA, DemoFlag.NP, DemoFlag.NONE)

    @property
    def use_nonparam(self) -> bool:
        # the rank-sum stage runs unless the flag is NA or IoU (src/Object.cc:258)
        return self not in (DemoFlag.NA, DemoFlag.IOU, DemoFlag.NONE)

    @property
    def use_ttest(self) -> bool:
        # the t-test stage belongs to the full ensemble (src/Object.cc:465)
        return self in (DemoFlag.EAO, DemoFlag.FULL, DemoFlag.IFOREST, DemoFlag.LINE_IFOREST)

    @property
    def use_yaw_lines(self) -> bool:
        return self in (DemoFlag.LINE_IFOREST, DemoFlag.FULL)

    @property
    def semidense_enabled(self) -> bool:
        return self == DemoFlag.FULL


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    scale_factor: float = 1.2
    n_levels: int = 8
    fast_threshold: int = 20
    fast_min_threshold: int = 7
    edge_threshold: int = 19


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    search_radius_motion: float = 15.0


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    max_frames_between_kf: int = 30
    min_tracked_for_ok: int = 30
    min_matches_ref_kf: int = 15
    min_inliers_after_pose: int = 10
    kf_tracked_ratio: float = 0.9
    min_init_matches: int = 100
    enable_loop_closing: bool = True


@dataclasses.dataclass(frozen=True)
class ObjectConfig:
    """EAO object-layer parameters the trackers read (src/Object.cc
    constants)."""

    proj_iou_threshold: float = 0.25      # projected-box stage (src/Object.cc:351)
    iforest_seed: int = 12345             # :1214
    min_points_per_object: int = 5
    use_cubeslam: bool = False            # single-view cuboid proposals, off by
                                          # default like bCubeslam (src/Tracking.cc:1211)
    per_frame_iforest: bool = False       # chunked path: the iForest cull after every
                                          # frame (the reference's pacing,
                                          # src/Object.cc:1202-1309) instead of once a chunk


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    local_ba_kf_window: int = 16
    triangulation_neighbors: int = 2
    min_covis_weight: int = 10
    bidirectional_fuse: bool = True
    kf_cull_redundancy: float = 0.9   # KeyFrameCulling's 90 % rule


@dataclasses.dataclass(frozen=True)
class SemiDenseConfig:
    """ProbabilityMapping parameters (include/ProbabilityMapping.h:45-56)."""

    covis_n: int = 7
    sigma_i: float = 20.0
    lambda_g: float = 8.0
    lambda_l: float = 80.0
    lambda_theta: float = 45.0
    lambda_n: float = 3
    theta: float = 0.23
    n_support: int = 7


@dataclasses.dataclass(frozen=True)
class CapacityConfig:
    max_keyframes: int = 256
    max_points: int = 16384
    max_objects: int = 64
    max_features: int = 1024
    max_boxes: int = 16               # detector boxes per frame
    max_lines: int = 128              # 2D line segments per frame
    local_ba_points: int = 4096


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    camera: Camera = TUM3
    flag: DemoFlag = DemoFlag.NONE
    orb: OrbConfig = OrbConfig()
    matcher: MatcherConfig = MatcherConfig()
    tracking: TrackingConfig = TrackingConfig()
    objects: ObjectConfig = ObjectConfig()
    mapping: MappingConfig = MappingConfig()
    semidense: SemiDenseConfig = SemiDenseConfig()
    capacity: CapacityConfig = CapacityConfig()
    seed: int = 12345
    # BoW vocabulary (ops/bow.py) of the interactive tracker: a trained
    # .npz or DBoW2 .txt file, or None to train a small one online from the
    # first keyframes (the reference loads ORBvoc.bin, src/System.cc:79)
    vocab_path: str | None = None
    bow_bootstrap_kfs: int = 5        # keyframes before the online training
    use_bow: bool = True              # place recognition through the vocabulary

    def replace(self, **kw) -> "SystemConfig":
        return dataclasses.replace(self, **kw)


def tum3_config(flag: DemoFlag | str = DemoFlag.NONE, **kw) -> SystemConfig:
    if isinstance(flag, str):
        flag = DemoFlag(flag)
    return SystemConfig(camera=TUM3, flag=flag, **kw)
