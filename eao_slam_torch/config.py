"""Configuration of the port: the same frozen dataclasses as the reference
package's config, limited to the fields geometry-mode chunked tracking
reads, with the reference's names and defaults.
"""

from __future__ import annotations

import dataclasses
import enum

from eao_slam_torch.geometry.camera import Camera, TUM3


class DemoFlag(enum.Enum):
    """Ablation flags (mono_tum CLI contract). The port runs NONE only."""

    NONE = "None"
    IFOREST = "iForest"
    LINE_IFOREST = "LineAndiForest"
    NA = "NA"
    IOU = "IoU"
    NP = "NP"
    EAO = "EAO"
    FULL = "Full"


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
class MappingConfig:
    local_ba_kf_window: int = 16
    triangulation_neighbors: int = 2
    min_covis_weight: int = 10
    bidirectional_fuse: bool = True
    kf_cull_redundancy: float = 0.9   # KeyFrameCulling's 90 % rule


@dataclasses.dataclass(frozen=True)
class CapacityConfig:
    max_keyframes: int = 256
    max_points: int = 16384
    max_features: int = 1024
    local_ba_points: int = 4096


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    camera: Camera = TUM3
    flag: DemoFlag = DemoFlag.NONE
    orb: OrbConfig = OrbConfig()
    matcher: MatcherConfig = MatcherConfig()
    tracking: TrackingConfig = TrackingConfig()
    mapping: MappingConfig = MappingConfig()
    capacity: CapacityConfig = CapacityConfig()
    seed: int = 12345

    def replace(self, **kw) -> "SystemConfig":
        return dataclasses.replace(self, **kw)


def tum3_config(flag: DemoFlag | str = DemoFlag.NONE, **kw) -> SystemConfig:
    if isinstance(flag, str):
        flag = DemoFlag(flag)
    return SystemConfig(camera=TUM3, flag=flag, **kw)


def check_supported(cfg: SystemConfig, chunked: bool = True) -> None:
    """The port covers geometry-mode chunked tracking with its between-chunk
    passes (maintenance, loop closing, relocalization); everything else
    names the ROADMAP.md item that will port it."""
    if cfg.flag != DemoFlag.NONE:
        raise NotImplementedError(
            f"DemoFlag.{cfg.flag.name} is not ported yet: the EAO object layer "
            "is ROADMAP.md Queue 1 item 9, line-enabled FULL mode item 10")
    if not chunked:
        raise NotImplementedError(
            "the interactive per-frame tracker (chunked=False) is not ported "
            "yet: ROADMAP.md Queue 1 item 13")
