"""Monocular SLAM runtime: the interactive per-frame tracker and local
mapper (Tracking + LocalMapping, src/Tracking.cc:562-804,
src/LocalMapping.cc:42-117), as the reference package's MonoTracker.

One host loop over device steps. Per frame: motion-model tracking (the
reference keyframe when too few inliers survive), local-map tracking, the
EAO object pass (object-layer flags), the keyframe decision. Per keyframe:
BoW bookkeeping, triangulation with the covisible neighbours, fusion both
ways, the duplicate merge, windowed BA, point culling, the descriptor
refresh, the object merge pass, keyframe culling and loop detection. When
LOST: relocalization against BoW (or signature) candidates with EPnP
RANSAC. The map lives in one MapState on the tracker's device; the host
keeps mirrors of the keyframe and point tables' bookkeeping and decides
every branch (one readback per decision, as the reference).

The chunked tracker (``runtime/scan_tracker.py``) bootstraps through this
class: two-view initialization and the initial map, rotated onto the
ground given the initializer frame's ground-truth pose.

Random draws (two-view init, relocalization's PnP RANSAC) come from a host
``torch.Generator`` seeded from ``cfg.seed``, so a seed gives the same
draws on every device; they cannot replay the reference's ``jax.random``
streams.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from eao_slam_torch.config import SystemConfig
from eao_slam_torch.objects.association import ObjectUpdater
from eao_slam_torch.objects.cuboid_proposal import detect_cuboid
from eao_slam_torch.objects.merge import run_merge_pass
from eao_slam_torch.objects.state import empty_object_table
from eao_slam_torch.ops import bow, matching
from eao_slam_torch.ops.orb import scale_sigma2
from eao_slam_torch.runtime import tracking_kernels as tk
from eao_slam_torch.runtime.compaction import covisibility
from eao_slam_torch.runtime.frame import Frame
from eao_slam_torch.runtime.keyframe_db import KeyFrameDatabase
from eao_slam_torch.runtime.local_mapping import (
    fuse_into_keyframe,
    merge_duplicate_points,
    refresh_point_descriptors,
    run_local_ba,
    triangulate_with_neighbor,
)
from eao_slam_torch.runtime.loop_closing import LoopCloser, kf_signature
from eao_slam_torch.runtime.map_state import MapState, empty_map_state
from eao_slam_torch.solvers.init2view import initialize_two_view
from eao_slam_torch.solvers.pnp import pnp_ransac

NO_IMAGES = 0
NOT_INITIALIZED = 1
OK = 2
LOST = 3


def np_compose(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    R = A[:3, :3] @ B[:3, :3]
    t = A[:3, :3] @ B[:3, 3] + A[:3, 3]
    return np.concatenate([R, t[:, None]], axis=1)


def np_inverse(T: np.ndarray) -> np.ndarray:
    Rt = T[:3, :3].T
    return np.concatenate([Rt, (-Rt @ T[:3, 3])[:, None]], axis=1)


@dataclasses.dataclass
class FrameRecord:
    timestamp: float
    T_cw: Optional[np.ndarray]  # None while not tracked
    state: int
    n_inliers: int = 0


def _set_rows(arr: torch.Tensor, idx, val) -> torch.Tensor:
    """A copy of ``arr`` with ``arr[idx] = val``."""
    out = arr.clone()
    out[idx] = val
    return out


class MonoTracker:
    """The interactive per-frame tracker and local mapper, on one device."""

    def __init__(self, cfg: SystemConfig, device):
        self.cfg = cfg
        self.cam = cfg.camera
        self.device = torch.device(device)
        self.scale2 = scale_sigma2(cfg.orb.n_levels, cfg.orb.scale_factor, self.device)
        self.scale2_np = self.scale2.cpu().numpy()
        self.scale_factors = np.sqrt(self.scale2_np)
        # localization mode: the map is frozen (no keyframes, no new
        # points, no object updates; System::ActivateLocalizationMode)
        self.localization_only = False
        self._reset_state()

    def _reset_state(self):
        """Everything Tracking::Reset clears (src/Tracking.cc:2345-2393):
        map, keyframe database, loop closer, object landmarks, state
        machine, and the generator (reseeded from the config)."""
        cfg = self.cfg
        cap = cfg.capacity
        self.map: MapState = empty_map_state(cap, self.device)
        self.state = NO_IMAGES
        self.generator = torch.Generator().manual_seed(cfg.seed)

        # host mirrors (no device reads for the per-frame decisions)
        self.kf_slots: List[int] = []          # insertion order
        self.kf_pt_host = np.full((cap.max_keyframes, cap.max_features), -1, np.int32)
        self.kf_valid_host = np.zeros((cap.max_keyframes,), bool)
        self.pt_valid_host = np.zeros((cap.max_points,), bool)
        self.pt_first_kf_host = np.full((cap.max_points,), -1, np.int32)
        self.n_points = 0

        self.last_frame: Optional[Frame] = None
        self.last_T: Optional[np.ndarray] = None
        self.last_pt: Optional[torch.Tensor] = None
        self.velocity: Optional[np.ndarray] = None
        self.frames_since_kf = 0
        self.ref_kf_tracked = 0
        self.peak_since_kf = 0   # best inlier count since the last keyframe
        self.frame_id = 0
        self.init_ref: Optional[Frame] = None
        self.init_ref_t: float = 0.0
        self.init_gt: Optional[np.ndarray] = None   # [3, 4] T_wc of init_ref
        self.records: List[FrameRecord] = []

        self.loop_closer = LoopCloser(cfg) if cfg.tracking.enable_loop_closing else None

        # BoW vocabulary and recognition database: loaded from
        # cfg.vocab_path, else trained online from the first keyframes
        self.vocab: Optional[bow.Vocabulary] = None
        self.kfdb: Optional[KeyFrameDatabase] = None
        if cfg.use_bow and cfg.vocab_path:
            self.vocab = bow.load_vocabulary(cfg.vocab_path, self.device)
            self.kfdb = KeyFrameDatabase(self.vocab, cap.max_keyframes)

        self.obj_table = None
        self.obj_updater = None
        if cfg.flag.objects_enabled:
            self.obj_table = empty_object_table(cap.max_objects, device=self.device)
            self.obj_updater = ObjectUpdater(cfg)
        self._appear_new_object = False
        self.last_cuboids = None   # CubeSLAM proposals of the latest frame

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def reset(self):
        """Full reset (Tracking::Reset): map, keyframe database, loop
        closer and object table cleared, state NO_IMAGES; frame_id keeps
        counting."""
        frame_id = self.frame_id
        self._reset_state()
        self.frame_id = frame_id

    def set_localization_mode(self, on: bool):
        """Track against a frozen map (System::ActivateLocalizationMode)."""
        self.localization_only = bool(on)

    def track(self, frame: Frame, timestamp: float,
              gt_pose: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
        """Process one frame; returns the camera-from-world pose [3, 4], or
        None when tracking failed (System::TrackMonocular). ``gt_pose``:
        this frame's ground-truth T_wc [3, 4] in the ground frame, or None;
        the initializer frame's rotates the initial map onto the ground."""
        self.frame_id += 1
        if self.state in (NO_IMAGES, NOT_INITIALIZED):
            T = self._initialize(frame, timestamp, gt_pose)
        elif self.state == OK:
            T = self._track_frame(frame, timestamp)
        else:
            T = self._relocalize(frame, timestamp)
        # early-loss auto-reset: losing track right after initialization
        # means the initial map was bad (src/Tracking.cc:771-779)
        if self.state == LOST and len(self.kf_slots) <= 5 and not self.localization_only:
            self.reset()
        self.records.append(FrameRecord(timestamp, None if T is None else T.copy(), self.state,
                                        self.ref_kf_tracked if T is not None else 0))
        return T

    def keyframe_trajectory(self):
        """(timestamps, T_cw [N, 3, 4]) of the live keyframes in insertion
        order (System::SaveKeyFrameTrajectoryTUM)."""
        slots = [s for s in self.kf_slots if self.kf_valid_host[s]]
        return (self.map.kf_timestamp.cpu().numpy()[slots],
                self.map.kf_pose.cpu().numpy()[slots])

    def frame_trajectory(self):
        recs = [r for r in self.records if r.T_cw is not None]
        ts = np.array([r.timestamp for r in recs])
        Ts = np.stack([r.T_cw for r in recs]) if recs else np.zeros((0, 3, 4))
        return ts, Ts

    # ------------------------------------------------------------------
    # initialization (MonocularInitialization, src/Tracking.cc:806-939)
    # ------------------------------------------------------------------

    def _initialize(self, frame: Frame, timestamp: float,
                    gt_pose: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
        """Keep a reference frame with enough features (and its
        ground-truth pose), match the next frames to it, try two-view
        init."""
        min_init = self.cfg.tracking.min_init_matches
        n_feats = int(frame.valid.sum())
        if self.init_ref is None or n_feats < min_init:
            if n_feats >= min_init:
                self.init_ref, self.init_ref_t = frame, timestamp
                self.init_gt = gt_pose
                self.state = NOT_INITIALIZED
            return None
        ref = self.init_ref
        idx, d, ok = tk.match_for_init(ref.kp, ref.desc, ref.angle, ref.valid,
                                       frame.kp, frame.desc, frame.angle, frame.valid)
        if int(ok.sum()) < min_init:
            self.init_ref, self.init_ref_t = frame, timestamp
            self.init_gt = gt_pose
            return None
        res = initialize_two_view(self.cam, ref.kp, frame.kp[idx.long()], ok,
                                  generator=self.generator, min_triangulated=min_init // 2)
        if not bool(res.success):
            return None
        return self._create_initial_map(ref, frame, timestamp, idx, res)

    def _create_initial_map(self, ref: Frame, frame: Frame, timestamp, idx, res):
        """CreateInitialMapMonocular: two keyframes, triangulated points,
        global BA, median-depth scale normalisation."""
        dev = self.device
        good = res.point_ok.cpu().numpy()
        pts = res.points.cpu().numpy()
        T21 = res.T21.cpu().numpy()
        depths = pts[good][:, 2]
        med = float(np.median(depths)) if len(depths) else 1.0
        if med <= 0:
            return None
        pts = pts / med
        T21 = np.concatenate([T21[:, :3], T21[:, 3:] / med], axis=1)

        cap = self.cfg.capacity
        rows = np.nonzero(good)[0][: cap.max_points]
        n_new = len(rows)
        slots = np.arange(n_new, dtype=np.int64)
        idx_np = idx.cpu().numpy()

        oct1 = ref.octave.cpu().numpy()[rows]
        X = pts[rows]
        dist = np.linalg.norm(X, axis=1)
        max_d = dist * self.scale_factors[np.clip(oct1, 0, len(self.scale_factors) - 1)]
        min_d = max_d / self.scale_factors[-1]
        normal = X / np.maximum(dist, 1e-9)[:, None]

        def t(x, dt=torch.float32):
            return torch.as_tensor(np.ascontiguousarray(x), device=dev).to(dt)

        s = t(slots, torch.int64)
        m = self.map
        self.map = m._replace(
            pt_pos=_set_rows(m.pt_pos, s, t(X)), pt_valid=_set_rows(m.pt_valid, s, True),
            pt_desc=_set_rows(m.pt_desc, s, ref.desc[t(rows, torch.int64)]),
            pt_normal=_set_rows(m.pt_normal, s, t(normal)),
            pt_min_dist=_set_rows(m.pt_min_dist, s, t(min_d)),
            pt_max_dist=_set_rows(m.pt_max_dist, s, t(max_d)),
            pt_first_kf=_set_rows(m.pt_first_kf, s, 0))
        self.pt_valid_host[slots] = True
        self.pt_first_kf_host[slots] = 0
        self.n_points = n_new

        F = cap.max_features
        pt1 = np.full((F,), -1, np.int32)
        pt1[rows] = slots
        pt2 = np.full((F,), -1, np.int32)
        pt2[idx_np[rows]] = slots
        self._insert_keyframe(ref, self.init_ref_t, np.eye(3, 4, dtype=np.float32), pt1)
        self._insert_keyframe(frame, timestamp, T21, pt2)

        ba = run_local_ba(self.cam, self.map, self.kf_slots[-2:], [self.kf_slots[-2]],
                          self.scale2_np, cap.local_ba_points)
        self._apply_ba(ba)
        if self.init_gt is not None:
            self._align_world_to_ground(np.asarray(self.init_gt, np.float64))

        T_final = self.map.kf_pose[self.kf_slots[-1]].cpu().numpy()
        self.state = OK
        self.last_frame = frame
        self.last_T = T_final
        self.last_pt = torch.as_tensor(self.kf_pt_host[self.kf_slots[-1]], device=dev)
        self.velocity = None
        self.frames_since_kf = 0
        self.ref_kf_tracked = int((pt2 >= 0).sum())
        return T_final

    def _align_world_to_ground(self, init_to_ground: np.ndarray) -> None:
        """Rotate the world frame onto the ground with the initializer
        frame's ground-truth pose G = T_wc (src/Tracking.cc:1018-1045):
        keyframe poses become T_cw G^-1, point positions R_G X + t_G and
        point normals R_G n, in float32 over every slot. Gravity is then the
        world's -y axis, which the object yaw (``objects.state.yaw_rotation``)
        assumes."""
        G = init_to_ground.astype(np.float32)
        G_inv = np_inverse(G)

        def t(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=self.device)

        R_G, t_G = t(G[:3, :3]), t(G[:3, 3])
        m = self.map
        kf_R, kf_t = m.kf_pose[..., :3], m.kf_pose[..., 3]
        new_R = torch.einsum("kab,bc->kac", kf_R, t(G_inv[:3, :3]))
        new_t = torch.einsum("kab,b->ka", kf_R, t(G_inv[:3, 3])) + kf_t
        self.map = m._replace(
            kf_pose=torch.cat([new_R, new_t[..., None]], dim=-1),
            pt_pos=m.pt_pos @ R_G.T + t_G[None, :],
            pt_normal=m.pt_normal @ R_G.T,
        )

    # ------------------------------------------------------------------
    # per-frame tracking (Tracking::Track, src/Tracking.cc:562-804)
    # ------------------------------------------------------------------

    def _track_pose(self, frame: Frame) -> Optional[tk.TrackResult]:
        """The frame's pose: the motion model, the reference keyframe when
        it fails, then the local map. None when too few inliers remain
        after the first two."""
        cfg = self.cfg
        m = self.map
        T_pred = np_compose(self.velocity, self.last_T) if self.velocity is not None \
            else self.last_T
        lf = self.last_frame
        r = tk.track_motion_model(
            self.cam, m.pt_pos, m.pt_valid,
            torch.as_tensor(np.asarray(T_pred, np.float32), device=self.device),
            lf.kp, lf.desc, lf.octave, lf.angle, lf.valid, self.last_pt,
            frame.kp, frame.desc, frame.octave, frame.angle, frame.valid, self.scale2,
            radius=cfg.matcher.search_radius_motion)
        if int(r.n_inliers) < cfg.tracking.min_inliers_after_pose:
            # TrackReferenceKeyFrame from the last pose
            ref = self.kf_slots[-1]
            r = tk.track_reference_kf(
                self.cam, m.pt_pos, m.pt_valid,
                torch.as_tensor(np.asarray(self.last_T, np.float32), device=self.device),
                m.kf_desc[ref], m.kf_kp_valid[ref], m.kf_pt_idx[ref],
                frame.kp, frame.desc, frame.octave, frame.valid, self.scale2)
            if int(r.n_inliers) < cfg.tracking.min_inliers_after_pose:
                return None
        return self._track_local_map(frame, r)

    def _track_frame(self, frame: Frame, timestamp: float) -> Optional[np.ndarray]:
        cfg = self.cfg
        r2 = self._track_pose(frame)
        if r2 is None:
            self.state = LOST
            return None
        n2 = int(r2.n_inliers)
        if n2 < cfg.tracking.min_tracked_for_ok:
            self.state = LOST
            return None

        T = r2.T.cpu().numpy()
        self.velocity = np_compose(T, np_inverse(self.last_T))
        self.frames_since_kf += 1
        self.peak_since_kf = max(self.peak_since_kf, n2)

        # EAO object pass (TrackWithMotionModel's object work,
        # src/Tracking.cc:1246-1647)
        self._appear_new_object = False
        has_boxes = frame.box_valid is not None and bool(frame.box_valid.any())
        if self.obj_updater is not None and not self.localization_only and has_boxes:
            self.map, self.obj_table, self._appear_new_object = self.obj_updater.frame_update(
                self.map, self.obj_table,
                (frame.boxes, frame.box_class, frame.box_score, frame.box_valid),
                r2.T, frame.kp, r2.cur_pt, self.frame_id,
                lines=(frame.lines, frame.line_valid))

        # optional CubeSLAM single-view cuboid proposals (bCubeslam,
        # src/Tracking.cc:1211-1238: kept for drawing, off by default), on
        # frames that carry line segments, as in the reference package
        self.last_cuboids = None
        if cfg.objects.use_cubeslam and has_boxes and frame.lines is not None:
            self.last_cuboids = detect_cuboid(self.cam, r2.T, frame.boxes, frame.box_valid,
                                              frame.lines, frame.line_valid)

        if not self.localization_only and self._need_new_keyframe(frame, n2):
            self._insert_keyframe(frame, timestamp, T, r2.cur_pt.cpu().numpy(),
                                  by_object=self._appear_new_object)
            self._local_mapping()
            newest = self.kf_slots[-1]
            T = self.map.kf_pose[newest].cpu().numpy()
            self.frames_since_kf = 0
            self.ref_kf_tracked = n2
            self.peak_since_kf = n2
            self.last_pt = torch.as_tensor(self.kf_pt_host[newest], device=self.device)
            # a velocity across the BA's pose correction would be
            # inconsistent: rebase it on the corrected pose
            self.velocity = None
        else:
            self.last_pt = r2.cur_pt
        self.last_frame = frame
        self.last_T = T
        return T

    def _track_local_map(self, frame: Frame, r: tk.TrackResult) -> tk.TrackResult:
        """TrackLocalMap: widen the matches against the whole map and
        re-optimise the pose."""
        m = self.map
        return tk.track_local_map_step(
            self.cam, m.pt_pos, m.pt_valid, m.pt_desc, m.pt_normal,
            m.pt_min_dist, m.pt_max_dist, r.T, r.cur_pt,
            frame.kp, frame.desc, frame.octave, frame.valid, self.scale2,
            n_levels=self.cfg.orb.n_levels)

    def _reloc_candidates(self, frame: Frame, k: int = 5) -> List[int]:
        """Relocalization candidates (DetectRelocalizationCandidates,
        src/KeyFrameDatabase.cc:198): the BoW database when a vocabulary
        exists, the loop closer's signatures otherwise, the newest
        keyframes without either."""
        slots = [s for s in self.kf_slots if self.kf_valid_host[s]]
        if self.kfdb is not None and self.vocab is not None and slots:
            word, _ = bow.quantize(self.vocab, frame.desc)
            q = bow.bow_vector(self.vocab, word, frame.valid).cpu().numpy()
            cands = self.kfdb.detect_reloc_candidates(q, self.covis_matrix())
            if cands:
                return cands[:k]
        if self.loop_closer is None or not slots:
            return list(reversed(self.kf_slots[-k:]))
        sig = kf_signature(frame.desc, frame.valid).cpu().numpy()
        scores = self.loop_closer.signatures[slots] @ sig
        return [slots[i] for i in np.argsort(-scores)[:k]]

    def _relocalize(self, frame: Frame, timestamp: float) -> Optional[np.ndarray]:
        """Tracking::Relocalization (src/Tracking.cc:2184): candidates ->
        brute descriptor match -> EPnP RANSAC -> local-map tracking from
        the recovered pose."""
        P = self.cfg.capacity.max_points
        n_lv = self.scale2.shape[0]
        F = frame.kp.shape[0]
        m = self.map
        for slot in self._reloc_candidates(frame):
            if not self.kf_valid_host[slot]:
                continue
            pt_kf = m.kf_pt_idx[slot]
            q_valid = m.kf_kp_valid[slot] & (pt_kf >= 0)
            idx, _, ok = matching.search_brute(m.kf_desc[slot], q_valid, frame.desc, frame.valid,
                                               max_dist=matching.TH_LOW, ratio=0.75)
            if int(ok.sum()) < 15:
                continue
            il = idx.long()
            Xw = m.pt_pos[torch.clamp(pt_kf, 0, P - 1).long()]
            inv_s2 = 1.0 / self.scale2[torch.clamp(frame.octave[il], 0, n_lv - 1).long()]
            pnp = pnp_ransac(self.cam, Xw, frame.kp[il], ok, inv_s2, generator=self.generator)
            if not bool(pnp.success):
                continue
            # the matched features inherit the keyframe's points
            keep = ok & pnp.inliers
            cur_pt = tk.scatter_max(torch.full((F,), -1, dtype=torch.int32, device=self.device),
                                    il, torch.where(keep, pt_kf, -1))
            if int(pnp.n_inliers) < self.cfg.tracking.min_inliers_after_pose:
                continue
            r2 = self._track_local_map(
                frame, tk.TrackResult(pnp.T.to(torch.float32), cur_pt, pnp.n_inliers, ok.sum()))
            if int(r2.n_inliers) >= self.cfg.tracking.min_tracked_for_ok:
                self.state = OK
                self.last_frame = frame
                self.last_T = r2.T.cpu().numpy()
                self.last_pt = r2.cur_pt
                self.velocity = None
                return self.last_T
        return None

    def _need_new_keyframe(self, frame: Frame, n_tracked: int) -> bool:
        """Mono keyframe policy (Tracking::NeedNewKeyFrame,
        src/Tracking.cc:1777-1900): every max_frames_between_kf frames or
        when the tracked count falls under the ratio of the best since the
        last keyframe, or (path 2) when a new object landmark appeared."""
        cfg = self.cfg.tracking
        if len(self.kf_slots) == 0:
            return False
        c1 = self.frames_since_kf >= cfg.max_frames_between_kf
        base = max(self.ref_kf_tracked, self.peak_since_kf, 1)
        c2 = n_tracked < cfg.kf_tracked_ratio * base
        c3 = self._appear_new_object
        return (c1 or c2 or c3) and n_tracked > cfg.min_matches_ref_kf

    # ------------------------------------------------------------------
    # keyframe insertion and local mapping
    # ------------------------------------------------------------------

    def _free_kf_slot(self) -> int:
        free = np.nonzero(~self.kf_valid_host)[0]
        if len(free) == 0:
            raise RuntimeError("keyframe capacity exhausted")
        return int(free[0])

    def _insert_keyframe(self, frame: Frame, timestamp: float, T: np.ndarray,
                         cur_pt: np.ndarray, by_object: bool = False) -> int:
        slot = self._free_kf_slot()
        m = self.map
        fields = dict(
            kf_pose=torch.as_tensor(np.array(T, np.float32), device=self.device),
            kf_valid=True, kf_timestamp=float(timestamp), kf_frame_id=self.frame_id,
            kf_kp=frame.kp, kf_desc=frame.desc, kf_octave=frame.octave,
            kf_angle=frame.angle, kf_kp_valid=frame.valid,
            kf_pt_idx=torch.as_tensor(cur_pt, device=self.device).to(torch.int32),
            kf_by_object=bool(by_object),
        )
        self.map = m._replace(**{name: _set_rows(getattr(m, name), slot, val)
                                 for name, val in fields.items()})
        self.kf_valid_host[slot] = True
        self.kf_pt_host[slot] = np.asarray(cur_pt)
        self.kf_slots.append(slot)
        self._bow_on_keyframe(slot)
        return slot

    def _bow_on_keyframe(self, slot: int) -> None:
        """Frame::ComputeBoW + KeyFrameDatabase::add. Without a vocabulary
        file, the vocabulary (k=10, depth 3) is trained once
        ``bow_bootstrap_kfs`` keyframes exist, from all their descriptors,
        and every live keyframe is added then."""
        cfg = self.cfg
        if not cfg.use_bow:
            return
        if self.vocab is None:
            if cfg.vocab_path is not None or len(self.kf_slots) < cfg.bow_bootstrap_kfs:
                return
            slots = [s for s in self.kf_slots if self.kf_valid_host[s]]
            st = torch.as_tensor(slots, device=self.device)
            desc = self.map.kf_desc[st].cpu().numpy()
            mask = self.map.kf_kp_valid[st].cpu().numpy()
            self.vocab = bow.build_vocabulary(desc[mask], k=10, depth=3, seed=cfg.seed,
                                              device=self.device)
            self.kfdb = KeyFrameDatabase(self.vocab, cfg.capacity.max_keyframes)
            for s in slots:
                self._bow_add(s)
            return
        self._bow_add(slot)

    def _bow_add(self, slot: int) -> None:
        word, _ = bow.quantize(self.vocab, self.map.kf_desc[slot])
        vec = bow.bow_vector(self.vocab, word, self.map.kf_kp_valid[slot])
        self.kfdb.add(slot, vec.cpu().numpy())

    def covis_matrix(self) -> np.ndarray:
        """[K, K] covisibility weights: one incidence product over the
        observation table on the device (``compaction.covisibility``)."""
        m = self.map
        return covisibility(m.kf_pt_idx, m.kf_kp_valid, m.kf_valid,
                            m.pt_pos.shape[0]).cpu().numpy().astype(np.int64)

    def _covisible_neighbors(self, slot: int, k: int, min_weight: int = 10) -> List[int]:
        """The top-k live keyframes by shared points with ``slot`` (at least
        ``min_weight``), heaviest first (KeyFrame::UpdateConnections)."""
        row = self.covis_matrix()[slot]
        out = []
        for s in np.argsort(-row, kind="stable"):
            if row[s] < min_weight:
                break
            if s != slot and self.kf_valid_host[s]:
                out.append(int(s))
            if len(out) >= k:
                break
        return out

    def _local_mapping(self):
        """Per-keyframe mapping: triangulation with the covisible
        neighbours, fusion both ways, the duplicate merge, windowed BA,
        point culling, the descriptor refresh, the object merge pass,
        keyframe culling and loop detection."""
        cfg = self.cfg
        slot = self.kf_slots[-1]
        neighbors = self._covisible_neighbors(slot, cfg.mapping.triangulation_neighbors,
                                              cfg.mapping.min_covis_weight)
        for nb in neighbors:
            self._triangulate_new_points(slot, nb)
        # fuse map points into the new keyframe's unmatched features and
        # into its two best neighbours' (SearchInNeighbors both ways,
        # src/LocalMapping.cc:459-539)
        for s in [slot] + neighbors[:2]:
            self._fuse_into_keyframe(s)
        self._merge_duplicate_points(slot)
        window = self._ba_window()
        self._apply_ba(self._local_ba(window))
        self._cull_points()
        self._refresh_descriptors(window)

        # keyframe-rate object merge and overlap resolution
        # (src/LocalMapping.cc:799-882)
        if self.obj_updater is not None:
            self.map, self.obj_table, _, _ = run_merge_pass(self.map, self.obj_table)

        self._cull_keyframes(window)
        if self.loop_closer is not None:
            self.loop_closer.on_keyframe(self, slot)

    def _fuse_into_keyframe(self, s: int):
        m = self.map
        fused = fuse_into_keyframe(
            self.cam, m.pt_pos, m.pt_valid, m.pt_desc, m.pt_min_dist, m.pt_max_dist,
            m.kf_pose[s], m.kf_kp[s], m.kf_desc[s], m.kf_octave[s], m.kf_kp_valid[s],
            m.kf_pt_idx[s], self.scale2)
        self.map = m._replace(kf_pt_idx=_set_rows(m.kf_pt_idx, s, fused))
        self.kf_pt_host[s] = fused.cpu().numpy()

    def _merge_duplicate_points(self, slot: int):
        """The duplicate-point merge (ORBmatcher::Fuse's conflict branch)."""
        m = self.map
        new_kf_pt, new_pt_valid = merge_duplicate_points(
            self.cam, m.pt_pos, m.pt_valid, m.pt_desc, m.pt_min_dist, m.pt_max_dist,
            m.kf_pt_idx, m.kf_pose[slot], m.kf_kp[slot], m.kf_desc[slot], m.kf_octave[slot],
            m.kf_kp_valid[slot], m.kf_pt_idx[slot], self.scale2)
        self.map = m._replace(kf_pt_idx=new_kf_pt, pt_valid=new_pt_valid)
        kf_pt_np = new_kf_pt.cpu().numpy()
        for s in self.kf_slots:
            self.kf_pt_host[s] = kf_pt_np[s]
        self.pt_valid_host &= new_pt_valid.cpu().numpy()

    def _ba_window(self) -> List[int]:
        """The newest keyframes, the local BA's window."""
        return self.kf_slots[-min(len(self.kf_slots), self.cfg.mapping.local_ba_kf_window):]

    def _local_ba(self, window: List[int]):
        """Windowed BA, its oldest keyframe and the map's first fixed."""
        fixed = [window[0]]
        if self.kf_slots[0] in window:
            fixed.append(self.kf_slots[0])
        return run_local_ba(self.cam, self.map, window, fixed, self.scale2_np,
                            self.cfg.capacity.local_ba_points)

    def _refresh_descriptors(self, window: List[int]):
        """The distinctive-descriptor refresh over the window."""
        Wpad = self.cfg.mapping.local_ba_kf_window
        win = np.zeros((Wpad,), np.int64)
        win[: len(window)] = window
        wv = np.zeros((Wpad,), bool)
        wv[: len(window)] = True
        m = self.map
        self.map = m._replace(pt_desc=refresh_point_descriptors(
            m.kf_pt_idx, m.kf_desc, m.kf_kp_valid, m.pt_desc,
            torch.as_tensor(win, device=self.device), torch.as_tensor(wv, device=self.device)))

    def _cull_keyframes(self, window):
        """KeyFrameCulling (src/LocalMapping.cc:637-707): a window keyframe
        (not the newest, not the first two, not object-made) whose tracked
        points are more than ``kf_cull_redundancy`` seen by 3 other
        keyframes at a similar or finer scale is erased."""
        if len(self.kf_slots) < 5:
            return
        ratio = self.cfg.mapping.kf_cull_redundancy
        P = self.cfg.capacity.max_points
        by_obj = self.map.kf_by_object.cpu().numpy()
        oct_host = self.map.kf_octave.cpu().numpy()
        obs_count = np.zeros((P,), np.int32)
        best_oct = np.full((P,), 99, np.int32)
        for s in self.kf_slots:
            if not self.kf_valid_host[s]:
                continue
            pts = self.kf_pt_host[s]
            sel = pts >= 0
            obs_count[pts[sel]] += 1
            np.minimum.at(best_oct, pts[sel], oct_host[s][sel])
        protected = set(self.kf_slots[:2]) | {self.kf_slots[-1]}
        for s in list(window[:-1]):
            if s in protected or not self.kf_valid_host[s] or by_obj[s]:
                continue
            pts = self.kf_pt_host[s]
            sel = pts >= 0
            ids = pts[sel]
            if len(ids) < 10:
                continue
            redundant = (obs_count[ids] >= 4) & (best_oct[ids] <= oct_host[s][sel] + 1)
            if redundant.mean() > ratio:
                obs_count[ids] -= 1
                self.kf_valid_host[s] = False
                self.kf_pt_host[s] = -1
                m = self.map
                self.map = m._replace(kf_valid=_set_rows(m.kf_valid, s, False),
                                      kf_pt_idx=_set_rows(m.kf_pt_idx, s, -1))
                self.kf_slots.remove(s)
                if self.kfdb is not None:
                    self.kfdb.erase(s)

    def _triangulate_new_points(self, slot: int, nb: int):
        """New points from the epipolar matches of two keyframes' unmatched
        features (LocalMapping::CreateNewMapPoints), in the lowest free
        point slots."""
        m = self.map
        tri = triangulate_with_neighbor(
            self.cam, m.kf_pose[slot], m.kf_kp[slot], m.kf_desc[slot], m.kf_octave[slot],
            m.kf_kp_valid[slot], m.kf_pt_idx[slot],
            m.kf_pose[nb], m.kf_kp[nb], m.kf_desc[nb], m.kf_octave[nb],
            m.kf_kp_valid[nb], m.kf_pt_idx[nb], self.scale2)
        rows = np.nonzero(tri.good.cpu().numpy())[0]
        if len(rows) == 0:
            return
        free = np.nonzero(~self.pt_valid_host)[0]
        n_new = min(len(rows), len(free))
        rows = rows[:n_new]
        slots = free[:n_new].astype(np.int64)

        X = tri.points.cpu().numpy()[rows]
        idx2 = tri.idx2.cpu().numpy()[rows]
        oct1 = m.kf_octave[slot].cpu().numpy()[rows]
        T1 = m.kf_pose[slot].cpu().numpy()
        O1 = -T1[:3, :3].T @ T1[:3, 3]
        dist = np.linalg.norm(X - O1[None, :], axis=1)
        max_d = dist * self.scale_factors[np.clip(oct1, 0, len(self.scale_factors) - 1)]
        min_d = max_d / self.scale_factors[-1]
        normal = (X - O1[None, :]) / np.maximum(dist, 1e-9)[:, None]

        def t(x, dt=torch.float32):
            return torch.as_tensor(np.ascontiguousarray(x), device=self.device).to(dt)

        js = t(slots, torch.int64)
        rows_t = t(rows, torch.int64)
        kf_pt_idx = m.kf_pt_idx.clone()
        kf_pt_idx[slot, rows_t] = js.to(torch.int32)
        kf_pt_idx[nb, t(idx2, torch.int64)] = js.to(torch.int32)
        self.map = m._replace(
            pt_pos=_set_rows(m.pt_pos, js, t(X)), pt_valid=_set_rows(m.pt_valid, js, True),
            pt_desc=_set_rows(m.pt_desc, js, m.kf_desc[slot][rows_t]),
            pt_normal=_set_rows(m.pt_normal, js, t(normal)),
            pt_min_dist=_set_rows(m.pt_min_dist, js, t(min_d)),
            pt_max_dist=_set_rows(m.pt_max_dist, js, t(max_d)),
            pt_first_kf=_set_rows(m.pt_first_kf, js, slot),
            kf_pt_idx=kf_pt_idx)
        self.pt_valid_host[slots] = True
        self.pt_first_kf_host[slots] = slot
        self.kf_pt_host[slot, rows] = slots
        self.kf_pt_host[nb, idx2] = slots
        self.n_points += n_new

    def _apply_ba(self, ba):
        m = self.map
        ws = torch.as_tensor(ba.kf_slots, device=self.device)
        keep = ba.pt_slots >= 0
        pt_pos = _set_rows(m.pt_pos, torch.as_tensor(ba.pt_slots[keep], device=self.device),
                           ba.points[torch.as_tensor(keep, device=self.device)])
        m = m._replace(kf_pose=_set_rows(m.kf_pose, ws, ba.poses), pt_pos=pt_pos)
        # drop the observations BA classified outliers
        drop = ba.drop_obs
        if drop.any():
            new_pt = self.kf_pt_host[ba.kf_slots]
            new_pt[drop] = -1
            self.kf_pt_host[ba.kf_slots] = new_pt
            m = m._replace(kf_pt_idx=_set_rows(m.kf_pt_idx, ws,
                                               torch.as_tensor(new_pt, device=self.device)))
        self.map = m

    def _cull_points(self):
        """MapPointCulling (src/LocalMapping.cc:175): points seen by fewer
        than 2 live keyframes die, unless the newest keyframe made them."""
        obs = np.zeros((self.cfg.capacity.max_points,), np.int32)
        valid_rows = self.kf_pt_host[self.kf_valid_host]
        np.add.at(obs, valid_rows[valid_rows >= 0], 1)
        recent_kf = self.kf_slots[-1] if self.kf_slots else 0
        stale = self.pt_valid_host & (obs < 2) & (self.pt_first_kf_host != recent_kf)
        if stale.any():
            idx = np.nonzero(stale)[0]
            self.map = self.map._replace(pt_valid=_set_rows(
                self.map.pt_valid, torch.as_tensor(idx, device=self.device), False))
            self.pt_valid_host[idx] = False
