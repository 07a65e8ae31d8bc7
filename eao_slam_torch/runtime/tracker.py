"""Monocular bootstrap: two-view initialization and the initial map.

The port of the reference MonoTracker covers what the chunked tracker
needs before its first chunk: frames are fed one at a time until two-view
initialization succeeds, then the two keyframes, their triangulated points
and a global BA form the initial map. Given the ground-truth pose of the
initializer frame (the GT-pose protocol of a TUM sequence), the initial
map is then rotated onto the ground. Per-frame tracking after that point
(the interactive ``chunked=False`` path) is ROADMAP.md Queue 1 item 13.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from eao_slam_torch.config import SystemConfig
from eao_slam_torch.ops.orb import scale_sigma2
from eao_slam_torch.runtime import tracking_kernels as tk
from eao_slam_torch.runtime.frame import Frame
from eao_slam_torch.runtime.local_mapping import run_local_ba
from eao_slam_torch.runtime.map_state import MapState, empty_map_state
from eao_slam_torch.solvers.init2view import initialize_two_view

NO_IMAGES = 0
NOT_INITIALIZED = 1
OK = 2
LOST = 3


class MonoTracker:
    """Bootstrap half of the monocular tracker, on one device."""

    def __init__(self, cfg: SystemConfig, device):
        self.cfg = cfg
        self.cam = cfg.camera
        self.device = torch.device(device)
        self.scale2 = scale_sigma2(cfg.orb.n_levels, cfg.orb.scale_factor, self.device)
        self.scale2_np = self.scale2.cpu().numpy()
        self.scale_factors = np.sqrt(self.scale2_np)
        # RANSAC hypotheses are drawn on the host, so a seed gives the same
        # draws on every device
        self.generator = torch.Generator().manual_seed(cfg.seed)
        self._reset_state()

    def _reset_state(self):
        cap = self.cfg.capacity
        self.map: MapState = empty_map_state(cap, self.device)
        self.state = NO_IMAGES
        self.kf_slots: List[int] = []
        self.kf_pt_host = np.full((cap.max_keyframes, cap.max_features), -1, np.int32)
        self.kf_valid_host = np.zeros((cap.max_keyframes,), bool)
        self.n_points = 0
        self.last_frame: Optional[Frame] = None
        self.last_T: Optional[np.ndarray] = None
        self.last_pt: Optional[torch.Tensor] = None
        self.ref_kf_tracked = 0
        self.frame_id = 0
        self.init_ref: Optional[Frame] = None
        self.init_ref_t: float = 0.0
        self.init_gt: Optional[np.ndarray] = None   # [3, 4] T_wc of init_ref

    # ------------------------------------------------------------------

    def track(self, frame: Frame, timestamp: float,
              gt_pose: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
        """Feed one frame while not initialised; returns the new keyframe's
        camera-from-world pose [3, 4] once the map exists, else None.
        ``gt_pose``: this frame's ground-truth T_wc [3, 4] in the ground
        frame, or None; the initializer frame's is kept, and the initial map
        is rotated onto the ground with it."""
        self.frame_id += 1
        if self.state not in (NO_IMAGES, NOT_INITIALIZED):
            raise NotImplementedError(
                "per-frame tracking after initialization is the interactive "
                "tracker, not ported yet: ROADMAP.md Queue 1 item 13")
        return self._initialize(frame, timestamp, gt_pose)

    def _initialize(self, frame: Frame, timestamp: float,
                    gt_pose: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
        """MonocularInitialization: keep a reference frame with enough
        features (and its ground-truth pose), match the next frames to it,
        try two-view init."""
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
        pt_pos, pt_valid, pt_desc = m.pt_pos.clone(), m.pt_valid.clone(), m.pt_desc.clone()
        pt_normal, pt_min, pt_max = m.pt_normal.clone(), m.pt_min_dist.clone(), m.pt_max_dist.clone()
        pt_first = m.pt_first_kf.clone()
        pt_pos[s] = t(X)
        pt_valid[s] = True
        pt_desc[s] = ref.desc[t(rows, torch.int64)]
        pt_normal[s] = t(normal)
        pt_min[s] = t(min_d)
        pt_max[s] = t(max_d)
        pt_first[s] = 0
        self.map = m._replace(pt_pos=pt_pos, pt_valid=pt_valid, pt_desc=pt_desc,
                              pt_normal=pt_normal, pt_min_dist=pt_min,
                              pt_max_dist=pt_max, pt_first_kf=pt_first)
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
        last = self.kf_pt_host[self.kf_slots[-1]]
        self.last_pt = torch.as_tensor(np.where(last >= 0, last, -1), device=dev)
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
        Rt = G[:3, :3].T
        G_inv = np.concatenate([Rt, (-Rt @ G[:3, 3])[:, None]], axis=1)

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

    def _free_kf_slot(self) -> int:
        free = np.nonzero(~self.kf_valid_host)[0]
        if len(free) == 0:
            raise RuntimeError("keyframe capacity exhausted")
        return int(free[0])

    def _insert_keyframe(self, frame: Frame, timestamp: float, T: np.ndarray,
                         cur_pt: np.ndarray) -> int:
        slot = self._free_kf_slot()
        m = self.map
        fields = dict(
            kf_pose=torch.as_tensor(np.asarray(T, np.float32), device=self.device),
            kf_valid=True, kf_timestamp=float(timestamp), kf_frame_id=self.frame_id,
            kf_kp=frame.kp, kf_desc=frame.desc, kf_octave=frame.octave,
            kf_angle=frame.angle, kf_kp_valid=frame.valid,
            kf_pt_idx=torch.as_tensor(cur_pt, device=self.device).to(torch.int32),
            kf_by_object=False,
        )
        upd = {}
        for name, val in fields.items():
            arr = getattr(m, name).clone()
            arr[slot] = val
            upd[name] = arr
        self.map = m._replace(**upd)
        self.kf_valid_host[slot] = True
        self.kf_pt_host[slot] = np.asarray(cur_pt)
        self.kf_slots.append(slot)
        return slot

    def _apply_ba(self, ba):
        m = self.map
        ws = torch.as_tensor(ba.kf_slots, device=self.device)
        kf_pose = m.kf_pose.clone()
        kf_pose[ws] = ba.poses
        keep = ba.pt_slots >= 0
        pt_pos = m.pt_pos.clone()
        keep_t = torch.as_tensor(keep, device=self.device)
        pt_pos[torch.as_tensor(ba.pt_slots[keep], device=self.device)] = ba.points[keep_t]
        m = m._replace(kf_pose=kf_pose, pt_pos=pt_pos)
        drop = ba.drop_obs
        if drop.any():
            new_pt = self.kf_pt_host[ba.kf_slots]
            new_pt[drop] = -1
            self.kf_pt_host[ba.kf_slots] = new_pt
            kf_pt_idx = m.kf_pt_idx.clone()
            kf_pt_idx[ws] = torch.as_tensor(new_pt, device=self.device)
            m = m._replace(kf_pt_idx=kf_pt_idx)
        self.map = m
