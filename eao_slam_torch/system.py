"""System facade, in geometry mode or with the EAO object layer
(``flag=DemoFlag.EAO`` or another object-layer flag), over one of two
trackers: the chunked tracker (the default) or, with ``chunked=False``,
the interactive per-frame MonoTracker, which returns a pose for every
frame and decides every branch on the host (the inspection path).

``System(cfg).track_monocular(img, t, boxes=...)`` bootstraps two-view
initialization frame by frame, then buffers raw images (and their offline
detector boxes) into chunks and dispatches each full chunk through ORB
extraction and chunk tracking. ``track_frame(frame, t)`` is the same with
pre-extracted front-end output (the feature-level seam; boxes ride on the
Frame). After every chunk the tracker runs its between-chunk passes:
object merge, map maintenance, loop closing and relocalization.
Poses come back at chunk granularity; ``flush()`` dispatches a partial
tail chunk, ``frame_trajectory()`` returns every tracked pose and
``current_pose()`` the newest one, extrapolated over the buffered frames.
With ``chunked=False`` each frame goes through ``MonoTracker.track`` as it
arrives and its pose comes back at once.
``reset()`` clears the map and restarts from scratch;
``activate_localization_mode()`` freezes the map and keeps tracking
against it until ``deactivate_localization_mode()``.
``set_groundtruth`` arms the GT-pose protocol of a TUM sequence: the
initializer frame's ground-truth pose rotates the initial map onto the
ground. ``save_keyframe_trajectory_tum``, ``save_frame_trajectory_tum`` and
``save_objects_json`` export a run; ``timing_stats`` summarises the time
per ``track_monocular`` call. ``save_checkpoint`` / ``load_checkpoint``
stop and resume a chunked run.

In FULL mode the images of keyframes are kept (keyed by keyframe slot,
re-keyed through compactions), and ``shutdown()`` runs the offline dense
phase over them as the reference's ProbabilityMapping thread does after
tracking: semi-dense inverse depth against each keyframe's most covisible
neighbours, 3D line segments, and a TSDF surface mesh;
``save_semidense_obj``, ``save_lines_obj`` and ``save_mesh_obj`` write
them.

Runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np
import torch

from eao_slam_torch.config import DemoFlag, SystemConfig, tum3_config
from eao_slam_torch.device import fp32_solvers, resolve_device
from eao_slam_torch.geometry import se3
from eao_slam_torch.io.trajectory import save_tum
from eao_slam_torch.io.tum import GroundTruth, load_groundtruth, lookup_pose_matrix
from eao_slam_torch.runtime.frame import Frame, empty_boxes, frame_from_image
from eao_slam_torch.runtime.scan_tracker import ChunkedTracker, batch_from_frames
from eao_slam_torch.runtime.tracker import MonoTracker
from eao_slam_torch.utils.profiling import TRACER

OK = 2


class System:
    """Monocular object SLAM engine (System::System + TrackMonocular)."""

    def __init__(self, config: Optional[SystemConfig] = None,
                 flag: DemoFlag | str = DemoFlag.NONE, chunked: bool = True,
                 chunk: int = 32, device=None, mesh=None):
        """``mesh``: None, a frame mesh over the ranks of a process group
        (``parallel.frames.make_frame_mesh``), or "auto" (a frame mesh over
        every rank when there is more than one, else None). Every rank
        feeds the same frames; with more than one rank the chunked tracker
        splits each chunk's extraction over the ranks by frame and runs
        the global BA of a loop correction through the distributed solver
        (``ChunkedTracker.ba_solver``)."""
        self.cfg = config if config is not None else tum3_config(flag)
        self.chunked = chunked
        if mesh == "auto":
            from eao_slam_torch.parallel.distributed import world
            from eao_slam_torch.parallel.frames import make_frame_mesh

            mesh = make_frame_mesh(device) if world()[1] > 1 else None
        if chunked:
            self.tracker = ChunkedTracker(self.cfg, chunk=chunk, device=device, mesh=mesh)
            self.tracker.compaction_listeners.append(self._on_compaction)
            self.device = self.tracker.device
        else:
            self.device = resolve_device(device)
            fp32_solvers()
            self.tracker = MonoTracker(self.cfg, self.device)
        # retained keyframe images (float32 [H, W]) for the offline dense
        # phase, keyed by keyframe slot and remapped through compactions
        self._kf_images: dict = {}
        # chunk buffers (image path and feature path: one per System)
        self._img_buf: list = []     # (img u8, ts, boxes or None)
        self._frame_buf: list = []   # (Frame, ts, img or None)
        # the offline dense phase's products (shutdown)
        self._semidense_result = None
        self._semidense_slots: list = []
        self._lines3d = None
        self._mesh_tris = None
        self._groundtruth: Optional[GroundTruth] = None
        self.timings: list = []      # seconds per track_monocular call
        # the process's tracer: the chunked path's stages and counters, off
        # unless turned on (utils/profiling.py)
        self.profiler = TRACER

    @property
    def _armed(self) -> bool:
        return self.chunked and self.tracker.carry is not None

    def track_monocular(self, img, timestamp: float, boxes=None) -> Optional[np.ndarray]:
        """Feed one grayscale image [H, W] and, with the object layer, its
        detector boxes: (boxes [B, 4] x y w h, class [B], score [B], valid
        [B]) in the offline-detector contract (``io.tum.load_yolo_boxes``).
        Returns T_cw [3, 4] when a pose is known at this call (every tracked
        frame with ``chunked=False``; chunked: bootstrap, or the last frame
        of a chunk just dispatched), else None."""
        t0 = time.perf_counter()
        T = None
        if self._armed:
            if self._frame_buf:
                raise RuntimeError("mixed track_frame / track_monocular")
            self._img_buf.append((np.asarray(img, np.uint8), float(timestamp), boxes))
            if len(self._img_buf) >= self.tracker.chunk:
                T = self._flush_images()
        else:
            T = self.track_frame(frame_from_image(self.cfg, img, self.device, boxes=boxes),
                                 timestamp, img=img)
        self.timings.append(time.perf_counter() - t0)
        return T

    def set_groundtruth(self, gt_or_path) -> None:
        """Arm the GT-pose protocol (src/Tracking.cc:197-241): a
        ``GroundTruth`` or the path of a TUM ground-truth file. Each frame
        fed before the tracker is armed looks up its pose by timestamp; the
        initializer frame's rotates the initial map onto the ground."""
        if isinstance(gt_or_path, str):
            gt_or_path = load_groundtruth(gt_or_path)
        if not isinstance(gt_or_path, GroundTruth):
            raise TypeError(f"expected a GroundTruth or a path, got {type(gt_or_path)}")
        self._groundtruth = gt_or_path

    def track_frame(self, frame: Frame, timestamp: float, img=None) -> Optional[np.ndarray]:
        """Feed a pre-extracted Frame (``runtime.frame.frame_from_arrays``)
        and, in FULL mode, optionally its image [H, W], kept if the frame
        becomes a keyframe. Returns T_cw [3, 4] as ``track_monocular``
        does."""
        frame = Frame(*(None if x is None else x.to(self.device) for x in frame))
        if self._armed:
            if self._img_buf:
                raise RuntimeError("mixed track_frame / track_monocular")
            self._frame_buf.append((frame, float(timestamp), img))
            if len(self._frame_buf) >= self.tracker.chunk:
                return self._flush_frames()
            return None
        gt_pose = None
        if self._groundtruth is not None:
            gt_pose = lookup_pose_matrix(self._groundtruth, timestamp)
        if not self.chunked:
            tr = self.tracker
            n_kf_before = len(tr.kf_slots)
            T = tr.track(frame, float(timestamp), gt_pose=gt_pose)
            if (img is not None and self.cfg.flag.semidense_enabled
                    and len(tr.kf_slots) > n_kf_before):
                self._kf_images[tr.kf_slots[-1]] = np.asarray(img, np.float32)
            return T
        inner = self.tracker.inner
        n_kf_before = len(inner.kf_slots)
        self.tracker.bootstrap(frame, float(timestamp), gt_pose=gt_pose)
        if (img is not None and self.cfg.flag.semidense_enabled
                and len(inner.kf_slots) > n_kf_before):
            self._kf_images[inner.kf_slots[-1]] = np.asarray(img, np.float32)
        return np.asarray(inner.last_T) if inner.state == OK else None

    def _flush_images(self) -> Optional[np.ndarray]:
        buf, self._img_buf = self._img_buf, []
        if not buf:
            return None
        imgs = np.stack([b[0] for b in buf])
        ts = np.asarray([b[1] for b in buf], np.float32)
        kw = {}
        if self.cfg.flag.objects_enabled:
            bx = [empty_boxes(self.cfg) if b[2] is None else b[2] for b in buf]
            kw = {k: np.stack([np.asarray(b[i]) for b in bx]) for i, k in
                  enumerate(("boxes", "box_class", "box_score", "box_valid"))}
        outs = self.tracker.track_images(imgs, ts, **kw)
        self._retain_kf_images([b[0] for b in buf])
        n = len(buf)
        return np.asarray(outs.T[n - 1]) if int(outs.state[n - 1]) == OK else None

    def _flush_frames(self) -> Optional[np.ndarray]:
        """Dispatch the buffered frames as one chunk, a short tail padded
        with its last frame and masked inactive."""
        buf, self._frame_buf = self._frame_buf, []
        if not buf:
            return None
        C = self.tracker.chunk
        n = len(buf)
        frames = [b[0] for b in buf] + [buf[-1][0]] * (C - n)
        ts = [b[1] for b in buf] + [buf[-1][1]] * (C - n)
        batch = batch_from_frames(frames, ts)
        if n < C:
            act = np.zeros((C,), bool)
            act[:n] = True
            batch = batch._replace(active=torch.as_tensor(act))
        outs = self.tracker.track_batch(batch)
        self._retain_kf_images([b[2] for b in buf])
        return np.asarray(outs.T[n - 1]) if int(outs.state[n - 1]) == OK else None

    def _retain_kf_images(self, chunk_imgs: list) -> None:
        """FULL mode: keep the image of every frame of the last chunk that
        became a keyframe (None where the caller gave no image)."""
        if not self.cfg.flag.semidense_enabled:
            return
        for i, slot in self.tracker.last_kf_slots:
            if i < len(chunk_imgs) and chunk_imgs[i] is not None:
                self._kf_images[slot] = np.asarray(chunk_imgs[i], np.float32)

    def _on_compaction(self, kf_remap: np.ndarray, pt_remap: np.ndarray):
        """Keyframe slots were compacted: re-key the retained images."""
        self._kf_images = {int(kf_remap[s]): img for s, img in self._kf_images.items()
                           if 0 <= s < len(kf_remap) and kf_remap[s] >= 0}

    def flush(self) -> None:
        """Dispatch any partially filled chunk."""
        if self._img_buf:
            self._flush_images()
        if self._frame_buf:
            self._flush_frames()

    def current_pose(self, extrapolate: bool = True):
        """The newest pose estimate without waiting for a chunk boundary:
        (timestamp, T_cw [3, 4]) of the newest tracked frame or, with
        ``extrapolate`` and frames still buffered while tracking is OK, that
        pose carried through the motion model once per buffered frame (the
        prediction the next chunk starts from) with the newest buffered
        timestamp. None before initialization. With ``chunked=False``: (None,
        the last tracked pose), as the reference returns it (``ROADMAP.md``
        Queue 3)."""
        tr = self.tracker
        if not self.chunked:
            return None if tr.last_T is None else (None, np.asarray(tr.last_T))
        t_last = T_last = None
        for t, T, _ in reversed(tr.records):
            if T is not None:
                t_last, T_last = t, T
                break
        if T_last is None:
            return None
        n_buf = len(self._img_buf) + len(self._frame_buf)
        if not extrapolate or n_buf == 0 or not tr.armed or tr.state != OK:
            return t_last, np.asarray(T_last)
        vel, T = tr.carry.velocity, tr.carry.T_last
        for _ in range(n_buf):
            T = se3.compose(vel, T)
        buf = self._img_buf or self._frame_buf
        return float(buf[-1][1]), T.cpu().numpy()

    def reset(self) -> None:
        """Clear the map and restart tracking from scratch (System::Reset):
        pending frames, retained keyframe images and the dense products go
        too."""
        self.tracker.reset()
        self._img_buf = []
        self._frame_buf = []
        self._kf_images.clear()
        self._semidense_result = None
        self._semidense_slots = []
        self._lines3d = None
        self._mesh_tris = None

    def activate_localization_mode(self) -> None:
        """Track against a frozen map (System::ActivateLocalizationMode,
        src/System.cc:254-270): no keyframes, points or object updates.
        Buffered frames are tracked first."""
        self.flush()
        self.tracker.set_localization_mode(True)

    def deactivate_localization_mode(self) -> None:
        self.flush()
        self.tracker.set_localization_mode(False)

    def timing_stats(self) -> dict:
        """Median and mean seconds per ``track_monocular`` call, and the
        rate the mean gives (mono_tum's end-of-run summary); {} before the
        first call."""
        if not self.timings:
            return {}
        t = np.asarray(self.timings)
        return {"median_s": float(np.median(t)), "mean_s": float(t.mean()),
                "fps": float(1.0 / max(t.mean(), 1e-9))}

    def save_keyframe_trajectory_tum(self, path: str) -> int:
        """The keyframe trajectory as a TUM file; returns its rows."""
        ts, Ts = self.keyframe_trajectory()
        return save_tum(path, ts, Ts)

    def save_frame_trajectory_tum(self, path: str) -> int:
        """Every tracked frame's pose as a TUM file; returns its rows."""
        ts, Ts = self.frame_trajectory()
        return save_tum(path, ts, Ts)

    def save_objects_json(self, path: str) -> int:
        """The live object landmarks (valid, not bad) as a JSON list of
        {id, class, center, size, yaw, n_obs}; an empty list in geometry
        mode. Returns the number written."""
        self.flush()
        t = self.tracker.obj_table
        out = []
        if t is not None:
            tab = {k: v.cpu().numpy() for k, v in t._asdict().items()}
            for j in np.flatnonzero(tab["valid"] & ~tab["bad"]):
                out.append({"id": int(j), "class": int(tab["cls"][j]),
                            "center": tab["center"][j].tolist(),
                            "size": (tab["cub_max"][j] - tab["cub_min"][j]).tolist(),
                            "yaw": float(tab["yaw"][j]), "n_obs": int(tab["n_obs"][j])})
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        return len(out)

    def save_checkpoint(self, path: str) -> None:
        """Serialize the tracker mid-sequence (pending buffers flush first):
        carry, trajectory records, loop-closer state, loop RNG, and the
        retained keyframe images."""
        from eao_slam_torch.runtime.checkpoint import save_chunked_checkpoint

        self._require_chunked()
        self.flush()
        save_chunked_checkpoint(path, self.tracker, kf_images=self._kf_images)

    def load_checkpoint(self, path: str) -> dict:
        """Restore a checkpoint into this System (same capacities); tracking
        resumes where the save left off, with the keyframe images the file
        holds. Returns the file's meta dict."""
        from eao_slam_torch.runtime.checkpoint import load_chunked_checkpoint, load_kf_images

        self._require_chunked()
        meta = load_chunked_checkpoint(path, self.tracker)
        self._kf_images = load_kf_images(path)
        self._img_buf = []
        self._frame_buf = []
        return meta

    def _require_chunked(self) -> None:
        if not self.chunked:
            raise ValueError("System checkpoints cover the chunked tracker; a MonoTracker's "
                             "map goes through runtime.checkpoint.save_checkpoint")

    def shutdown(self, semidense: bool = True):
        """Flush the tail chunk; then, in FULL mode with at least 4 retained
        keyframe images, the offline dense phase: semi-dense depth, 3D line
        segments and the surface mesh. Returns the SemiDenseResult (None
        when the phase did not run)."""
        self.flush()
        if semidense and self.cfg.flag.semidense_enabled and len(self._kf_images) >= 4:
            self._semidense_result = self._run_semidense()
            if self._semidense_result is not None:
                self._run_lines3d()
                self._run_mesh()
        return self._semidense_result

    def semidense_inputs(self):
        """What the semi-dense pass reads: (slots, images [K, H, W], poses
        [K, 3, 4], depth ranges [K, 2], neighbours) over the valid keyframes
        with a retained image, in slot order; None for fewer than 4. Each
        keyframe's depth range is the mean +- 2 sigma of its tracked map
        points' depths (StereoSearchConstraints,
        src/ProbabilityMapping.cc:734-747), (0.3, 10) with fewer than 5."""
        tr = self.tracker
        kf_valid = tr.kf_valid_host
        slots = [s for s in tr.kf_slots if s in self._kf_images and kf_valid[s]]
        if len(slots) < 4:
            return None
        imgs = np.stack([self._kf_images[s] for s in slots])
        poses = tr.map.kf_pose.cpu().numpy()[slots]
        kf_pt = tr.kf_pt_host
        pts = tr.map.pt_pos.cpu().numpy()
        ranges = []
        for i, s in enumerate(slots):
            ids = kf_pt[s]
            X = pts[ids[ids >= 0]]
            z = X @ poses[i][:3, :3][2] + poses[i][2, 3]
            z = z[z > 0.05]
            if len(z) < 5:
                ranges.append((0.3, 10.0))
            else:
                mu, sd = float(z.mean()), float(z.std())
                ranges.append((max(mu - 2 * sd, 0.1), mu + 2 * sd))
        return (slots, imgs, poses, np.asarray(ranges, np.float32),
                self._semidense_neighbors(slots))

    def _run_semidense(self):
        from eao_slam_torch.dense.semidense import semidense_reconstruct

        inputs = self.semidense_inputs()
        if inputs is None:
            return None
        slots, imgs, poses, ranges, neighbors = inputs
        self._semidense_slots = slots
        return semidense_reconstruct(self.cfg.camera, imgs, poses, ranges, neighbors,
                                     self.cfg.semidense, device=self.device)

    def _semidense_neighbors(self, slots: list) -> list:
        """Each keyframe's sweep neighbours: its ``covis_n`` most covisible
        peers with a weight of at least 5 (covisN, include/ProbabilityMapping.h:45),
        from one covisibility product copied to the host once; the +-3
        temporal window where fewer than 2 qualify."""
        from eao_slam_torch.runtime.compaction import covisibility

        m = self.tracker.map
        covis = covisibility(m.kf_pt_idx, m.kf_kp_valid, m.kf_valid,
                             m.pt_pos.shape[0]).cpu().numpy()
        idx_of = {s: i for i, s in enumerate(slots)}
        neighbors = []
        for i, s in enumerate(slots):
            w = covis[s]
            order = np.argsort(-w)      # the reference's sort, ties included
            nb = [idx_of[int(t)] for t in order
                  if int(t) in idx_of and int(t) != s and w[t] >= 5][:self.cfg.semidense.covis_n]
            if len(nb) < 2:
                nb = [j for j in range(max(0, i - 3), min(len(slots), i + 4)) if j != i][:6]
            neighbors.append(nb)
        return neighbors

    def _run_lines3d(self):
        """2D segments of every retained keyframe in one batched detector
        call, each keyframe's 3D fit, then the multi-view clustering
        (LineDetector + the Line3D++ offline pass)."""
        from eao_slam_torch.dense.lines3d import cluster_world_segments, fit_3d_segments
        from eao_slam_torch.ops.lines import detect_segments

        res = self._semidense_result
        slots = self._semidense_slots
        cam = self.cfg.camera
        imgs = torch.as_tensor(np.stack([self._kf_images[s] for s in slots]), device=self.device)
        segs2d, sv = detect_segments(imgs)
        poses = self.tracker.map.kf_pose[torch.as_tensor(slots, device=self.device)]
        fits = [fit_3d_segments(cam, segs2d[i], sv[i], res.pixels[i], res.inv_depth[i],
                                res.valid[i], poses[i], height=cam.height, width=cam.width)
                for i in range(len(slots))]
        seg = torch.cat([f.seg for f in fits]).cpu().numpy()
        val = torch.cat([f.valid for f in fits]).cpu().numpy()
        self._lines3d = cluster_world_segments(seg, val, min_views=2, device=self.device)
        return self._lines3d

    def _run_mesh(self):
        from eao_slam_torch.dense.mesh import extract_mesh

        cam = self.cfg.camera
        poses = self.tracker.map.kf_pose.cpu().numpy()[self._semidense_slots]
        self._mesh_tris, _ = extract_mesh(cam, self._semidense_result, poses, cam.height,
                                          cam.width)
        return self._mesh_tris

    def save_semidense_obj(self, path: str) -> int:
        """The semi-dense cloud (``dense.semidense.save_obj``); 0 before the
        dense phase ran."""
        from eao_slam_torch.dense.semidense import save_obj

        if self._semidense_result is None:
            return 0
        return save_obj(path, self._semidense_result)

    def save_lines_obj(self, path: str) -> int:
        """The clustered 3D line segments as .obj lines; 0 when none."""
        from eao_slam_torch.dense.lines3d import save_lines_obj

        if self._lines3d is None or len(self._lines3d) == 0:
            return 0
        return save_lines_obj(path, self._lines3d)

    def save_mesh_obj(self, path: str) -> int:
        """The surface mesh as an .obj triangle soup; 0 when none."""
        from eao_slam_torch.dense.mesh import save_mesh_obj

        if self._mesh_tris is None or len(self._mesh_tris) == 0:
            return 0
        return save_mesh_obj(path, self._mesh_tris)

    def frame_trajectory(self):
        """(timestamps [N], T_cw [N, 3, 4]) of every tracked frame."""
        self.flush()
        return self.tracker.frame_trajectory()

    def keyframe_trajectory(self):
        self.flush()
        return self.tracker.keyframe_trajectory()

