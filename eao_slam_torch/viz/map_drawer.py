"""3D map rendering, headless (MapDrawer, src/MapDrawer.cc).

Renders the map into a virtual pinhole camera with point splatting and
wireframe segments: map points (DrawMapPoints), keyframe frusta and the
covisibility graph (DrawKeyFrames / DrawGraph), the semi-dense cloud
filtered by its depth sigma (DrawSemiDense), and the EAO object landmarks:
cuboid wireframes for box-like classes and wireframe ellipsoids
(quadrics) for the rest, with the class gates of src/MapDrawer.cc:445-475.
The map and the object table may hold tensors on any device; they are
drawn from host copies.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from eao_slam_torch.objects.state import cuboid_corners, yaw_rotation
from eao_slam_torch.viz.frame_drawer import class_color
from eao_slam_torch.viz.raster import blank_canvas, draw_points, draw_segments, to_numpy

# classes drawn as cuboids in the reference viewer (src/MapDrawer.cc:445-475):
# 73 book, 64 mouse, 65 remote, 66 keyboard, 56 chair, 72 tvmonitor
CUBE_CLASSES = frozenset({73, 64, 65, 66, 56, 72})

_FRUSTUM = np.array([  # camera-frame frustum, scaled by `size`
    [0, 0, 0], [1, 0.75, 1.5], [1, -0.75, 1.5], [-1, -0.75, 1.5], [-1, 0.75, 1.5],
], np.float64)
_FRUSTUM_EDGES = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]

_CUBE_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0),
               (4, 5), (5, 6), (6, 7), (7, 4),
               (0, 4), (1, 5), (2, 6), (3, 7)]


@dataclass
class MapRenderOptions:
    """Viewer menu toggles (src/Viewer.cc:69-93) as plain fields."""
    width: int = 960
    height: int = 720
    focal: float = 700.0
    show_points: bool = True            # menuShowPoints
    show_keyframes: bool = True         # menuShowKeyFrames
    show_graph: bool = True             # menuShowGraph
    show_semidense: bool = True         # menuShowSemiDense
    sigma_thresh: float = 0.1           # menuSigmaTH
    show_cubes: bool = True             # menuShowCubeObj
    show_quadrics: bool = True          # menuShowQuadricObj
    class_filter: frozenset = field(default_factory=frozenset)  # empty = all
    frustum_size: float = 0.05
    background: tuple = (255, 255, 255)
    min_covis_weight: int = 15          # graph edge threshold


def look_at(eye: np.ndarray, target: np.ndarray,
            up=(0.0, -1.0, 0.0)) -> np.ndarray:
    """World->camera [3,4] for a camera at eye looking at target (y-down
    convention, matching the SLAM camera frame)."""
    eye = np.asarray(eye, np.float64)
    f = np.asarray(target, np.float64) - eye
    f = f / (np.linalg.norm(f) + 1e-12)
    r = np.cross(f, np.asarray(up, np.float64))
    if np.linalg.norm(r) < 1e-6:
        r = np.cross(f, np.array([1.0, 0.0, 0.0]))
    r = r / np.linalg.norm(r)
    d = np.cross(f, r)
    R = np.stack([r, d, f])            # rows: right, down, forward
    return np.concatenate([R, (-R @ eye)[:, None]], axis=1)


def follow_camera(T_cw: np.ndarray, back: float = 2.0,
                  up_off: float = 0.8) -> np.ndarray:
    """Viewer follow-cam (s_cam follow in Viewer::Run): a virtual camera
    behind/above the current SLAM camera, looking where it looks."""
    T_cw = to_numpy(T_cw).astype(np.float64)
    R, t = T_cw[:3, :3], T_cw[:3, 3]
    C = -R.T @ t                       # camera center in world
    fwd = R.T @ np.array([0.0, 0.0, 1.0])
    up_w = R.T @ np.array([0.0, -1.0, 0.0])
    eye = C - back * fwd + up_off * up_w
    return look_at(eye, C + 1.5 * fwd)


class _View:
    def __init__(self, opt: MapRenderOptions, T_vw: np.ndarray):
        self.opt = opt
        self.T = to_numpy(T_vw).astype(np.float64)
        self.canvas = blank_canvas(opt.height, opt.width, opt.background)

    def project(self, pts: np.ndarray):
        pts = np.atleast_2d(np.asarray(pts, np.float64))
        pc = pts @ self.T[:3, :3].T + self.T[:3, 3]
        z = pc[:, 2]
        ok = z > 1e-3
        zs = np.where(ok, z, 1.0)
        u = self.opt.focal * pc[:, 0] / zs + self.opt.width / 2
        v = self.opt.focal * pc[:, 1] / zs + self.opt.height / 2
        return np.stack([u, v], -1), ok

    def points(self, pts, color, radius=1):
        uv, ok = self.project(pts)
        draw_points(self.canvas, uv[ok], color=color, radius=radius)

    def segments(self, a, b, color):
        ua, oka = self.project(a)
        ub, okb = self.project(b)
        m = oka & okb
        draw_segments(self.canvas, ua[m], ub[m], color=color)

    def wireframe(self, corners: np.ndarray, edges, color):
        """corners [8or5,3] world, edges list of index pairs."""
        e = np.asarray(edges)
        self.segments(corners[e[:, 0]], corners[e[:, 1]], color)


def _ellipsoid_wires(center: np.ndarray, radii: np.ndarray,
                     R: np.ndarray, n: int = 24) -> tuple:
    """Three principal circles of the ellipsoid (GLU quadric stand-in)."""
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    c, s = np.cos(t), np.sin(t)
    zero = np.zeros_like(t)
    rings = [np.stack([c, s, zero], -1), np.stack([c, zero, s], -1),
             np.stack([zero, c, s], -1)]
    a_list, b_list = [], []
    for ring in rings:
        p = (ring * radii) @ R.T + center
        a_list.append(p)
        b_list.append(np.roll(p, -1, axis=0))
    return np.concatenate(a_list), np.concatenate(b_list)


def render_map(map_state=None, T_view=None, opt: MapRenderOptions | None = None,
               objects=None, semidense_pts=None, semidense_sigma=None,
               cur_T_cw=None, covis=None, extra_pts=None,
               lines3d=None) -> np.ndarray:
    """Render one map view to RGB uint8.

    map_state: runtime.map_state.MapState (or None)
    T_view: [3,4] world->view camera (default: follow cur_T_cw or overview)
    objects: objects.state.ObjectTable (EAO landmarks)
    semidense_pts/[N,3] + semidense_sigma/[N]: semi-dense cloud w/ σ filter
    covis: [K,K] covisibility counts for graph edges
    lines3d: [M,2,3] reconstructed 3D line segments
    """
    opt = opt or MapRenderOptions()

    if T_view is None:
        if cur_T_cw is not None:
            T_view = follow_camera(cur_T_cw)
        else:
            T_view = look_at(np.array([0.0, -4.0, -6.0]), np.zeros(3))
    view = _View(opt, T_view)

    if map_state is not None:
        kf_valid = to_numpy(map_state.kf_valid)
        poses = to_numpy(map_state.kf_pose)

        # map points (black, DrawMapPoints)
        if opt.show_points:
            pv = to_numpy(map_state.pt_valid)
            pos = to_numpy(map_state.pt_pos)
            pts = pos[pv]
            view.points(pts, color=(30, 30, 30), radius=1)
            # object-owned points take their object's class color
            oid = to_numpy(map_state.pt_object_id)
            if objects is not None and (oid >= 0).any():
                ocls = to_numpy(objects.cls)
                owned = pv & (oid >= 0)
                for j in np.unique(oid[owned]):
                    cls = int(ocls[j]) if j < len(ocls) else 0
                    view.points(pos[owned & (oid == j)],
                                color=class_color(cls), radius=2)

        # keyframe frusta (blue) + covisibility graph (green)
        if opt.show_keyframes:
            for k in np.nonzero(kf_valid)[0]:
                R, t = poses[k, :3, :3], poses[k, :3, 3]
                C = -R.T @ t
                corners = C + (opt.frustum_size * _FRUSTUM) @ R
                view.wireframe(corners, _FRUSTUM_EDGES, color=(30, 30, 220))
        if opt.show_graph and covis is not None:
            covis = to_numpy(covis)
            ks = np.nonzero(kf_valid)[0]
            centers = {
                int(k): -poses[k, :3, :3].T @ poses[k, :3, 3] for k in ks
            }
            ii, jj = np.nonzero(np.triu(covis, 1) >= opt.min_covis_weight)
            a = np.array([centers[int(i)] for i in ii if kf_valid[i]] or
                         np.zeros((0, 3)))
            b = np.array([centers[int(j)] for j in jj if kf_valid[j]] or
                         np.zeros((0, 3)))
            n = min(len(a), len(b))
            if n:
                view.segments(a[:n], b[:n], color=(0, 180, 0))

    # semi-dense cloud, σ-filtered (DrawSemiDense w/ menuSigmaTH)
    if opt.show_semidense and semidense_pts is not None:
        sp = to_numpy(semidense_pts)
        if semidense_sigma is not None:
            sp = sp[to_numpy(semidense_sigma) < opt.sigma_thresh]
        view.points(sp, color=(90, 90, 90), radius=1)

    # 3D line segments (Line3D++ output)
    if lines3d is not None and len(lines3d):
        l3 = to_numpy(lines3d)
        view.segments(l3[:, 0], l3[:, 1], color=(200, 120, 0))

    # EAO object landmarks
    if objects is not None:
        valid = to_numpy(objects.valid) & ~to_numpy(objects.bad)
        cls = to_numpy(objects.cls)
        corners = to_numpy(cuboid_corners(objects))
        centers = to_numpy(objects.center)
        half = 0.5 * (to_numpy(objects.cub_max) - to_numpy(objects.cub_min))
        Rs = to_numpy(yaw_rotation(objects.yaw))
        for j in np.nonzero(valid)[0]:
            c = int(cls[j])
            if opt.class_filter and c not in opt.class_filter:
                continue
            col = class_color(c)
            if c in CUBE_CLASSES:
                if opt.show_cubes:
                    view.wireframe(corners[j], _CUBE_EDGES, color=col)
            elif opt.show_quadrics:
                a, b = _ellipsoid_wires(centers[j], np.maximum(half[j], 1e-3),
                                        Rs[j])
                view.segments(a, b, color=col)

    # current camera (green frustum)
    if cur_T_cw is not None:
        T = to_numpy(cur_T_cw).astype(np.float64)
        R, t = T[:3, :3], T[:3, 3]
        C = -R.T @ t
        corners = C + (1.4 * opt.frustum_size * _FRUSTUM) @ R
        view.wireframe(corners, _FRUSTUM_EDGES, color=(0, 160, 0))

    return view.canvas
