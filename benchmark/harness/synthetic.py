"""The benchmark's frozen copy of the synthetic room, trajectories, renderer
and detector boxes (numpy only).

Copied from the port's ``io/synthetic.py`` so that the yardstick stays fixed
while the port's own copy may change: the same seeds give byte-identical
scenes, poses, images and boxes. The depth cloud and the feature-level
simulator are left out; the benchmark renders images.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


# ---------------------------------------------------------------------------
# scene definition
# ---------------------------------------------------------------------------

class Quad(NamedTuple):
    origin: np.ndarray   # [3]
    eu: np.ndarray       # [3] edge u
    ev: np.ndarray       # [3] edge v
    texture: np.ndarray  # [T, T] float32 in [0, 255]


class Scene(NamedTuple):
    quads: list                   # list[Quad]
    obj_centers: np.ndarray       # [J, 3]
    obj_sizes: np.ndarray         # [J, 3] full extents
    obj_classes: np.ndarray       # [J] int
    landmarks: np.ndarray         # [M, 3] feature-level 3D points
    landmark_obj: np.ndarray      # [M] object id or -1 (background)
    descriptors: np.ndarray       # [M, 32] uint8 per-landmark ORB-like descriptor


def _smooth_texture(rng: np.random.Generator, size: int = 512, octaves: int = 4) -> np.ndarray:
    """Multi-octave value noise — high-contrast, corner-rich texture."""
    tex = np.zeros((size, size), np.float32)
    for o in range(octaves):
        s = 8 << o
        coarse = rng.uniform(0, 1, (s, s)).astype(np.float32)
        # bilinear upsample to full size
        idx = np.linspace(0, s - 1, size)
        xi = np.clip(idx.astype(int), 0, s - 2)
        fx = (idx - xi).astype(np.float32)
        row = coarse[xi][:, xi] * (1 - fx)[None, :] + coarse[xi][:, xi + 1] * fx[None, :]
        row2 = coarse[xi + 1][:, xi] * (1 - fx)[None, :] + coarse[xi + 1][:, xi + 1] * fx[None, :]
        tex += (row * (1 - fx)[:, None] + row2 * fx[:, None]) / (o + 1)
    # sprinkle high-frequency speckle so FAST has corners everywhere
    tex += rng.uniform(-0.15, 0.15, (size, size)).astype(np.float32)
    tex -= tex.min()
    tex /= tex.max() + 1e-9
    return (tex * 235.0 + 10.0).astype(np.float32)


# per-face brightness multipliers for line-detection fixtures: real objects
# present strong intensity steps across their silhouette/face edges (what
# EDLines detects in the reference's Frame ctor, src/Frame.cc:324-335);
# flat value-noise faces render cuboids whose edges no line detector can
# see. Shaded faces also weaken/perturb the FAST corners on and around the
# object (measured +16 cm bench ATE on the 60° arc), so shading is an
# explicit OPT-IN for the line/yaw test scenes — the tracking/throughput
# benchmark keeps uniform faces.
FACE_SHADE_LINES = (0.85, 0.45, 1.0, 0.60)


def _cuboid_quads(rng, center, size, tex_size=256, face_shade=None):
    cx, cy, cz = center
    sx, sy, sz = np.asarray(size) / 2.0
    quads = []
    # front (-z), top (-y), right (+x) — the faces typically visible from
    # the orbit trajectory; others add no test value.
    faces = [
        ([cx - sx, cy - sy, cz - sz], [2 * sx, 0, 0], [0, 2 * sy, 0]),   # front
        ([cx - sx, cy - sy, cz - sz], [2 * sx, 0, 0], [0, 0, 2 * sz]),   # top (y-)
        ([cx + sx, cy - sy, cz - sz], [0, 2 * sy, 0], [0, 0, 2 * sz]),   # right
        ([cx - sx, cy - sy, cz - sz], [0, 2 * sy, 0], [0, 0, 2 * sz]),   # left
    ]
    shade = face_shade if face_shade is not None else (1.0, 1.0, 1.0, 1.0)
    for (o, eu, ev), s in zip(faces, shade):
        quads.append(
            Quad(np.asarray(o, np.float64), np.asarray(eu, np.float64),
                 np.asarray(ev, np.float64),
                 _smooth_texture(rng, tex_size) * s))
    return quads


def make_room_scene(
    seed: int = 0,
    n_landmarks: int = 2000,
    n_objects: int = 3,
    obj_size_range: tuple = (0.4, 0.9),
    obj_z_range: tuple = (3.2, 4.8),
    face_shade: Optional[tuple] = None,
    closed_room: bool = False,
) -> Scene:
    """A 6x4x6 m room (y down, camera starts near origin looking at +z) with
    textured walls, floor, and a few cuboid 'objects' standing in it.
    closed_room adds the front wall (z=0) so 360-degree orbit trajectories
    (the port's make_orbit_trajectory) always face texture; the default
    keeps the open room."""
    rng = np.random.default_rng(seed)
    quads = []
    # back wall at z=6, x in [-3,3], y in [-2,2]
    quads.append(Quad(np.array([-3.0, -2.0, 6.0]), np.array([6.0, 0, 0]),
                      np.array([0, 4.0, 0]), _smooth_texture(rng, 1024)))
    # floor at y=2
    quads.append(Quad(np.array([-3.0, 2.0, 0.0]), np.array([6.0, 0, 0]),
                      np.array([0, 0, 6.0]), _smooth_texture(rng, 1024)))
    # left wall x=-3
    quads.append(Quad(np.array([-3.0, -2.0, 0.0]), np.array([0, 4.0, 0]),
                      np.array([0, 0, 6.0]), _smooth_texture(rng, 1024)))
    # right wall x=3
    quads.append(Quad(np.array([3.0, -2.0, 0.0]), np.array([0, 4.0, 0]),
                      np.array([0, 0, 6.0]), _smooth_texture(rng, 1024)))
    if closed_room:
        # front wall z=0 (behind the default camera start)
        quads.append(Quad(np.array([-3.0, -2.0, 0.0]), np.array([6.0, 0, 0]),
                          np.array([0, 4.0, 0]), _smooth_texture(rng, 1024)))

    # objects: cuboids at table height (lifted off the floor so their
    # boxes project inside the image instead of hugging the bottom edge)
    classes = np.array([56, 62, 73, 66, 41][:n_objects], np.int32)  # chair, tv, book, keyboard...
    centers, sizes = [], []
    xs = np.linspace(-1.6, 1.6, max(n_objects, 2))
    for j in range(n_objects):
        size = rng.uniform(*obj_size_range, 3)
        lift = rng.uniform(0.5, 1.1)
        c = np.array([xs[j], 2.0 - size[1] / 2.0 - lift,
                      rng.uniform(*obj_z_range)])
        centers.append(c)
        sizes.append(size)
        quads.extend(_cuboid_quads(rng, c, size, face_shade=face_shade))
    centers = np.asarray(centers).reshape(-1, 3)
    sizes = np.asarray(sizes).reshape(-1, 3)

    # feature-level landmarks: most on walls, clusters inside each object
    # (closed rooms sample the front wall too, so the feature-level sim
    # covers every orbit heading)
    lm, lm_obj = [], []
    n_bg = max(n_landmarks - 60 * n_objects, 16)
    wall_pick = rng.integers(0, 5 if closed_room else 4, n_bg)
    u = rng.uniform(0.02, 0.98, n_bg)
    v = rng.uniform(0.02, 0.98, n_bg)
    for i in range(n_bg):
        q = quads[wall_pick[i]]
        lm.append(q.origin + u[i] * q.eu + v[i] * q.ev)
        lm_obj.append(-1)
    for j in range(n_objects):
        pts = centers[j] + rng.uniform(-0.5, 0.5, (60, 3)) * sizes[j][None, :] * 0.95
        lm.extend(pts)
        lm_obj.extend([j] * 60)
    lm = np.asarray(lm, np.float64)
    lm_obj = np.asarray(lm_obj, np.int32)
    desc = rng.integers(0, 256, (len(lm), 32), dtype=np.uint8)
    return Scene(quads, centers, sizes, classes, lm, lm_obj, desc)


# ---------------------------------------------------------------------------
# trajectory
# ---------------------------------------------------------------------------

def look_at(eye: np.ndarray, target: np.ndarray, up=(0.0, -1.0, 0.0)) -> np.ndarray:
    """Camera-from-world pose with +z forward, y down (OpenCV convention)."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.asarray(up, np.float64)
    right = np.cross(-up, fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R_wc = np.stack([right, down, fwd], axis=1)  # world-from-camera columns
    R_cw = R_wc.T
    t_cw = -R_cw @ eye
    return np.concatenate([R_cw, t_cw[:, None]], axis=1)


def make_sweep_trajectory(
    n_frames: int,
    radius: float = 2.0,
    target=(0.0, 0.0, 4.5),
    sweep_deg: float = 60.0,
    bob: float = 0.2,
    bob_cycles: float = 3.0,
    depth: float = 0.3,
    fps: float = 30.0,
    speed_wave: float = 0.0,
    speed_cycles: float = 0.0,
):
    """A hand-held sweep along the room, always fixating ``target``: the
    port's ``make_arc_trajectory`` (the camera on an arc of ``radius`` about
    the origin at the angle a, with ``depth`` x radius x (1 - cos a) of
    forward travel) with a played once from -``sweep_deg`` to
    +``sweep_deg``, so that no view repeats and the map grows all along.
    The camera bobs vertically by ``bob`` over ``bob_cycles`` periods, and
    ``speed_wave`` s and ``speed_cycles`` m make its speed vary as
    1 + s cos(2 pi m u) over the run (u from 0 to 1), so that the direction
    and the speed of its motion keep changing and no frame's motion equals
    the frame before's. Returns (timestamps [N], T_cw [N, 3, 4])."""
    target = np.asarray(target, np.float64)
    ts = np.arange(n_frames, dtype=np.float64) / fps
    u = np.linspace(0.0, 1.0, n_frames)
    if speed_cycles:
        u = u + speed_wave * np.sin(2.0 * np.pi * speed_cycles * u) / (2.0 * np.pi * speed_cycles)
    ang = np.deg2rad(sweep_deg) * (2.0 * u - 1.0)
    poses = np.zeros((n_frames, 3, 4))
    for i in range(n_frames):
        eye = np.array([radius * np.sin(ang[i]),
                        bob * np.sin(2.0 * np.pi * bob_cycles * u[i]),
                        depth * radius * (1.0 - np.cos(ang[i]))])
        poses[i] = look_at(eye, target)
    return ts, poses


# ---------------------------------------------------------------------------
# image rendering (ray casting against quads)
# ---------------------------------------------------------------------------

def _shade_quad(q, eye, dirs, best_t, img) -> None:
    """Intersect the rays ``dirs`` [h, w, 3] from ``eye`` with quad ``q``
    and shade, in place, the pixels of ``img`` whose nearest hit so far
    (``best_t``) it is."""
    n = np.cross(q.eu, q.ev)
    denom = dirs @ n
    d = (q.origin - eye) @ n
    tt = np.where(np.abs(denom) > 1e-12, d / np.where(denom == 0, 1e-12, denom), np.inf)
    hit = eye[None, None, :] + tt[..., None] * dirs
    rel = hit - q.origin
    e_uu = q.eu @ q.eu
    e_vv = q.ev @ q.ev
    e_uv = q.eu @ q.ev
    ru = rel @ q.eu
    rv = rel @ q.ev
    det = e_uu * e_vv - e_uv * e_uv
    a = (ru * e_vv - rv * e_uv) / det
    b = (rv * e_uu - ru * e_uv) / det
    ok = (tt > 1e-6) & (tt < best_t) & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)
    if not ok.any():
        return
    # rays parallel to the quad produce inf/nan barycentrics; they are
    # ok-masked out of the shading but must not poison the gather below
    a = np.where(np.isfinite(a), a, 0.0)
    b = np.where(np.isfinite(b), b, 0.0)
    T = q.texture.shape[0]
    ta = np.clip(a * (T - 1), 0, T - 1.001)
    tb = np.clip(b * (T - 1), 0, T - 1.001)
    ia, ib = ta.astype(int), tb.astype(int)
    fa, fb = ta - ia, tb - ib
    tex = q.texture
    val = (
        tex[ib, ia] * (1 - fa) * (1 - fb)
        + tex[ib, ia + 1] * fa * (1 - fb)
        + tex[ib + 1, ia] * (1 - fa) * fb
        + tex[ib + 1, ia + 1] * fa * fb
    )
    img[ok] = val[ok]
    best_t[ok] = tt[ok]


def render_image(scene: Scene, cam, T_cw: np.ndarray, supersample: int = 1,
                 return_depth: bool = False):
    """Render a grayscale uint8 image by intersecting pixel rays with every
    quad and shading from its texture (bilinear). Pure numpy; used offline to
    build test sequences, not on the hot path. With return_depth, also
    returns the z-depth map (camera-frame z, inf where no hit)."""
    H = int(cam.height) * supersample
    W = int(cam.width) * supersample
    R_cw = T_cw[:3, :3]
    t_cw = T_cw[:3, 3]
    R_wc = R_cw.T
    eye = -R_wc @ t_cw

    u = (np.arange(W) + 0.5) / supersample - 0.5
    v = (np.arange(H) + 0.5) / supersample - 0.5
    uu, vv = np.meshgrid(u, v)
    dirs_cam = np.stack(
        [(uu - cam.cx) / cam.fx, (vv - cam.cy) / cam.fy, np.ones_like(uu)], axis=-1
    )
    dirs = dirs_cam @ R_wc.T  # world-frame ray directions, [H, W, 3]

    best_t = np.full((H, W), np.inf)
    img = np.zeros((H, W), np.float64)
    for q in scene.quads:
        # only the rays inside the quad's projected bounding box can hit it
        # (all four corners in front of the camera; else every ray is tried)
        corners = q.origin + np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.float64) @ np.stack([q.eu, q.ev])
        pc = corners @ R_cw.T + t_cw
        rows, cols = slice(0, H), slice(0, W)
        if (pc[:, 2] > 1e-6).all():
            px = (pc[:, 0] / pc[:, 2] * cam.fx + cam.cx + 0.5) * supersample - 0.5
            py = (pc[:, 1] / pc[:, 2] * cam.fy + cam.cy + 0.5) * supersample - 0.5
            c0, c1 = max(int(np.floor(px.min())) - 1, 0), min(int(np.ceil(px.max())) + 2, W)
            r0, r1 = max(int(np.floor(py.min())) - 1, 0), min(int(np.ceil(py.max())) + 2, H)
            if c0 >= c1 or r0 >= r1:
                continue
            rows, cols = slice(r0, r1), slice(c0, c1)
        _shade_quad(q, eye, dirs[rows, cols], best_t[rows, cols], img[rows, cols])
    if supersample > 1:
        img = img.reshape(cam.height, supersample, cam.width, supersample).mean((1, 3))
    out = np.clip(img, 0, 255).astype(np.uint8)
    if return_depth:
        # ray dirs have unit z in the camera frame, so the ray parameter t
        # IS the camera-frame z-depth
        z = best_t
        if supersample > 1:
            z = z.reshape(cam.height, supersample, cam.width, supersample).mean((1, 3))
        return out, z
    return out


def project_boxes(scene: Scene, cam, T_cw: np.ndarray, max_boxes: int, pad: float = 4.0):
    """Synthetic offline-detector boxes: each cuboid's projected corners'
    clipped bounding rect, padded to ``max_boxes`` slots. Returns (boxes
    [B, 4] x y w h, class [B], score [B], valid [B]), the reference's text
    contract order (class x y w h score)."""
    J = len(scene.obj_centers)
    boxes = np.zeros((max_boxes, 4), np.float32)
    cls = np.full((max_boxes,), -1, np.int32)
    score = np.zeros((max_boxes,), np.float32)
    valid = np.zeros((max_boxes,), bool)
    R, t = T_cw[:3, :3], T_cw[:3, 3]
    n = 0
    for j in range(J):
        c, s = scene.obj_centers[j], scene.obj_sizes[j] / 2
        corners = c[None, :] + np.array(
            [[sx, sy, sz] for sx in (-s[0], s[0]) for sy in (-s[1], s[1]) for sz in (-s[2], s[2])]
        )
        pc = corners @ R.T + t
        if (pc[:, 2] <= 0.1).any():
            continue
        uvs = np.stack(
            [cam.fx * pc[:, 0] / pc[:, 2] + cam.cx, cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1
        )
        x0, y0 = uvs.min(0) - pad
        x1, y1 = uvs.max(0) + pad
        x0, y0 = max(x0, 0), max(y0, 0)
        x1, y1 = min(x1, cam.width - 1), min(y1, cam.height - 1)
        if x1 - x0 < 10 or y1 - y0 < 10 or n >= max_boxes:
            continue
        boxes[n] = (x0, y0, x1 - x0, y1 - y0)
        cls[n] = scene.obj_classes[j]
        score[n] = 0.95
        valid[n] = True
        n += 1
    return boxes, cls, score, valid

