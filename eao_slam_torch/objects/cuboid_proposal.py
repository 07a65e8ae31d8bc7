"""Single-view cuboid proposals and their scoring (the CubeSLAM layer,
src/detect_3d_cuboid/box_proposal_detail.cpp), as the reference package's
``objects/cuboid_proposal.py`` formulates it.

From one 2D detection box, a ground-aligned camera pose and the frame's 2D
line segments: cuboids standing on the ground plane are proposed for 18
object yaws x 10 top-corner positions (vanishing points from the yaws,
corners as closed-form line intersections) and scored by how well their
projected edges agree with the segments (distance and angle, plus a skew
penalty). The winner's bottom ring is lifted onto the ground. Off by
default, as the reference's bCubeslam (src/Tracking.cc:1211-1238).

Conventions of ``objects/state.py``: ground-aligned world, y the vertical
(gravity, downward) axis, yaw a rotation about y. The two sample grids are
``jnp.linspace`` inside the reference's jitted program, whose last bits
XLA may round differently from program to program; the port pins the bits
of the eager ``jnp.linspace`` (as ``objects/yaw.py`` pins its grid).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from eao_slam_torch.geometry import se3
from eao_slam_torch.geometry.camera import Camera
from eao_slam_torch.objects.state import yaw_rotation

N_YAW = 18          # object-yaw samples over +-90 degrees about the camera yaw
N_POS = 10          # top-corner samples along the box's top edge
ANGLE_W = 0.8       # weight of the angle error against the distance error
SKEW_W = 1.5        # weight of the shape-skew penalty
ANGLE_GATE = float(np.float32(30.0) * np.float32(np.pi / 180))   # line -> VP gate
PI = float(np.float32(np.pi))

# visible edges as corner index pairs (top ring 0-3, bottom ring 4-7): 4 top,
# 2 bottom front, 3 verticals; and the VP each runs to (0: vp1, 1: vp2, 2: vp3)
_EDGES_2D = ((0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (4, 7), (0, 4), (1, 5), (3, 7))


class CuboidProposal(NamedTuple):
    """The best-scoring cuboid per detection box (detect_3d_cuboid.h:22-43)."""
    pos: torch.Tensor         # [B, 3] world-frame centre
    scale: torch.Tensor       # [B, 3] half extents in the object frame
    yaw: torch.Tensor         # [B]
    corners_2d: torch.Tensor  # [B, 8, 2] the winner's projected corners
    error: torch.Tensor       # [B] the winner's normalised error (inf if not ok)
    ok: torch.Tensor          # [B] the proposal is valid


# jnp.linspace(-pi / 2, pi / 2, N_YAW) and jnp.linspace(0.15, 0.85, N_POS), float32 bits
_YAW_OFFSET_BITS = np.array([
    0xbfc90fdb, 0xbfb16858, 0xbf99c0d5, 0xbf821951, 0xbf54e39e, 0xbf259496,
    0xbeec8b22, 0xbe8ded12, 0xbdbd3c20, 0x3dbd3c19, 0x3e8ded12, 0x3eec8b1f,
    0x3f259496, 0x3f54e39c, 0x3f821951, 0x3f99c0d4, 0x3fb16857, 0x3fc90fdb,
], np.uint32)
_TOP_GRID_BITS = np.array([
    0x3e19999a, 0x3e693e94, 0x3e9c71c8, 0x3ec44444, 0x3eec16c2, 0x3f09f49f,
    0x3f1dddde, 0x3f31c71d, 0x3f45b05b, 0x3f59999a,
], np.uint32)
_GRIDS_BY_DEVICE = {}


def _grids(device):
    """(yaw offsets [N_YAW], top-corner fractions [N_POS]) on ``device``,
    copied there once."""
    dev = torch.device(device)
    if dev not in _GRIDS_BY_DEVICE:
        _GRIDS_BY_DEVICE[dev] = tuple(torch.from_numpy(b.view(np.float32).copy()).to(dev)
                                      for b in (_YAW_OFFSET_BITS, _TOP_GRID_BITS))
    return _GRIDS_BY_DEVICE[dev]


def _vanishing_points(cam: Camera, R_cw: torch.Tensor, yaws: torch.Tensor):
    """Homogeneous pixel VPs [S, 3] of the cuboid's length, width and
    vertical axes for each yaw (scale-normalised; a VP at infinity keeps
    w = 0)."""
    R_obj = yaw_rotation(yaws)
    d1 = R_obj[..., :, 0]
    d2 = R_obj[..., :, 2]
    d3 = torch.tensor([0.0, 1.0, 0.0], device=yaws.device).expand_as(d1)
    KR = cam.K(yaws.device) @ R_cw

    def vp(d):
        v = torch.einsum("ab,sb->sa", KR, d)
        return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-12)

    return vp(d1), vp(d2), vp(d3)


def _to_h(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], -1)


def _join(a_h: torch.Tensor, b_h: torch.Tensor) -> torch.Tensor:
    """The line through two homogeneous points."""
    a_h, b_h = torch.broadcast_tensors(a_h, b_h)
    l = torch.linalg.cross(a_h, b_h, dim=-1)
    return l / torch.clamp(torch.linalg.norm(l[..., :2], dim=-1, keepdim=True), min=1e-12)


def _meet(l1: torch.Tensor, l2: torch.Tensor):
    """The intersection of two lines: ([..., 2] pixel point, [...] valid)."""
    l1, l2 = torch.broadcast_tensors(l1, l2)
    p = torch.linalg.cross(l1, l2, dim=-1)
    ok = p[..., 2].abs() > 1e-6
    w = torch.where(ok, p[..., 2], 1.0)
    return p[..., :2] / w[..., None], ok


def _vline(x: torch.Tensor) -> torch.Tensor:
    """The vertical line u = x."""
    return torch.stack([torch.ones_like(x), torch.zeros_like(x), -x], -1)


def _hline(y: torch.Tensor) -> torch.Tensor:
    """The horizontal line v = y."""
    return torch.stack([torch.zeros_like(y), torch.ones_like(y), -y], -1)


def _generate_corners(vp1, vp2, vp3, box, u_top):
    """Corners of the three-face configuration (box_proposal_detail.cpp
    'config 1') for every yaw and top-corner sample: vp* [S, 3], u_top [P].
    Returns (corners [S, P, 8, 2], ok [S, P])."""
    x0, y0, w, h = box[0], box[1], box[2], box[3]
    x1, y1 = x0 + w, y0 + h
    S, P = vp1.shape[0], u_top.shape[0]
    p1 = torch.stack([u_top.expand(S, P), y0.expand(S, P)], -1)
    p1h = _to_h(p1)
    v1, v2, v3 = (v[:, None, :].expand(S, P, 3) for v in (vp1, vp2, vp3))

    # p2 / p4 land on the box edge opposite their VP
    sx = v1[..., 0] - p1[..., 0] * v1[..., 2]
    r1 = torch.where(v1[..., 2].abs() > 1e-6, sx * v1[..., 2] > 0, v1[..., 0] >= 0)
    e2 = torch.where(r1, x0, x1)
    e4 = torch.where(r1, x1, x0)
    p2, ok2 = _meet(_join(v1, p1h), _vline(e2))
    p4, ok4 = _meet(_join(v2, p1h), _vline(e4))
    p3, ok3 = _meet(_join(v1, _to_h(p4)), _join(v2, _to_h(p2)))
    p7, ok7 = _meet(_join(v3, _to_h(p3)), _hline(y1.expand(S, P)))
    p8, ok8 = _meet(_join(v3, _to_h(p4)), _join(v1, _to_h(p7)))
    p6, ok6 = _meet(_join(v3, _to_h(p2)), _join(v2, _to_h(p7)))
    p5, ok5 = _meet(_join(v3, p1h), _join(v1, _to_h(p6)))
    corners = torch.stack([p1, p2, p3, p4, p5, p6, p7, p8], dim=-2)
    ok = ok2 & ok3 & ok4 & ok5 & ok6 & ok7 & ok8
    # every corner inside a slightly expanded box, the top ring above the bottom
    ex = 0.15 * w + 10.0
    ey = 0.15 * h + 10.0
    inside = ((corners[..., 0] >= x0 - ex) & (corners[..., 0] <= x1 + ex)
              & (corners[..., 1] >= y0 - ey) & (corners[..., 1] <= y1 + ey))
    ok = ok & inside.all(-1)
    ok = ok & (corners[..., 4:, 1] >= corners[..., :4, 1] - 1.0).all(-1)
    return corners, ok


def _mod_pi_distance(a: torch.Tensor) -> torch.Tensor:
    """Angle difference folded into [0, pi/2] (lines have no direction)."""
    r = torch.remainder(a, PI)
    return torch.minimum(r, PI - r)


def _edge_errors(corners, lines, line_valid, vps):
    """Mean distance and angle error of the segments against the projected
    edges: corners [S, P, 8, 2], lines [L, 4], vps [S, 3, 3]. Returns
    (dist_err [S, P], angle_err [S, P]), 60 px and the gate where no
    segment is explained."""
    ia = torch.tensor([e[0] for e in _EDGES_2D], device=corners.device)
    ib = torch.tensor([e[1] for e in _EDGES_2D], device=corners.device)
    ea, eb = corners[..., ia, :], corners[..., ib, :]          # [S, P, E, 2]
    mid = 0.5 * (lines[:, :2] + lines[:, 2:])
    ldir = lines[:, 2:] - lines[:, :2]
    lang = torch.atan2(ldir[:, 1], ldir[:, 0])
    ed = eb - ea
    elen = torch.linalg.norm(ed, dim=-1) + 1e-8
    eang = torch.atan2(ed[..., 1], ed[..., 0])

    rel = mid[None, None, None, :, :] - ea[..., None, :]        # [S, P, E, L, 2]
    t = torch.clamp(torch.einsum("...la,...a->...l", rel, ed) / (elen ** 2)[..., None], 0.0, 1.0)
    foot = ea[..., None, :] + t[..., None] * ed[..., None, :]
    dist = torch.linalg.norm(mid[None, None, None] - foot, dim=-1)
    dang = _mod_pi_distance((eang[..., None] - lang[None, None, None, :]).abs())
    aligned = (dang < ANGLE_GATE) & line_valid[None, None, None, :]
    dist = torch.where(aligned, dist, 1e6)
    best = dist.amin(-2)                                        # [S, P, L]
    matched = (best < 1e5) & line_valid[None, None, :]
    n = matched.sum(-1)
    dist_err = torch.where(matched, best, 0.0).sum(-1) / torch.clamp(n, min=1)
    dist_err = torch.where(n > 0, dist_err, 60.0)

    # each segment against the direction to its best-aligned VP
    to_vp = vps[:, None, :, None, :2] - mid[None, None, None, :, :] * vps[:, None, :, None, 2:3]
    vang = torch.atan2(to_vp[..., 1], to_vp[..., 0])
    best_vp = _mod_pi_distance((vang - lang[None, None, None, :]).abs()).amin(2)   # [S, 1, L]
    ang_ok = (best_vp < ANGLE_GATE) & line_valid[None, None, :]
    na = ang_ok.sum(-1)
    angle_err = torch.where(ang_ok, best_vp, 0.0).sum(-1) / torch.clamp(na, min=1)
    angle_err = torch.where(na > 0, angle_err, ANGLE_GATE)
    return dist_err, angle_err.expand_as(dist_err)


def _lift_to_ground(cam: Camera, T_cw: torch.Tensor, corners: torch.Tensor, ground_y: float):
    """The 3D cuboid of the winning corners [8, 2]: the bottom ring's rays
    meet the ground plane y = ground_y, the height comes from top corner 1
    at the depth of bottom corner 5. Returns (pos [3], scale [3], ok)."""
    dev = corners.device
    T_wc = se3.inverse(T_cw)
    R_wc, t_wc = se3.rot(T_wc), se3.trans(T_wc)
    uv1 = torch.cat([corners, torch.ones((8, 1), device=dev)], -1)
    rays_c = torch.einsum("ab,kb->ka", torch.linalg.inv(cam.K(dev)), uv1)
    rays_w = torch.einsum("ab,kb->ka", R_wc, rays_c)
    denom = rays_w[4:, 1]
    okb = denom.abs() > 1e-8
    s = (ground_y - t_wc[1]) / torch.where(okb, denom, 1.0)
    bot = t_wc[None] + s[:, None] * rays_w[4:]
    ok = (okb & (s > 0.1)).all()
    z5 = se3.apply(T_cw, bot[0])[2]
    top1 = se3.apply(T_wc, rays_c[0] * (z5 / torch.clamp(rays_c[0][2], min=1e-8)))
    height = torch.clamp(ground_y - top1[1], min=0.05)
    center_b = bot.mean(0)
    lx = 0.5 * (torch.linalg.norm(bot[1] - bot[0]) + torch.linalg.norm(bot[2] - bot[3]))
    lz = 0.5 * (torch.linalg.norm(bot[3] - bot[0]) + torch.linalg.norm(bot[2] - bot[1]))
    scale = torch.stack([0.5 * lx, 0.5 * height, 0.5 * lz])
    pos = center_b - torch.tensor([0.0, 1.0, 0.0], device=dev) * (0.5 * height)
    ok = ok & torch.isfinite(pos).all() & (scale > 1e-3).all()
    return pos, scale, ok


def detect_cuboid(cam: Camera, T_cw: torch.Tensor, boxes: torch.Tensor, box_valid: torch.Tensor,
                  lines: torch.Tensor, line_valid: torch.Tensor,
                  ground_y: float = 0.0) -> CuboidProposal:
    """detect_3d_cuboid::detect_cuboid for every box [B, 4] (x, y, w, h):
    score = distance error / box width x 100 + 0.8 x angle error / gate x 10
    + 1.5 x skew (the reference's normalized_error weighting)."""
    dev = T_cw.device
    R_cw = se3.rot(T_cw)
    fwd = se3.rot(se3.inverse(T_cw))[:, 2]
    cam_yaw = torch.atan2(fwd[0], fwd[2])
    yaw_offsets, grid = _grids(dev)
    yaws = cam_yaw + yaw_offsets
    vp1, vp2, vp3 = _vanishing_points(cam, R_cw, yaws)
    vps = torch.stack([vp1, vp2, vp3], dim=1)
    ground_y = float(np.float32(ground_y))
    out = []
    for b in range(boxes.shape[0]):
        box = boxes[b]
        corners, ok = _generate_corners(vp1, vp2, vp3, box, box[0] + box[2] * grid)
        dist_err, angle_err = _edge_errors(corners, lines, line_valid, vps)
        l12 = torch.linalg.norm(corners[..., 1, :] - corners[..., 0, :], dim=-1)
        l14 = torch.linalg.norm(corners[..., 3, :] - corners[..., 0, :], dim=-1)
        ratio = torch.maximum(l12, l14) / torch.clamp(torch.minimum(l12, l14), min=1.0)
        skew = torch.clamp(ratio - 3.0, min=0.0)
        err = dist_err / torch.clamp(box[2], min=1.0) * 100.0 \
            + ANGLE_W * angle_err / ANGLE_GATE * 10.0 + SKEW_W * skew
        err = torch.where(ok, err, torch.inf).reshape(-1)
        flat = torch.argmin(err)
        best_err = err[flat]
        bc = corners.reshape(-1, 8, 2)[flat]
        pos, scale, okl = _lift_to_ground(cam, T_cw, bc, ground_y)
        good = box_valid[b] & torch.isfinite(best_err) & okl
        out.append((torch.where(good, pos, 0.0), torch.where(good, scale, 0.0),
                    torch.where(good, yaws[flat // N_POS], 0.0), bc,
                    torch.where(good, best_err, torch.inf), good))
    return CuboidProposal(*(torch.stack(x) for x in zip(*out)))
