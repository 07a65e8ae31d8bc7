"""SO(3) operations on batched float32 tensors.

Conventions: quaternions are (w, x, y, z); rotation matrices act on column
vectors, x_cam = R @ x_world + t.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a (..., 3) vector -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], -1),
            torch.stack([wz, z, -wx], -1),
            torch.stack([-wy, wx, z], -1),
        ],
        -2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def _eye3(like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(shape)


def exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential with series fallbacks near theta = 0."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS))
    W = hat(w)
    return _eye3(w, W.shape) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def log(R: torch.Tensor) -> torch.Tensor:
    """SO(3) logarithm, stable near 0 and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_t)
    sin_t = torch.sin(theta)
    w_generic = vee(R - R.transpose(-1, -2))
    scale = torch.where(theta < 1e-3, 0.5 + theta * theta / 12.0,
                        theta / (2.0 * sin_t + _EPS))
    w_small = scale[..., None] * w_generic
    Rp = R + _eye3(R, R.shape)
    diag = torch.stack([Rp[..., 0, 0], Rp[..., 1, 1], Rp[..., 2, 2]], -1)
    k = torch.argmax(diag, -1)
    cols = torch.gather(Rp, -1, k[..., None, None].expand(*k.shape, 3, 1))[..., 0]
    axis = cols / (torch.linalg.norm(cols, dim=-1, keepdim=True) + _EPS)
    sign = torch.where((axis * w_generic).sum(-1) < 0.0, -1.0, 1.0)
    w_pi = theta[..., None] * axis * sign[..., None]
    near_pi = theta > (math.pi - 1e-3)
    return torch.where(near_pi[..., None], w_pi, w_small)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + _EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of wxyz quaternions."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        -1,
    )


def mat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) wxyz with w >= 0 (largest-pivot selection)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def piv(v):
        q = torch.sqrt(torch.clamp(v, min=1e-12)) * 0.5
        return q, 0.25 / torch.clamp(q, min=_EPS)

    qw0, s0 = piv(1.0 + tr)
    c0 = torch.stack([qw0, (m21 - m12) * s0, (m02 - m20) * s0, (m10 - m01) * s0], -1)
    qx1, s1 = piv(1.0 + m00 - m11 - m22)
    c1 = torch.stack([(m21 - m12) * s1, qx1, (m01 + m10) * s1, (m02 + m20) * s1], -1)
    qy2, s2 = piv(1.0 - m00 + m11 - m22)
    c2 = torch.stack([(m02 - m20) * s2, (m01 + m10) * s2, qy2, (m12 + m21) * s2], -1)
    qz3, s3 = piv(1.0 - m00 - m11 + m22)
    c3 = torch.stack([(m10 - m01) * s3, (m02 + m20) * s3, (m12 + m21) * s3, qz3], -1)
    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], -1)
    idx = torch.argmax(pivots, -1)
    cands = torch.stack([c0, c1, c2, c3], -2)
    q = torch.gather(cands, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    q = q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)
    return q / (torch.linalg.norm(q, dim=-1, keepdim=True) + _EPS)


def rot_y(yaw: torch.Tensor) -> torch.Tensor:
    """Rotation about the Y axis by ``yaw`` (...,) -> (..., 3, 3): the
    cuboid yaw (the reference's ``rotY``)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, s], -1),
                        torch.stack([z, o, z], -1),
                        torch.stack([-s, z, c], -1)], -2)
