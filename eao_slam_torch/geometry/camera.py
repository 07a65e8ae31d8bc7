"""Pinhole camera model with radial-tangential distortion (batched torch)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Camera(NamedTuple):
    """Static intrinsics as Python floats (hashable, device-free)."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 640
    height: int = 480
    fps: float = 30.0

    def K(self, device=None) -> torch.Tensor:
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32, device=device,
        )

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))


# TUM freiburg3 intrinsics (TUM3.yaml, zero distortion).
TUM3 = Camera(fx=535.4, fy=539.2, cx=320.1, cy=247.6, width=640, height=480, fps=30.0)
# TUM freiburg1 / freiburg2 (TUM1.yaml, TUM2.yaml, radial-tangential distortion).
TUM1 = Camera(517.306408, 516.469215, 318.643040, 255.313989,
              0.262383, -0.953104, -0.005358, 0.002628, 1.163314, 640, 480, 30.0)
TUM2 = Camera(520.908620, 521.007327, 325.141442, 249.701764,
              0.231222, -0.784899, -0.003257, -0.000105, 0.917205, 640, 480, 30.0)
# KITTI odometry rectified intrinsics (KITTI00-02.yaml, KITTI03.yaml, KITTI04-12.yaml).
KITTI00_02 = Camera(718.856, 718.856, 607.1928, 185.2157,
                    width=1241, height=376, fps=10.0)
KITTI03 = Camera(721.5377, 721.5377, 609.5593, 172.854,
                 width=1242, height=375, fps=10.0)
KITTI04_12 = Camera(707.0912, 707.0912, 601.8873, 183.1104,
                    width=1226, height=370, fps=10.0)
# EuRoC MAV cam0 (EuRoC.yaml, radial-tangential distortion).
EUROC = Camera(458.654, 457.296, 367.215, 248.375,
               -0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0,
               752, 480, 20.0)


def project(cam: Camera, xc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) -> undistorted pixels (..., 2)."""
    z = xc[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = cam.fx * xc[..., 0] * inv_z + cam.cx
    v = cam.fy * xc[..., 1] * inv_z + cam.cy
    return torch.stack([u, v], -1)


def backproject(cam: Camera, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Undistorted pixels (..., 2) at depths (...,) -> camera-frame points (..., 3)."""
    x = _ieee_div(uv[..., 0] - cam.cx, cam.fx)
    y = _ieee_div(uv[..., 1] - cam.cy, cam.fy)
    return torch.stack([x * depth, y * depth, depth], -1)


def distort_normalized(cam: Camera, xn: torch.Tensor) -> torch.Tensor:
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    dx = 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    dy = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([x * radial + dx, y * radial + dy], -1)


def _ieee_div(x: torch.Tensor, v: float) -> torch.Tensor:
    """x / v, correctly rounded on every device: CUDA divides by a host
    scalar as a product with its reciprocal, an ulp away from the quotient
    that the CPU (and the reference) computes."""
    return x / torch.full_like(x, v)


def undistort_points(cam: Camera, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Fixed-point inversion of the distortion (cv::undistortPoints)."""
    if not cam.has_distortion:
        return uv
    xd = torch.stack([_ieee_div(uv[..., 0] - cam.cx, cam.fx),
                      _ieee_div(uv[..., 1] - cam.cy, cam.fy)], -1)
    xn = xd
    for _ in range(iters):
        xn = xd - (distort_normalized(cam, xn) - xn)
    return torch.stack([xn[..., 0] * cam.fx + cam.cx, xn[..., 1] * cam.fy + cam.cy], -1)


def in_image(cam: Camera, uv: torch.Tensor, border: float = 0.0) -> torch.Tensor:
    return (
        (uv[..., 0] >= border)
        & (uv[..., 0] < cam.width - border)
        & (uv[..., 1] >= border)
        & (uv[..., 1] < cam.height - border)
    )
