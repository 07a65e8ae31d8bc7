"""SE(3) rigid transforms packed as (..., 3, 4) float32 tensors.

A pose is camera-from-world (ORB-SLAM2's Tcw) unless stated otherwise.
Twists are (rho, omega): translation first, rotation last.
"""

from __future__ import annotations

import torch

from eao_slam_torch.geometry import so3


def make(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([R, t[..., None]], -1)


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(3, 4, dtype=dtype, device=device)


def rot(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def trans(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def apply(T: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Transform points (..., 3) by poses (..., 3, 4) (broadcasting)."""
    return (rot(T) @ x[..., None])[..., 0] + trans(T)


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """result(x) = A(B(x))."""
    R = rot(A) @ rot(B)
    t = (rot(A) @ trans(B)[..., None])[..., 0] + trans(A)
    return make(R, t)


def inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = rot(T).transpose(-1, -2)
    return make(Rt, -(Rt @ trans(T)[..., None])[..., 0])


def exp(xi: torch.Tensor) -> torch.Tensor:
    rho, omega = xi[..., :3], xi[..., 3:]
    R = so3.exp(omega)
    theta2 = (omega * omega).sum(-1)
    theta = torch.sqrt(theta2 + 1e-16)
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta2 + 1e-16))
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / (theta2 + 1e-16))
    W = so3.hat(omega)
    I = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(R.shape)
    V = I + B[..., None, None] * W + C[..., None, None] * (W @ W)
    return make(R, (V @ rho[..., None])[..., 0])


def log(T: torch.Tensor) -> torch.Tensor:
    omega = so3.log(rot(T))
    theta2 = (omega * omega).sum(-1)
    theta = torch.sqrt(theta2 + 1e-16)
    small = theta2 < 1e-8
    W = so3.hat(omega)
    I = torch.eye(3, dtype=T.dtype, device=T.device).expand(W.shape)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta2 + 1e-16))
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                       (1.0 - A / (2.0 * B + 1e-16)) / (theta2 + 1e-16))
    Vinv = I - 0.5 * W + coef[..., None, None] * (W @ W)
    return torch.cat([(Vinv @ trans(T)[..., None])[..., 0], omega], -1)


def orthonormalize(T: torch.Tensor) -> torch.Tensor:
    """Two Newton steps of the polar decomposition, R <- R (3I - R^T R) / 2:
    keeps LM pose updates on SO(3) (a shrunken R would be a spurious zoom)."""
    R = rot(T)
    I3 = torch.eye(3, dtype=T.dtype, device=T.device).expand(R.shape)
    for _ in range(2):
        R = 0.5 * R @ (3.0 * I3 - R.transpose(-1, -2) @ R)
    return make(R, trans(T))


def orthonormalize_svd(T: torch.Tensor) -> torch.Tensor:
    """The closest rotation by SVD, sign-corrected to det +1: for inputs
    that may lie far from SO(3) (averaged rotations), where the Newton
    iteration of ``orthonormalize`` need not converge."""
    U, _, Vt = torch.linalg.svd(rot(T))
    det = torch.linalg.det(U @ Vt)
    one = torch.ones_like(det)
    D = torch.stack([one, one, det], -1)
    return make(U @ (D[..., :, None] * Vt), trans(T))


def to_quat_trans(T: torch.Tensor):
    """-> ((..., 4) wxyz quaternion, (..., 3) translation), the TUM export's order."""
    return so3.mat_to_quat(rot(T)), trans(T)


def from_quat_trans(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """wxyz quaternions (..., 4) and translations (..., 3) -> poses (..., 3, 4)."""
    return make(so3.quat_to_mat(q), t)
