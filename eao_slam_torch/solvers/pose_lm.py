"""Motion-only pose optimization: robust Levenberg-Marquardt on SE(3).

The reference schedule of Optimizer::PoseOptimization: rounds of LM
iterations with a chi2 = 5.991 outlier re-classification between rounds,
Huber IRLS weights, analytic Jacobians and a 6x6 normal system. Every step
stays on the device (no host round trip per iteration).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eao_slam_torch.geometry import se3, so3
from eao_slam_torch.geometry.camera import Camera

CHI2_MONO = 5.991
HUBER_DELTA = 2.4476  # sqrt(5.991)


def reproj_residual_jac(cam: Camera, T: torch.Tensor, Xw: torch.Tensor, uv: torch.Tensor):
    """Residuals r [N, 2], Jacobians J [N, 2, 6] wrt a left twist (rho,
    omega), and depth_ok [N]. T may be [3, 4] or batched [N, 3, 4]."""
    xc = se3.apply(T, Xw)
    x, y, z = xc[..., 0], xc[..., 1], xc[..., 2]
    z_safe = torch.where(z < 1e-6, torch.full_like(z, 1e-6), z)
    inv_z = 1.0 / z_safe
    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    r = torch.stack([u, v], -1) - uv
    zero = torch.zeros_like(z)
    du = torch.stack([cam.fx * inv_z, zero, -cam.fx * x * inv_z * inv_z], -1)
    dv = torch.stack([zero, cam.fy * inv_z, -cam.fy * y * inv_z * inv_z], -1)
    duv_dxc = torch.stack([du, dv], -2)
    I = torch.eye(3, dtype=Xw.dtype, device=Xw.device).expand(*xc.shape[:-1], 3, 3)
    dxc = torch.cat([I, -so3.hat(xc)], -1)
    return r, duv_dxc @ dxc, z > 1e-6


def huber_weight(chi2: torch.Tensor, delta: float = HUBER_DELTA) -> torch.Tensor:
    chi = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(chi <= delta, torch.ones_like(chi), delta / chi)


def huber_cost(chi2: torch.Tensor, delta: float = HUBER_DELTA) -> torch.Tensor:
    chi = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(chi <= delta, chi2, 2.0 * delta * chi - delta * delta)


class PoseOptResult(NamedTuple):
    T: torch.Tensor        # [3, 4]
    inliers: torch.Tensor  # [N] bool
    n_inliers: torch.Tensor
    chi2: torch.Tensor     # [N]


def optimize_pose(cam: Camera, T0, Xw, uv, inv_sigma2, valid,
                  schedule: tuple = (4, 3, 2, 1)) -> PoseOptResult:
    """Robust LM: one round per schedule entry, best-cost pose wins each
    round, chi2 re-classification against all matches between rounds."""
    dev = T0.device
    eye6 = torch.eye(6, dtype=T0.dtype, device=dev)

    def chi2_of(T):
        r, _, depth_ok = reproj_residual_jac(cam, T, Xw, uv)
        c2 = (r * r).sum(-1) * inv_sigma2
        return torch.where(depth_ok, c2, torch.full_like(c2, 1e9))

    def cost_of(T, active):
        r, _, depth_ok = reproj_residual_jac(cam, T, Xw, uv)
        c2 = (r * r).sum(-1) * inv_sigma2
        return torch.where(active & depth_ok, huber_cost(c2), torch.zeros_like(c2)).sum()

    def lm_round(T, active, iters):
        lam = torch.tensor(1e-3, dtype=T.dtype, device=dev)
        T_best = T
        cost_best = torch.tensor(float("inf"), dtype=T.dtype, device=dev)
        for _ in range(iters):
            r, J, depth_ok = reproj_residual_jac(cam, T, Xw, uv)
            m = active & depth_ok
            c2 = (r * r).sum(-1) * inv_sigma2
            w = huber_weight(c2) * inv_sigma2 * m.to(r.dtype)
            H = torch.einsum("nki,n,nkj->ij", J, w, J)
            b = torch.einsum("nki,n,nk->i", J, w, r)
            cost = torch.where(m, huber_cost(c2), torch.zeros_like(c2)).sum()
            better = cost < cost_best
            T_best = torch.where(better, T, T_best)
            cost_best = torch.minimum(cost, cost_best)
            lam = torch.clamp(torch.where(better, lam * 0.5, lam * 4.0), 1e-6, 1e3)
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye6
            # solve_ex: no singularity check, so no device->host sync
            delta = -torch.linalg.solve_ex(Hd, b)[0]
            dn = torch.linalg.norm(delta)
            delta = delta * torch.clamp(1.0 / torch.clamp(dn, min=1e-12), max=1.0)
            T = se3.orthonormalize(se3.compose(se3.exp(delta), T))
        return torch.where(cost_of(T, active) < cost_best, T, T_best)

    T = T0
    active = valid
    for iters in schedule:
        T = lm_round(T, active, iters)
        active = valid & (chi2_of(T) < CHI2_MONO)
    c2 = chi2_of(T)
    inliers = valid & (c2 < CHI2_MONO)
    return PoseOptResult(T=T, inliers=inliers, n_inliers=inliers.sum(), chi2=c2)
