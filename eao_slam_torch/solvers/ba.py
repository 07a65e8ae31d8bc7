"""Bundle adjustment: robust LM with Schur-complement reduction.

The problem is fixed-shape arrays: poses [K, 3, 4], points [P, 3] and an
observation table (kf_idx, pt_idx, uv, inv_sigma2, valid) [O]. One LM
iteration assembles Hcc [K, 6, 6], Hpp [P, 3, 3], Wcp [K, P, 6, 3] and the
gradients with ``index_add_`` over the observations, reduces to the dense
[6K, 6K] camera system, solves it and back-substitutes the points.
Fixed cameras are masked to identity rows. All float32, TF32 off.

Sums over observations are accumulated in float64 (GPU atomics add in no
fixed order; in float64 the float32 result does not depend on it), so they
agree with the reference's one-hot matmuls to float32 rounding, not bit
for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eao_slam_torch.device import fp32_solvers
from eao_slam_torch.geometry import se3, so3
from eao_slam_torch.geometry.camera import Camera
from eao_slam_torch.solvers.pose_lm import huber_cost, huber_weight

CHI2_MONO = 5.991


class BAProblem(NamedTuple):
    poses: torch.Tensor       # [K, 3, 4]
    points: torch.Tensor      # [P, 3]
    kf_idx: torch.Tensor      # [O] int
    pt_idx: torch.Tensor      # [O] int
    uv: torch.Tensor          # [O, 2]
    inv_sigma2: torch.Tensor  # [O]
    obs_valid: torch.Tensor   # [O] bool
    cam_fixed: torch.Tensor   # [K] bool
    cam_valid: torch.Tensor   # [K] bool
    pt_valid: torch.Tensor    # [P] bool


class BAResult(NamedTuple):
    poses: torch.Tensor
    points: torch.Tensor
    obs_inlier: torch.Tensor  # [O] bool
    cost: torch.Tensor


def _residuals(cam: Camera, prob: BAProblem, poses, points):
    T = poses[prob.kf_idx.long()]
    Xw = points[prob.pt_idx.long()]
    xc = se3.apply(T, Xw)
    x, y, z = xc[..., 0], xc[..., 1], xc[..., 2]
    z_safe = torch.where(z < 1e-6, torch.full_like(z, 1e-6), z)
    inv_z = 1.0 / z_safe
    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    r = torch.stack([u, v], -1) - prob.uv
    zero = torch.zeros_like(z)
    du = torch.stack([cam.fx * inv_z, zero, -cam.fx * x * inv_z * inv_z], -1)
    dv = torch.stack([zero, cam.fy * inv_z, -cam.fy * y * inv_z * inv_z], -1)
    duv_dxc = torch.stack([du, dv], -2)
    I = torch.eye(3, dtype=r.dtype, device=r.device).expand(r.shape[0], 3, 3)
    Jc = duv_dxc @ torch.cat([I, -so3.hat(xc)], -1)
    Jp = duv_dxc @ se3.rot(T)
    return r, Jc, Jp, z > 1e-6


def _weights(prob: BAProblem, r, depth_ok):
    chi2 = (r * r).sum(-1) * prob.inv_sigma2
    m = (prob.obs_valid & depth_ok & prob.pt_valid[prob.pt_idx.long()]
         & prob.cam_valid[prob.kf_idx.long()])
    w = huber_weight(chi2) * prob.inv_sigma2 * m.to(r.dtype)
    cost = torch.where(m, huber_cost(chi2), torch.zeros_like(chi2)).sum()
    return w, cost


def _cost_only(cam, prob, poses, points):
    r, _, _, depth_ok = _residuals(cam, prob, poses, points)
    return _weights(prob, r, depth_ok)[1]


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) batched 3x3 inverse."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11, A12, A13 = e * i - f * h, c * h - b * i, b * f - c * e
    A21, A22, A23 = f * g - d * i, a * i - c * g, c * d - a * f
    A31, A32, A33 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
    rows = torch.stack([torch.stack([A11, A12, A13], -1),
                        torch.stack([A21, A22, A23], -1),
                        torch.stack([A31, A32, A33], -1)], -2)
    return rows * inv_det[..., None, None]


def _lm_system(cam: Camera, prob: BAProblem, poses, points):
    """Blocks of the normal equations, scattered with index_add_."""
    r, Jc, Jp, depth_ok = _residuals(cam, prob, poses, points)
    w, cost = _weights(prob, r, depth_ok)
    K = prob.poses.shape[0]
    P = prob.points.shape[0]
    O = r.shape[0]
    wJc = Jc * w[:, None, None]
    wJp = Jp * w[:, None, None]
    occ = torch.einsum("oki,okj->oij", wJc, Jc).reshape(O, 36)
    opp = torch.einsum("oki,okj->oij", wJp, Jp).reshape(O, 9)
    ocp = torch.einsum("oki,okj->oij", wJc, Jp).reshape(O, 18)
    obc = torch.einsum("oki,ok->oi", wJc, r)
    obp = torch.einsum("oki,ok->oi", wJp, r)
    kf = prob.kf_idx.long()
    pt = prob.pt_idx.long()

    def seg_sum(n_rows, idx, x):
        # float64 accumulation: the order in which GPU atomics add is not
        # fixed, but at float64 precision the float32 result does not
        # depend on it, so BA runs are reproducible
        out = torch.zeros((n_rows, x.shape[1]), dtype=torch.float64, device=x.device)
        return out.index_add_(0, idx, x.to(torch.float64)).to(x.dtype)

    Hcc = seg_sum(K, kf, occ).reshape(K, 6, 6)
    bc = seg_sum(K, kf, obc)
    Hpp = seg_sum(P, pt, opp).reshape(P, 3, 3)
    bp = seg_sum(P, pt, obp)
    Wcp = seg_sum(K * P, kf * P + pt, ocp).reshape(K, P, 6, 3)
    return Hcc, Hpp, Wcp, bc, bp, cost


def _solve_lm_step(prob: BAProblem, Hcc, Hpp, Wcp, bc, bp, lam):
    """One damped Schur step -> (pose twists [K, 6], point deltas [P, 3])."""
    K = Hcc.shape[0]
    dev, dt = Hcc.device, Hcc.dtype
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    diag_p = torch.clamp(torch.diagonal(Hpp, dim1=1, dim2=2), min=1e-8)
    floor_p = 1e-5 * diag_p.amax(1, keepdim=True) + 1e-8
    Binv = inv3x3(Hpp + (lam * diag_p + floor_p)[:, :, None] * eye3[None])
    diag_c = torch.clamp(torch.diagonal(Hcc, dim1=1, dim2=2), min=1e-8)
    Hcc_d = Hcc + lam * diag_c[:, :, None] * eye6[None]

    WB = torch.einsum("kpij,pjl->kpil", Wcp, Binv)
    S = -torch.einsum("kpil,qpml->kqim", WB, Wcp)
    ar = torch.arange(K, device=dev)
    S[ar, ar] += Hcc_d
    rhs = -(bc - torch.einsum("kpil,pl->ki", WB, bp))

    free_f = ((~prob.cam_fixed) & prob.cam_valid).to(dt)
    S = S * free_f[:, None, None, None] * free_f[None, :, None, None]
    S[ar, ar] += (1.0 - free_f)[:, None, None] * eye6[None]
    rhs = rhs * free_f[:, None]
    Sd = S.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
    dc = torch.linalg.solve_ex(Sd + 1e-8 * torch.eye(6 * K, dtype=dt, device=dev),
                               rhs.reshape(-1))[0].reshape(K, 6)
    dc = dc * free_f[:, None]
    rhs_p = -bp - torch.einsum("kpij,ki->pj", Wcp, dc)
    dp = torch.einsum("pij,pj->pi", Binv, rhs_p)
    return dc, dp * prob.pt_valid[:, None].to(dt)


def bundle_adjust(cam: Camera, prob: BAProblem, iters: int = 10,
                  lam0: float = 1e-4) -> BAResult:
    """Robust LM BA: accept a step only if it lowers the cost and stays
    finite; damping shrinks on accept and grows on reject."""
    fp32_solvers()
    poses, points = prob.poses, prob.points
    lam = torch.tensor(lam0, dtype=poses.dtype, device=poses.device)
    for _ in range(iters):
        Hcc, Hpp, Wcp, bc, bp, cost = _lm_system(cam, prob, poses, points)
        dc, dp = _solve_lm_step(prob, Hcc, Hpp, Wcp, bc, bp, lam)
        dc_norm = torch.linalg.norm(dc, dim=-1, keepdim=True)
        dc = dc * torch.clamp(1.0 / torch.clamp(dc_norm, min=1e-12), max=1.0)
        new_poses = se3.orthonormalize(se3.compose(se3.exp(dc), poses))
        new_points = points + dp
        new_cost = _cost_only(cam, prob, new_poses, new_points)
        finite = (torch.isfinite(new_poses).all() & torch.isfinite(new_points).all()
                  & torch.isfinite(new_cost))
        accept = (new_cost < cost) & finite
        poses = torch.where(accept, new_poses, poses)
        points = torch.where(accept, new_points, points)
        lam = torch.clamp(torch.where(accept, lam * 0.4, lam * 5.0), 1e-8, 1e4)
    r, _, _, depth_ok = _residuals(cam, prob, poses, points)
    chi2 = (r * r).sum(-1) * prob.inv_sigma2
    inlier = prob.obs_valid & depth_ok & (chi2 < CHI2_MONO)
    return BAResult(poses=poses, points=points, obs_inlier=inlier,
                    cost=_cost_only(cam, prob, poses, points))


def local_ba(cam: Camera, prob: BAProblem) -> BAResult:
    """LocalBundleAdjustment schedule: 5 iterations, drop chi2 > 5.991
    observations, 10 more."""
    res1 = bundle_adjust(cam, prob, iters=5)
    prob2 = prob._replace(poses=res1.poses, points=res1.points,
                          obs_valid=prob.obs_valid & res1.obs_inlier)
    return bundle_adjust(cam, prob2, iters=10)
