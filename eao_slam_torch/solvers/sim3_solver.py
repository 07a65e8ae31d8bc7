"""Sim(3) estimation between two keyframes: Horn + RANSAC + LM refinement.

The reference package's ``solvers/sim3_solver.py`` on tensors: Horn's
closed-form absolute orientation inside a batched RANSAC with mutual
reprojection checks, then an LM over one Sim3 with bidirectional
reprojection residuals whose Jacobian comes from autodiff of the
retraction (``sim3.row_jacobians``; ``jax.jacfwd`` there).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from eao_slam_torch.device import fp32_solvers
from eao_slam_torch.geometry import sim3
from eao_slam_torch.geometry.camera import Camera, project
from eao_slam_torch.solvers.init2view import sample_hypotheses

CHI2_SIM3 = 9.210   # 2-dof 99 %


def horn_sim3(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted closed-form similarity y ~ s R x + t. x, y [..., N, 3];
    w [..., N]. Returns Sim3 (..., 8)."""
    wn = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    mx = torch.einsum("...n,...ni->...i", wn, x)
    my = torch.einsum("...n,...ni->...i", wn, y)
    xc = x - mx[..., None, :]
    yc = y - my[..., None, :]
    cov = torch.einsum("...n,...ni,...nj->...ij", wn, yc, xc)
    U, D, Vt = torch.linalg.svd(cov)
    det = torch.linalg.det(U @ Vt)
    S = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    R = U @ (S[..., :, None] * Vt)
    var_x = torch.einsum("...n,...ni,...ni->...", wn, xc, xc)
    s = (D * S).sum(-1) / torch.clamp(var_x, min=1e-12)
    t = my - s[..., None] * (R @ mx[..., None])[..., 0]
    return sim3.make(R, t, torch.clamp(s, min=1e-6))


class Sim3Result(NamedTuple):
    S12: torch.Tensor       # [8] Sim3 mapping camera-2 coords -> camera-1 coords
    inliers: torch.Tensor   # [N] bool
    n_inliers: torch.Tensor
    success: torch.Tensor


def _mutual_inliers(cam, S12, xc1, xc2, valid, sigma2_1, sigma2_2):
    """Mutual reprojection gate (Sim3Solver::CheckInliers). S12 may carry
    leading batch axes."""
    S = S12[..., None, :]
    proj1 = project(cam, sim3.apply(S, xc2))
    proj2 = project(cam, sim3.apply(sim3.inverse(S), xc1))
    e1 = ((proj1 - project(cam, xc1)) ** 2).sum(-1)
    e2 = ((proj2 - project(cam, xc2)) ** 2).sum(-1)
    return valid & (e1 < CHI2_SIM3 * sigma2_1) & (e2 < CHI2_SIM3 * sigma2_2)


def solve_sim3_ransac(cam: Camera, xc1, xc2, valid, sigma2_1, sigma2_2,
                      generator: Optional[torch.Generator] = None,
                      n_hyp: int = 128, min_inliers: int = 20,
                      hyp_idx: Optional[torch.Tensor] = None) -> Sim3Result:
    """Batched-hypothesis RANSAC over matched camera-frame points xc1/xc2
    [N, 3] (the same map points in the two keyframes' camera frames).
    ``hyp_idx`` [n_hyp, 3] overrides the generator's draws."""
    fp32_solvers()
    if hyp_idx is None:
        hyp_idx = sample_hypotheses(valid, n_hyp, generator, 3)
    idx = hyp_idx.long().to(xc1.device)
    S = horn_sim3(xc2[idx], xc1[idx], torch.ones(idx.shape, device=xc1.device))  # [B, 8]
    inl = _mutual_inliers(cam, S, xc1, xc2, valid, sigma2_1, sigma2_2)             # [B, N]
    best = torch.argmax(inl.sum(1))
    S_best, inliers = S[best], inl[best]

    # polish on the inliers (weighted Horn, one round)
    S_ref = horn_sim3(xc2, xc1, inliers.to(torch.float32))
    inl_ref = _mutual_inliers(cam, S_ref, xc1, xc2, valid, sigma2_1, sigma2_2)
    better = inl_ref.sum() >= inliers.sum()
    S_best = torch.where(better, S_ref, S_best)
    inliers = torch.where(better, inl_ref, inliers)
    n = inliers.sum()
    return Sim3Result(S12=S_best, inliers=inliers, n_inliers=n, success=n >= min_inliers)


def optimize_sim3(cam: Camera, S12, xc1, xc2, valid, inv_sigma2_1, inv_sigma2_2,
                  iters: int = 10, huber2: float = 10.0) -> Sim3Result:
    """LM over the 7-dof Sim3 with bidirectional reprojection residuals
    (OptimizeSim3; Huber delta^2 = 10)."""
    fp32_solvers()
    delta = huber2 ** 0.5
    dev = xc1.device
    m = valid.to(torch.float32)
    uv1, uv2 = project(cam, xc1), project(cam, xc2)

    def residuals(S):
        r1 = project(cam, sim3.apply(S, xc2)) - uv1
        r2 = project(cam, sim3.apply(sim3.inverse(S), xc1)) - uv2
        return r1, r2

    def hub(c):
        chi = torch.sqrt(torch.clamp(c, min=1e-12))
        return torch.where(chi <= delta, c, 2 * delta * chi - delta * delta)

    def cost_of(S):
        r1, r2 = residuals(S)
        c1 = (r1 * r1).sum(-1) * inv_sigma2_1
        c2 = (r2 * r2).sum(-1) * inv_sigma2_2
        return (m * (hub(c1) + hub(c2))).sum()

    def w_of(c, inv_s2):
        chi2 = (c * c).sum(-1) * inv_s2
        chi = torch.sqrt(torch.clamp(chi2, min=1e-12))
        return torch.sqrt(torch.where(chi <= delta, torch.ones_like(chi), delta / chi) * inv_s2)

    S = S12
    lam = torch.tensor(1e-3, dtype=torch.float32, device=dev)
    eye7 = torch.eye(7, dtype=torch.float32, device=dev)
    for _ in range(iters):
        # IRLS weights frozen at the current estimate
        r1c, r2c = residuals(S)
        w1 = w_of(r1c, inv_sigma2_1)[:, None]
        w2 = w_of(r2c, inv_sigma2_2)[:, None]

        def res_rows(xi, S=S, w1=w1, w2=w2):
            # one tangent per point ([N, 7], all zero): row n's residuals
            # depend on row n only, so its Jacobian is that point's block
            r1, r2 = residuals(sim3.retract(S, xi))
            return torch.cat([r1 * w1, r2 * w2], -1) * m[:, None]      # [N, 4]

        xi0 = torch.zeros((xc1.shape[0], 7), dtype=torch.float32, device=dev)
        r, (J,) = sim3.row_jacobians(res_rows, (xi0,), (0,))         # [N, 4], [N, 4, 7]
        H = torch.einsum("nki,nkj->ij", J, J)
        b = torch.einsum("nki,nk->i", J, r)
        Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye7
        dx = -torch.linalg.solve_ex(Hd, b)[0]
        dx = dx * torch.clamp(1.0 / torch.clamp(torch.linalg.norm(dx), min=1e-12), max=1.0)
        S_new = sim3.retract(S, dx)
        accept = cost_of(S_new) < cost_of(S)
        S = torch.where(accept, S_new, S)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-6, 1e3)

    r1, r2 = residuals(S)
    c1 = (r1 * r1).sum(-1) * inv_sigma2_1
    c2 = (r2 * r2).sum(-1) * inv_sigma2_2
    inliers = valid & (c1 < huber2) & (c2 < huber2)
    n = inliers.sum()
    return Sim3Result(S12=S, inliers=inliers, n_inliers=n, success=n >= 10)


def optimize_sim3_schedule(cam, S12, xc1, xc2, valid, inv_s2_1, inv_s2_2) -> Sim3Result:
    """OptimizeSim3's schedule: 5 iterations, drop chi2 > 10
    correspondences, then 10 more on the survivors."""
    r1 = optimize_sim3(cam, S12, xc1, xc2, valid, inv_s2_1, inv_s2_2, iters=5)
    return optimize_sim3(cam, r1.S12, xc1, xc2, valid & r1.inliers, inv_s2_1, inv_s2_2,
                         iters=10)
