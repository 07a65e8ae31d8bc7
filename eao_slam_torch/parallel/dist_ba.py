"""Distributed bundle adjustment: point blocks sharded over the ranks.

The Schur structure splits by point: each rank owns a contiguous block of
the points (and their Hpp / Wcp blocks), the poses are replicated, the
reduced camera system S = Hcc - sum_p W_p Hpp_p^-1 W_p^T is summed over
the ranks (one ``psum`` each for Hcc, bc, the off-diagonal term and its
right-hand side) and solved the same way on every rank, and the points
are all-gathered for the residual pass. Every rank sees every
observation, so the camera blocks are divided by the rank count before
their sum, as the reference does (``cost / n_dev``); a step is accepted
only if every rank's points are finite.

Sums over observations are accumulated in float64 and taken back to
float32, as in the single-device solver; the collectives carry float32.
"""

from __future__ import annotations

import torch

from eao_slam_torch.device import fp32_solvers
from eao_slam_torch.geometry import se3
from eao_slam_torch.geometry.camera import Camera
from eao_slam_torch.parallel.distributed import Mesh, all_gather, line_mesh, psum
from eao_slam_torch.solvers.ba import (CHI2_MONO, BAProblem, BAResult, _residuals, _weights,
                                       inv3x3)

AXIS = "dev"


def make_ba_mesh(device=None) -> Mesh:
    """The one-axis ("dev") mesh over every rank."""
    return line_mesh(AXIS, device)


def _pad_points_to(prob: BAProblem, n_dev: int) -> BAProblem:
    """Pad the point dimension to a multiple of the rank count."""
    rem = (-prob.points.shape[0]) % n_dev
    if rem == 0:
        return prob
    return prob._replace(points=torch.nn.functional.pad(prob.points, (0, 0, 0, rem)),
                         pt_valid=torch.nn.functional.pad(prob.pt_valid, (0, rem)))


def _seg_sum(n_rows: int, idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros((n_rows,) + tuple(x.shape[1:]), dtype=torch.float64, device=x.device)
    return out.index_add_(0, idx, x.to(torch.float64)).to(x.dtype)


def _shard_lm_system(cam: Camera, prob: BAProblem, poses, points_local, mesh: Mesh):
    """This rank's normal-equation blocks: residuals over every
    observation, Hpp / Wcp / bp only for the local points (scatter
    targets outside the shard masked), Hcc / bc / cost summed over the
    ranks."""
    n_dev = mesh.axis_size(AXIS)
    Pl = points_local.shape[0]
    offset = mesh.axis_index(AXIS) * Pl
    points = all_gather(points_local, mesh, AXIS)
    r, Jc, Jp, depth_ok = _residuals(cam, prob, poses, points)
    w, cost_part = _weights(prob, r, depth_ok)
    cost = psum(cost_part / n_dev, mesh, AXIS)

    K = prob.poses.shape[0]
    O = r.shape[0]
    local_pt = prob.pt_idx.long() - offset
    in_shard = (local_pt >= 0) & (local_pt < Pl)
    lp = torch.clamp(local_pt, 0, Pl - 1)
    kf = prob.kf_idx.long()
    w_loc = w * in_shard.to(w.dtype)

    wJc = Jc * w[:, None, None]
    Hcc = psum(_seg_sum(K, kf, torch.einsum("oki,okj->oij", wJc / n_dev, Jc).reshape(O, 36))
               .reshape(K, 6, 6), mesh, AXIS)
    bc = psum(_seg_sum(K, kf, torch.einsum("oki,ok->oi", wJc / n_dev, r)), mesh, AXIS)
    wJp = Jp * w_loc[:, None, None]
    Hpp = _seg_sum(Pl, lp, torch.einsum("oki,okj->oij", wJp, Jp).reshape(O, 9)).reshape(Pl, 3, 3)
    Wcp = _seg_sum(K * Pl, kf * Pl + lp,
                   torch.einsum("oki,okj->oij", Jc * w_loc[:, None, None], Jp).reshape(O, 18)
                   ).reshape(K, Pl, 6, 3)
    bp = _seg_sum(Pl, lp, torch.einsum("oki,ok->oi", wJp, r))
    return Hcc, Hpp, Wcp, bc, bp, cost


def _shard_solve(prob: BAProblem, Hcc, Hpp, Wcp, bc, bp, lam, pt_valid_local, mesh: Mesh):
    """Schur step: the point elimination on each rank's shard, the reduced
    camera solve replicated."""
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
    S_off = psum(torch.einsum("kpil,qpml->kqim", WB, Wcp), mesh, AXIS)
    rhs_red = psum(torch.einsum("kpil,pl->ki", WB, bp), mesh, AXIS)
    S = -S_off
    ar = torch.arange(K, device=dev)
    S[ar, ar] += Hcc_d
    rhs = -(bc - rhs_red)

    f = ((~prob.cam_fixed) & prob.cam_valid).to(dt)
    S = S * f[:, None, None, None] * f[None, :, None, None]
    S[ar, ar] += (1.0 - f)[:, None, None] * eye6[None]
    rhs = rhs * f[:, None]
    Sd = S.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
    dc = torch.linalg.solve_ex(Sd + 1e-8 * torch.eye(6 * K, dtype=dt, device=dev),
                               rhs.reshape(-1))[0].reshape(K, 6) * f[:, None]
    rhs_p = -bp - torch.einsum("kpij,ki->pj", Wcp, dc)
    dp = torch.einsum("pij,pj->pi", Binv, rhs_p)
    return dc, dp * pt_valid_local[:, None].to(dt)


def _shard_cost(cam: Camera, prob: BAProblem, poses, points_local, mesh: Mesh):
    points = all_gather(points_local, mesh, AXIS)
    r, _, _, depth_ok = _residuals(cam, prob, poses, points)
    return psum(_weights(prob, r, depth_ok)[1] / mesh.axis_size(AXIS), mesh, AXIS)


def distributed_bundle_adjust(cam: Camera, prob: BAProblem, mesh: Mesh,
                              iters: int = 10) -> BAResult:
    """Robust LM BA with the points sharded over ``mesh`` (axis "dev"):
    the same problem in on every rank, the same result out (points and
    inliers gathered; the points padded to a multiple of the rank count,
    as the reference returns them)."""
    fp32_solvers()
    n_dev = mesh.axis_size(AXIS)
    prob = _pad_points_to(prob, n_dev)
    Pl = prob.points.shape[0] // n_dev
    lo = mesh.axis_index(AXIS) * Pl
    pts_l = prob.points[lo:lo + Pl]
    ptv_l = prob.pt_valid[lo:lo + Pl]
    poses = prob.poses
    lam = torch.tensor(1e-4, dtype=poses.dtype, device=poses.device)
    for _ in range(iters):
        Hcc, Hpp, Wcp, bc, bp, cost = _shard_lm_system(cam, prob, poses, pts_l, mesh)
        dc, dp = _shard_solve(prob, Hcc, Hpp, Wcp, bc, bp, lam, ptv_l, mesh)
        dc_norm = torch.linalg.norm(dc, dim=-1, keepdim=True)
        dc = dc * torch.clamp(1.0 / torch.clamp(dc_norm, min=1e-12), max=1.0)
        new_poses = se3.orthonormalize(se3.compose(se3.exp(dc), poses))
        new_pts = pts_l + dp
        new_cost = _shard_cost(cam, prob, new_poses, new_pts, mesh)
        all_finite = psum(torch.isfinite(new_pts).all().to(torch.int32), mesh, AXIS) == n_dev
        finite = torch.isfinite(new_poses).all() & all_finite & torch.isfinite(new_cost)
        accept = (new_cost < cost) & finite
        poses = torch.where(accept, new_poses, poses)
        pts_l = torch.where(accept, new_pts, pts_l)
        lam = torch.clamp(torch.where(accept, lam * 0.4, lam * 5.0), 1e-8, 1e4)
    points = all_gather(pts_l, mesh, AXIS)
    r, _, _, depth_ok = _residuals(cam, prob, poses, points)
    chi2 = (r * r).sum(-1) * prob.inv_sigma2
    inlier = prob.obs_valid & depth_ok & (chi2 < CHI2_MONO)
    cost = _shard_cost(cam, prob, poses, pts_l, mesh)
    return BAResult(poses=poses, points=points, obs_inlier=inlier, cost=cost)
