"""Distributed BA on a ("host", "device") mesh: observation-sharded Schur,
solved directly or by conjugate gradients.

Each shard (one rank; shards are numbered row-major over the two axes)
owns a contiguous block of points and every observation of those points,
routed once on the host by a stable sort (``shard_problem``). The poses
are replicated.

``method="direct"`` (the default): each shard assembles its point
cliques' contribution to the reduced camera system S = Hcc_d - W B^-1 W^T
([6K, 6K]); one packed ``psum`` per LM iteration carries (Hcc | bc | cost
| W B^-1 W^T | W B^-1 bp) and every rank solves the same dense system.
Memory per shard is O(P_shard K) for the clique tensor.

``method="cg"``: S is never formed. ``S x`` is evaluated matrix-free over
the shard's observations, with one [K, 6] ``psum`` per product, and
solved by block-Jacobi preconditioned CG with a fixed iteration count;
the preconditioner's 6x6 inversions are split over the host axis and
all-gathered along it.

Both share the residual pass and the LM tail: the point back-substitution
is shard-local, and a step is accepted on one packed ``psum`` of (the new
cost, the shards whose points are finite). Sums over observations are
accumulated in float64 and taken back to float32, as in the single-device
solver; on a card ``index_add_`` adds in no fixed order, so the solvers
are held to tolerances, not to bit equality.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from eao_slam_torch.device import fp32_solvers
from eao_slam_torch.geometry import se3
from eao_slam_torch.geometry.camera import Camera
from eao_slam_torch.parallel.distributed import (DEV_AXIS, HOST_AXIS, Mesh, all_gather,
                                                 psum, world)
from eao_slam_torch.solvers.ba import CHI2_MONO, BAProblem, BAResult, _residuals, inv3x3
from eao_slam_torch.solvers.pose_lm import huber_cost, huber_weight

BOTH = (HOST_AXIS, DEV_AXIS)


def make_hd_mesh(n_hosts: int = 1, device=None) -> Mesh:
    """The (host, device) mesh over every rank, the ranks in rank order
    folded into ``n_hosts`` rows."""
    _, n = world()
    if n % n_hosts:
        raise ValueError(f"{n} ranks not divisible into {n_hosts} hosts")
    return Mesh(np.arange(n).reshape(n_hosts, n // n_hosts), BOTH, device)


class ShardedBA(NamedTuple):
    """The observation table re-blocked: shard s owns point block s and
    every observation of those points. Leading dim S = hosts x devices
    (as ``shard_problem`` returns it; one shard's arrays without it)."""

    points: torch.Tensor      # [S, Pl, 3]
    pt_valid: torch.Tensor    # [S, Pl]
    kf_idx: torch.Tensor      # [S, Os] int32 (global keyframe id)
    pt_local: torch.Tensor    # [S, Os] int32 (point id in the shard, sorted)
    uv: torch.Tensor          # [S, Os, 2]
    inv_sigma2: torch.Tensor  # [S, Os]
    obs_valid: torch.Tensor   # [S, Os]


def _routing(pt_idx: np.ndarray, n_shards: int, Pl: int):
    """The stable sort of the observations by point, each one's shard and
    the observations per shard."""
    order = np.argsort(pt_idx, kind="stable")
    counts = np.bincount(pt_idx[order] // Pl, minlength=n_shards)
    return order, counts


def shard_problem(prob: BAProblem, n_shards: int, k_pad: int) -> tuple:
    """Host-side routing: K padded to a multiple of ``k_pad`` (the host
    axis), P to a multiple of ``n_shards``, every observation sent to the
    shard that owns its point (a stable sort by point id, so the ids within
    a shard are sorted; the padding repeats the last id, Pl - 1, and
    carries no weight). Observations of invalid cameras are folded out of
    ``obs_valid``. Returns (ShardedBA, replicated BAProblem with the padded
    poses and camera flags, P, K)."""
    dev = prob.poses.device
    Pn = int(prob.points.shape[0])
    K = int(prob.poses.shape[0])
    p_pad = (-Pn) % n_shards
    Pl = (Pn + p_pad) // n_shards
    kpad = (-K) % k_pad

    pts = prob.points.detach().cpu().numpy()
    ptv = prob.pt_valid.cpu().numpy()
    if p_pad:
        pts = np.pad(pts, ((0, p_pad), (0, 0)))
        ptv = np.pad(ptv, (0, p_pad))
    pt_idx = prob.pt_idx.cpu().numpy().astype(np.int64)
    kf_idx = prob.kf_idx.cpu().numpy()
    order, counts = _routing(pt_idx, n_shards, Pl)
    Os = max(8, int(-(-int(counts.max()) // 8) * 8))
    pos = np.concatenate([[0], np.cumsum(counts)])

    def blocked(x, fill=0):
        x = np.asarray(x)[order]
        out = np.full((n_shards, Os) + x.shape[1:], fill, dtype=x.dtype)
        for s in range(n_shards):
            out[s, : counts[s]] = x[pos[s]: pos[s + 1]]
        return torch.as_tensor(out, device=dev)

    obs_ok = prob.obs_valid.cpu().numpy() & prob.cam_valid.cpu().numpy()[np.clip(kf_idx, 0, K - 1)]
    sh = ShardedBA(
        points=torch.as_tensor(pts.reshape(n_shards, Pl, 3), device=dev),
        pt_valid=torch.as_tensor(ptv.reshape(n_shards, Pl), device=dev),
        kf_idx=blocked(kf_idx.astype(np.int32)),
        pt_local=blocked((pt_idx % Pl).astype(np.int32), fill=Pl - 1),
        uv=blocked(prob.uv.detach().cpu().numpy()),
        inv_sigma2=blocked(prob.inv_sigma2.detach().cpu().numpy()),
        obs_valid=blocked(obs_ok, fill=False),
    )
    empty = torch.zeros((0,), dtype=torch.int32, device=dev)
    rep = BAProblem(
        poses=torch.nn.functional.pad(prob.poses, (0, 0, 0, 0, 0, kpad)),
        points=torch.zeros((0, 3), device=dev),
        kf_idx=empty, pt_idx=empty,
        uv=torch.zeros((0, 2), device=dev),
        inv_sigma2=torch.zeros((0,), device=dev),
        obs_valid=torch.zeros((0,), dtype=torch.bool, device=dev),
        cam_fixed=torch.nn.functional.pad(prob.cam_fixed, (0, kpad), value=True),
        cam_valid=torch.nn.functional.pad(prob.cam_valid, (0, kpad), value=False),
        pt_valid=torch.zeros((0,), dtype=torch.bool, device=dev),
    )
    return sh, rep, Pn, K


def _local_residuals(cam: Camera, poses, pts_l, sh: ShardedBA):
    """Residuals, Jacobians, robust weights and cost of one shard's
    observations (the single-device math on a view of the shard)."""
    view = BAProblem(poses=poses, points=pts_l, kf_idx=sh.kf_idx, pt_idx=sh.pt_local,
                     uv=sh.uv, inv_sigma2=sh.inv_sigma2, obs_valid=sh.obs_valid,
                     cam_fixed=None, cam_valid=None, pt_valid=sh.pt_valid)
    r, Jc, Jp, depth_ok = _residuals(cam, view, poses, pts_l)
    chi2 = (r * r).sum(-1) * sh.inv_sigma2
    m = sh.obs_valid & depth_ok & sh.pt_valid[sh.pt_local.long()]
    w = huber_weight(chi2) * sh.inv_sigma2 * m.to(r.dtype)
    cost = torch.where(m, huber_cost(chi2), torch.zeros_like(chi2)).sum()
    return r, Jc, Jp, w, cost, depth_ok


def _seg(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Segment sum of rows of ``x`` into ``n`` rows, in float64."""
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=torch.float64, device=x.device)
    return out.index_add_(0, idx.long(), x.to(torch.float64)).to(x.dtype)


def _run_sharded(cam: Camera, rep: BAProblem, sh: ShardedBA, mesh: Mesh, iters: int,
                 n_cg: int, direct: bool):
    """The LM loop on this rank's shard -> (poses, local points, local
    inliers, cost)."""
    K = rep.poses.shape[0]
    Pl = sh.points.shape[0]
    n_host = mesh.axis_size(HOST_AXIS)
    n_shards = mesh.axis_size(BOTH)
    dev, dt = sh.points.device, sh.points.dtype
    f = ((~rep.cam_fixed) & rep.cam_valid).to(dt)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    kf, ptl = sh.kf_idx.long(), sh.pt_local.long()

    def point_blocks(Jp, wJp, r, lam):
        Hpp = _seg(torch.einsum("oki,okj->oij", wJp, Jp), ptl, Pl)
        bp = _seg(torch.einsum("oki,ok->oi", wJp, r), ptl, Pl)
        diag_p = torch.clamp(torch.diagonal(Hpp, dim1=1, dim2=2), min=1e-8)
        floor_p = 1e-5 * diag_p.amax(1, keepdim=True) + 1e-8
        return inv3x3(Hpp + (lam * diag_p + floor_p)[:, :, None] * eye3[None]), bp

    def damped(Hcc, lam):
        diag_c = torch.clamp(torch.diagonal(Hcc, dim1=1, dim2=2), min=1e-8)
        Hcc_d = Hcc + lam * diag_c[:, :, None] * eye6[None]
        # identity rows for fixed and invalid cameras
        return Hcc_d * f[:, None, None] + (1.0 - f)[:, None, None] * eye6[None]

    def apply_update(poses, pts_l, lam, cost, dc, bp, Binv, Jc, Jp, w):
        s = torch.einsum("oij,oj->oi", Jc, dc[kf])
        ztop = torch.einsum("oij,oi->oj", Jp, s * w[:, None])
        dp = torch.einsum("pij,pj->pi", Binv, -bp - _seg(ztop, ptl, Pl))
        dp = dp * sh.pt_valid[:, None].to(dt)
        dc_norm = torch.linalg.norm(dc, dim=-1, keepdim=True)
        dc = dc * torch.clamp(1.0 / torch.clamp(dc_norm, min=1e-12), max=1.0)
        new_poses = se3.orthonormalize(se3.compose(se3.exp(dc), poses))
        new_pts = pts_l + dp
        nc_p = _local_residuals(cam, new_poses, new_pts, sh)[4]
        pk = psum(torch.stack([nc_p, torch.isfinite(new_pts).all().to(dt)]), mesh, BOTH)
        new_cost = pk[0]
        finite = torch.isfinite(new_poses).all() & torch.isfinite(new_cost) & (pk[1] == n_shards)
        accept = (new_cost < cost) & finite
        poses = torch.where(accept, new_poses, poses)
        pts_l = torch.where(accept, new_pts, pts_l)
        lam = torch.clamp(torch.where(accept, lam * 0.4, lam * 5.0), 1e-8, 1e4)
        return poses, pts_l, lam, torch.where(accept, new_cost, cost)

    def lm_iter_direct(poses, pts_l, lam):
        r, Jc, Jp, w, cost_p, _ = _local_residuals(cam, poses, pts_l, sh)
        wJc = Jc * w[:, None, None]
        wJp = Jp * w[:, None, None]
        occ = _seg(torch.einsum("oki,okj->oij", wJc, Jc), kf, K)
        obc = _seg(torch.einsum("oki,ok->oi", wJc, r), kf, K)
        Binv, bp = point_blocks(Jp, wJp, r, lam)
        # per-(point, camera) clique blocks W_kp = sum_o Jc^T w Jp  [6, 3]
        Wkp = torch.einsum("oci,ocj->oij", wJc, Jp)
        Y = _seg(Wkp, ptl * K + kf, Pl * K).reshape(Pl, K, 6, 3)
        Z = torch.einsum("pkil,plm->pkim", Y, Binv)
        A = Z.permute(1, 2, 0, 3).reshape(K * 6, Pl * 3)
        Bm = Y.permute(1, 2, 0, 3).reshape(K * 6, Pl * 3)
        WBW = A @ Bm.T
        u0 = torch.einsum("pkij,pj->ki", Y, torch.einsum("pij,pj->pi", Binv, bp))
        packed = psum(torch.cat([occ.reshape(-1), obc.reshape(-1), cost_p[None],
                                 WBW.reshape(-1), u0.reshape(-1)]), mesh, BOTH)
        off = K * 36
        Hcc = packed[:off].reshape(K, 6, 6)
        bc = packed[off:off + K * 6].reshape(K, 6)
        off += K * 6
        cost = packed[off]
        off += 1
        WBW = packed[off:off + (K * 6) ** 2].reshape(K * 6, K * 6)
        off += (K * 6) ** 2
        u0 = packed[off:off + K * 6].reshape(K, 6)

        S = (-WBW).reshape(K, 6, K, 6).clone()
        ar = torch.arange(K, device=dev)
        S[ar, :, ar, :] += damped(Hcc, lam)
        S = S.reshape(K * 6, K * 6)
        f6 = f.repeat_interleave(6)
        S = S * (f6[:, None] * f6[None, :]) + torch.diag(1.0 - f6)
        rhs = ((-bc + u0) * f[:, None]).reshape(-1)
        dc = torch.linalg.solve_ex(S, rhs)[0].reshape(K, 6) * f[:, None]
        return apply_update(poses, pts_l, lam, cost, dc, bp, Binv, Jc, Jp, w)

    def lm_iter_cg(poses, pts_l, lam):
        r, Jc, Jp, w, cost_p, _ = _local_residuals(cam, poses, pts_l, sh)
        wJc = Jc * w[:, None, None]
        wJp = Jp * w[:, None, None]
        occ = _seg(torch.einsum("oki,okj->oij", wJc, Jc), kf, K)
        obc = _seg(torch.einsum("oki,ok->oi", wJc, r), kf, K)
        packed = psum(torch.cat([occ.reshape(-1), obc.reshape(-1), cost_p[None]]), mesh, BOTH)
        Hcc = packed[: K * 36].reshape(K, 6, 6)
        bc = packed[K * 36: K * 42].reshape(K, 6)
        cost = packed[K * 42]
        Binv, bp = point_blocks(Jp, wJp, r, lam)
        Hcc_d = damped(Hcc, lam)

        def Wt_x(x):
            e = torch.einsum("oij,oj->oi", Jc, x[kf])
            return _seg(torch.einsum("oij,oi->oj", Jp, e * w[:, None]), ptl, Pl)

        def W_t(t):
            s = torch.einsum("oij,oj->oi", Jp, t[ptl])
            return psum(_seg(torch.einsum("oij,oi->oj", Jc, s * w[:, None]), kf, K), mesh, BOTH)

        def matvec(x):
            x = x * f[:, None]
            t = torch.einsum("pij,pj->pi", Binv, Wt_x(x))
            Sx = torch.einsum("kij,kj->ki", Hcc_d, x) - W_t(t)
            return Sx * f[:, None] + x * (1.0 - f)[:, None]

        rhs = (-bc + W_t(torch.einsum("pij,pj->pi", Binv, bp))) * f[:, None]
        # block-Jacobi preconditioner: the 6x6 inversions split over the
        # host axis, gathered along it
        Kh = K // n_host
        hb = mesh.axis_index(HOST_AXIS) * Kh
        Minv_h = torch.linalg.inv_ex(Hcc_d[hb:hb + Kh] + 1e-6 * eye6[None])[0]
        Minv = all_gather(Minv_h, mesh, HOST_AXIS)
        tiny = torch.tensor(1e-20, dtype=dt, device=dev)
        x = torch.zeros_like(rhs)
        rr = rhs
        p = torch.einsum("kij,kj->ki", Minv, rhs)
        rz = (rhs * p).sum()
        for _ in range(n_cg):
            Sp = matvec(p)
            pSp = (p * Sp).sum()
            alpha = rz / torch.where(torch.abs(pSp) < 1e-20, tiny, pSp)
            x = x + alpha * p
            rr = rr - alpha * Sp
            z = torch.einsum("kij,kj->ki", Minv, rr)
            rz_new = (rr * z).sum()
            beta = rz_new / torch.where(torch.abs(rz) < 1e-20, tiny, rz)
            p = z + beta * p
            rz = rz_new
        return apply_update(poses, pts_l, lam, cost, x * f[:, None], bp, Binv, Jc, Jp, w)

    step = lm_iter_direct if direct else lm_iter_cg
    poses, pts_l = rep.poses, sh.points
    lam = torch.tensor(1e-4, dtype=dt, device=dev)
    cost = torch.tensor(float("inf"), dtype=dt, device=dev)
    for _ in range(iters):
        poses, pts_l, lam, cost = step(poses, pts_l, lam)
    r, _, _, _, _, depth_ok = _local_residuals(cam, poses, pts_l, sh)
    chi2 = (r * r).sum(-1) * sh.inv_sigma2
    # a behind-camera observation is never an inlier (the single-device rule)
    inlier = sh.obs_valid & depth_ok & (chi2 < CHI2_MONO)
    return poses, pts_l, inlier, cost


def distributed_bundle_adjust_v2(cam: Camera, prob: BAProblem, mesh: Mesh, iters: int = 10,
                                 n_cg: int = 32, method: str = "direct") -> BAResult:
    """The same problem in on every rank, the same result out, at the
    caller's K and P and in its observation order. ``method``: "direct"
    (the dense reduced camera system, 2 collectives per LM iteration, for
    K up to a few hundred) or "cg" (matrix-free, O(K) memory per shard)."""
    if method not in ("direct", "cg"):
        raise ValueError(f"method {method!r}: 'direct' or 'cg'")
    fp32_solvers()
    n_shards = mesh.axis_size(BOTH)
    sh_all, rep, Pn, K = shard_problem(prob, n_shards, k_pad=mesh.axis_size(HOST_AXIS))
    s = mesh.axis_index(BOTH)
    sh = ShardedBA(*(x[s] for x in sh_all))
    poses, pts_l, inlier_l, cost = _run_sharded(cam, rep, sh, mesh, iters, n_cg,
                                                direct=method == "direct")
    points = all_gather(pts_l, mesh, BOTH)[:Pn]
    inl = all_gather(inlier_l, mesh, BOTH).reshape(n_shards, -1).cpu().numpy()
    # back to the caller's observation order
    pt_idx = prob.pt_idx.cpu().numpy().astype(np.int64)
    order, counts = _routing(pt_idx, n_shards, sh.points.shape[0])
    flat = np.concatenate([inl[i, : counts[i]] for i in range(n_shards)])
    obs_inlier = np.zeros(len(pt_idx), bool)
    obs_inlier[order] = flat
    return BAResult(poses=poses[:K], points=points,
                    obs_inlier=torch.as_tensor(obs_inlier, device=prob.obs_valid.device)
                    & prob.obs_valid, cost=cost)
