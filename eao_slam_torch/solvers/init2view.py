"""Two-view monocular initialization: batched H/F RANSAC + pose recovery.

All hypotheses of both models are solved at once (batched eigh), scored
against every correspondence in one broadcast, refined on their inliers,
and the pose is elected jointly over the 8 homography and 4 essential
decompositions by cheirality (the reference's documented divergence from
Initializer::ReconstructH/F).

Hypothesis sampling takes a ``torch.Generator``. The reference draws its
samples with ``jax.random``, whose stream torch cannot replay, so
``initialize_two_view`` also accepts the sample indices directly.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from eao_slam_torch.geometry import se3, triangulate
from eao_slam_torch.geometry.camera import Camera

CHI2_H = 5.991
CHI2_F = 3.841
SCORE_CAP = 5.991


def normalize_points(uv: torch.Tensor, valid: torch.Tensor):
    """Zero-mean, unit-mean-absolute-deviation normalisation.
    Returns (normalized [M, 2], T [3, 3]) with x_norm = T x."""
    n = torch.clamp(valid.sum(), min=1)
    vm = valid[:, None]
    mean = torch.where(vm, uv, 0.0).sum(0) / n
    dev = torch.where(vm, torch.abs(uv - mean), 0.0).sum(0) / n
    s = 1.0 / torch.clamp(dev, min=1e-6)
    out = (uv - mean) * s
    z = torch.zeros((), dtype=uv.dtype, device=uv.device)
    o = torch.ones((), dtype=uv.dtype, device=uv.device)
    T = torch.stack([
        torch.stack([s[0], z, -mean[0] * s[0]]),
        torch.stack([z, s[1], -mean[1] * s[1]]),
        torch.stack([z, z, o]),
    ])
    return out, T


def _smallest_eigvec(AtA: torch.Tensor) -> torch.Tensor:
    _, V = torch.linalg.eigh(AtA)
    return V[..., :, 0]


def _h_rows(p1, p2):
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1)
    r2 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], -1)
    return r1, r2


def _f_rows(p1, p2):
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    o = torch.ones_like(x1)
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o], -1)


def _rank2(F: torch.Tensor) -> torch.Tensor:
    U, S, Vt = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    return U @ (S[..., :, None] * Vt)


def _solve_h_batch(p1, p2):
    r1, r2 = _h_rows(p1, p2)
    A = torch.cat([r1, r2], -2)
    h = _smallest_eigvec(A.transpose(-1, -2) @ A)
    return h.reshape(*h.shape[:-1], 3, 3)


def _solve_f_batch(p1, p2):
    A = _f_rows(p1, p2)
    f = _smallest_eigvec(A.transpose(-1, -2) @ A)
    return _rank2(f.reshape(*f.shape[:-1], 3, 3))


def _homog(a):
    return torch.cat([a, torch.ones_like(a[:, :1])], -1)


def _score_h(H21, uv1, uv2, valid, sigma: float):
    """Symmetric transfer score (CheckHomography). H21: [B, 3, 3]."""
    inv_s2 = 1.0 / (sigma * sigma)
    H12 = torch.linalg.inv_ex(H21)[0]

    def transfer(H, a, b):
        x = torch.einsum("bij,mj->bmi", H, _homog(a))
        w = torch.where(torch.abs(x[..., 2]) < 1e-9, torch.full_like(x[..., 2], 1e-9), x[..., 2])
        p = x[..., :2] / w[..., None]
        return ((p - b[None]) ** 2).sum(-1) * inv_s2

    chi1 = transfer(H21, uv1, uv2)
    chi2 = transfer(H12, uv2, uv1)
    in1 = (chi1 < CHI2_H) & valid[None]
    in2 = (chi2 < CHI2_H) & valid[None]
    score = (torch.where(in1, CHI2_H - chi1, 0.0).sum(-1)
             + torch.where(in2, CHI2_H - chi2, 0.0).sum(-1))
    return score, in1 & in2


def _score_f(F21, uv1, uv2, valid, sigma: float):
    """Epipolar-distance score (CheckFundamental). F21: [B, 3, 3]."""
    inv_s2 = 1.0 / (sigma * sigma)
    x1 = _homog(uv1)
    x2 = _homog(uv2)
    l2 = torch.einsum("bij,mj->bmi", F21, x1)
    num2 = (l2 * x2[None]).sum(-1)
    chi1 = num2 * num2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12) * inv_s2
    l1 = torch.einsum("bji,mj->bmi", F21, x2)
    num1 = (l1 * x1[None]).sum(-1)
    chi2 = num1 * num1 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12) * inv_s2
    in1 = (chi1 < CHI2_F) & valid[None]
    in2 = (chi2 < CHI2_F) & valid[None]
    score = (torch.where(in1, SCORE_CAP - chi1, 0.0).sum(-1)
             + torch.where(in2, SCORE_CAP - chi2, 0.0).sum(-1))
    return score, in1 & in2


def _decompose_e(E):
    """Essential -> 4 (R, t) candidates."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-9)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _decompose_h(H, K):
    """Faugeras SVD homography decomposition -> 8 (R, t) candidates."""
    A = torch.linalg.inv(K) @ H @ K
    U, d, Vt = torch.linalg.svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = d[0], d[1], d[2]
    den13 = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den13, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den13, min=0.0))
    x1s = [aux1, aux1, -aux1, -aux1]
    x3s = [aux3, -aux3, aux3, -aux3]
    prod = torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0)
    stheta = torch.sqrt(prod) / torch.clamp((d1 + d3) * d2, min=1e-12)
    ctheta = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    sphi = torch.sqrt(prod) / torch.clamp((d1 - d3) * d2, min=1e-12)
    cphi = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    z = torch.zeros_like(d1)
    o = torch.ones_like(d1)
    Rs, ts = [], []
    for i in range(4):   # d' > 0
        st = stheta * torch.sign(x1s[i]) * torch.sign(x3s[i])
        Rp = torch.stack([torch.stack([ctheta, z, -st]), torch.stack([z, o, z]),
                          torch.stack([st, z, ctheta])])
        tp = torch.stack([x1s[i], z, -x3s[i]]) * (d1 - d3)
        t = U @ tp
        Rs.append(s * U @ Rp @ Vt)
        ts.append(t / torch.clamp(torch.linalg.norm(t), min=1e-9))
    for i in range(4):   # d' < 0
        sp = sphi * torch.sign(x1s[i]) * torch.sign(x3s[i])
        Rp = torch.stack([torch.stack([cphi, z, sp]), torch.stack([z, -o, z]),
                          torch.stack([sp, z, -cphi])])
        tp = torch.stack([x1s[i], z, x3s[i]]) * (d1 + d3)
        t = U @ tp
        Rs.append(s * U @ Rp @ Vt)
        ts.append(t / torch.clamp(torch.linalg.norm(t), min=1e-9))
    return torch.stack(Rs), torch.stack(ts)


def _check_rt(cam: Camera, Rs, ts, uv1, uv2, inliers):
    """Cheirality + parallax of every (R, t) candidate [B] over all inlier
    matches. Returns (n_good [B], parallax_deg [B], points [B, M, 3],
    good [B, M])."""
    B = Rs.shape[0]
    M = uv1.shape[0]
    T1 = se3.identity(device=uv1.device).expand(B, 1, 3, 4)
    T2 = se3.make(Rs, ts)[:, None]
    xn1 = triangulate.pixels_to_normalized(cam, uv1)[None]
    xn2 = triangulate.pixels_to_normalized(cam, uv2)[None]
    Xw = triangulate.triangulate(T1, T2, xn1, xn2)                 # [B, M, 3]
    good = triangulate.check_triangulation(
        cam, T1, T2, Xw, uv1[None], uv2[None], torch.ones_like(Xw[..., 0]),
        max_reproj_chi2=4.0, min_parallax_cos=0.99998,
    )
    good = good & inliers[None]
    c2 = -(Rs.transpose(-1, -2) @ ts[..., None])[..., 0]            # [B, 3]
    v1 = Xw
    v2 = Xw - c2[:, None]
    cosp = (v1 * v2).sum(-1) / torch.clamp(
        torch.linalg.norm(v1, dim=-1) * torch.linalg.norm(v2, dim=-1), min=1e-9)
    par_deg = torch.rad2deg(torch.arccos(torch.clamp(cosp, -1.0, 1.0)))
    par_sorted = torch.sort(torch.where(good, par_deg, 0.0), dim=-1, descending=True).values
    n_good = good.sum(-1)
    idx50 = torch.clamp(torch.clamp(n_good, max=50) - 1, min=0)
    parallax = torch.gather(par_sorted, 1, idx50[:, None])[:, 0]
    return n_good, parallax, Xw, good


def _refine_h(p1, p2, w):
    r1, r2 = _h_rows(p1, p2)
    A = torch.cat([r1 * w[:, None], r2 * w[:, None]], 0)
    return _smallest_eigvec((A.T @ A)[None])[0].reshape(3, 3)


def _refine_f(p1, p2, w):
    A = _f_rows(p1, p2) * w[:, None]
    f = _smallest_eigvec((A.T @ A)[None])[0]
    return _rank2(f.reshape(3, 3))


class InitResult(NamedTuple):
    success: torch.Tensor    # bool
    T21: torch.Tensor        # [3, 4] pose of frame 2 wrt frame 1
    points: torch.Tensor     # [M, 3] in frame 1
    point_ok: torch.Tensor   # [M] bool
    used_h: torch.Tensor     # bool
    n_inliers: torch.Tensor


def sample_hypotheses(valid: torch.Tensor, n_hyp: int,
                      generator: Optional[torch.Generator],
                      sample_size: int = 8) -> torch.Tensor:
    """[n_hyp, sample_size] indices drawn with replacement from the valid
    rows, on the host (a seed gives the same draws on every device)."""
    p = valid.to(torch.float32)
    p = p / torch.clamp(p.sum(), min=1.0)
    if float(p.sum()) == 0.0:
        p = torch.ones_like(p) / p.numel()
    flat = torch.multinomial(p.cpu(), n_hyp * sample_size, replacement=True,
                             generator=generator)
    return flat.reshape(n_hyp, sample_size).to(valid.device)


def initialize_two_view(cam: Camera, uv1, uv2, valid,
                        generator: Optional[torch.Generator] = None,
                        sigma: float = 1.0, n_hyp: int = 256,
                        min_triangulated: int = 50,
                        hyp_idx: Optional[torch.Tensor] = None) -> InitResult:
    """Monocular initialization from matched pairs uv1/uv2 [M, 2], valid [M].
    ``hyp_idx`` [n_hyp, 8] overrides the generator's samples."""
    if hyp_idx is None:
        hyp_idx = sample_hypotheses(valid, n_hyp, generator)
    hyp_idx = hyp_idx.long()
    nuv1, T1n = normalize_points(uv1, valid)
    nuv2, T2n = normalize_points(uv2, valid)
    s1 = nuv1[hyp_idx]
    s2 = nuv2[hyp_idx]
    T2n_inv = torch.linalg.inv(T2n)

    # homography hypotheses, then two re-fits on the inliers
    Hn = _solve_h_batch(s1, s2)
    H21 = T2n_inv[None] @ Hn @ T1n[None]
    h_scores, h_in = _score_h(H21, uv1, uv2, valid, sigma)
    h_best = torch.argmax(h_scores)
    SH, H_best, h_inliers = h_scores[h_best], H21[h_best], h_in[h_best]
    for _ in range(2):
        H_r = T2n_inv @ _refine_h(nuv1, nuv2, h_inliers.float()) @ T1n
        sc, inl = _score_h(H_r[None], uv1, uv2, valid, sigma)
        better = sc[0] > SH
        SH = torch.where(better, sc[0], SH)
        H_best = torch.where(better, H_r, H_best)
        h_inliers = torch.where(better, inl[0], h_inliers)

    # fundamental hypotheses
    Fn = _solve_f_batch(s1, s2)
    F21 = T2n.T[None] @ Fn @ T1n[None]
    f_scores, f_in = _score_f(F21, uv1, uv2, valid, sigma)
    f_best = torch.argmax(f_scores)
    SF, F_best, f_inliers = f_scores[f_best], F21[f_best], f_in[f_best]
    for _ in range(2):
        F_r = T2n.T @ _refine_f(nuv1, nuv2, f_inliers.float()) @ T1n
        sc, inl = _score_f(F_r[None], uv1, uv2, valid, sigma)
        better = sc[0] > SF
        SF = torch.where(better, sc[0], SF)
        F_best = torch.where(better, F_r, F_best)
        f_inliers = torch.where(better, inl[0], f_inliers)

    RH = SH / torch.clamp(SH + SF, min=1e-9)
    use_h = RH > 0.40

    # joint election over all 8 H and 4 E candidates, union inlier set
    K = cam.K(uv1.device)
    E = K.T @ F_best @ K
    Rs_e, ts_e = _decompose_e(E)
    Rs_h, ts_h = _decompose_h(H_best, K)
    Rs = torch.cat([Rs_h, Rs_e], 0)
    ts = torch.cat([ts_h, ts_e], 0)
    inliers = h_inliers | f_inliers
    n_good, par, Xw, good = _check_rt(cam, Rs, ts, uv1, uv2, inliers)

    best = torch.argmax(n_good)
    n_best = n_good[best]
    R_b = Rs[best]
    t_b = ts[best] / torch.clamp(torch.linalg.norm(ts[best]), min=1e-9)
    tr = torch.einsum("ij,nij->n", R_b, Rs)
    t_n = ts / torch.clamp(torch.linalg.norm(ts, dim=-1, keepdim=True), min=1e-9)
    cos15 = math.cos(math.radians(15.0))
    same_pose = (tr > 1.0 + 2.0 * cos15) & ((t_n @ t_b) > cos15)
    n_similar = ((n_good > 0.7 * n_best) & ~same_pose).sum()
    min_good = torch.clamp((0.9 * inliers.sum()).to(torch.int64), min=min_triangulated)
    ok = (n_best >= min_good) & (n_similar == 0) & (par[best] > 1.0)
    return InitResult(
        success=ok,
        T21=se3.make(Rs[best], ts[best]),
        points=Xw[best],
        point_ok=good[best] & ok,
        used_h=use_h,
        n_inliers=inliers.sum(),
    )
