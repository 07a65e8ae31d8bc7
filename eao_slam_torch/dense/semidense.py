"""Semi-dense probabilistic mapping: batched inverse-depth sweeps.

The port of the reference's ``dense/semidense.py`` (ProbabilityMapping,
src/ProbabilityMapping.cc): per keyframe, strong-gradient pixels are swept
over inverse depth against each covisible neighbour (a dense [N, D]
correspondence search with the reference's three gates, photometric +
gradient SSD, parabolic subpixel refinement), the neighbours' hypotheses
are chi2-fused, and a second pass cross-checks every fused depth in the
neighbours' depth maps with a Gauss-Newton refinement.

Where a plain translation would differ from the reference: ``jnp.mod``
takes the divisor's sign (``torch.remainder`` here); float-to-int casts are
clamped in float first (XLA saturates, torch's cast of an out-of-range
value is undefined); the duplicate writes of ``rasterize_depth`` keep the
last write, as XLA's CPU scatter applies them; the inverse-depth samples
are ``jnp.linspace``'s bits (``linspace01``). Pass 1 sweeps all of a
keyframe's neighbours in one batch.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from eao_slam_torch.config import SemiDenseConfig
from eao_slam_torch.device import fp32_solvers, resolve_device
from eao_slam_torch.geometry import se3
from eao_slam_torch.geometry.camera import Camera
from eao_slam_torch.ops.image import sobel_gradients

BIG = 1e9


class SemiDenseResult(NamedTuple):
    pixels: torch.Tensor      # [K, N, 2] (x, y)
    inv_depth: torch.Tensor   # [K, N] fused inverse depth
    sigma: torch.Tensor       # [K, N] fused std
    valid: torch.Tensor       # [K, N]
    points_w: torch.Tensor    # [K, N, 3] world points


def linspace01(n: int, device=None) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` bit for bit: XLA divides the iota by
    n - 1 as a product with the float32 reciprocal (``torch.linspace``
    rounds differently in the last bit)."""
    out = torch.arange(n, dtype=torch.float32, device=device) * float(np.float32(1 / max(n - 1, 1)))
    out[-1] = 1.0
    return out


def _deg2rad(deg: float) -> float:
    """``jnp.deg2rad`` of a Python float: the float32 product."""
    return float(np.float32(deg) * np.float32(np.pi / 180))


def _sample(flat: torch.Tensor, base, W: int, y: torch.Tensor, x: torch.Tensor):
    return flat[base + y * W + x]


def bilinear(img: torch.Tensor, uv: torch.Tensor, batch: torch.Tensor = None) -> torch.Tensor:
    """Bilinear sample of img [H, W] at uv [..., 2] (x, y), out-of-range
    clamped. With ``batch`` (int64, broadcastable to uv[..., 0]) img is
    [B, H, W] and each sample reads image ``batch``."""
    H, W = img.shape[-2:]
    x = torch.clamp(uv[..., 0], 0.0, W - 1.001)
    y = torch.clamp(uv[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = x - x0
    fy = y - y0
    flat = img.reshape(-1)
    base = 0 if batch is None else batch * (H * W)
    v00 = _sample(flat, base, W, y0, x0)
    v01 = _sample(flat, base, W, y0, x0 + 1)
    v10 = _sample(flat, base, W, y0 + 1, x0)
    v11 = _sample(flat, base, W, y0 + 1, x0 + 1)
    return (v00 * (1 - fx) + v01 * fx) * (1 - fy) + (v10 * (1 - fx) + v11 * fx) * fy


def select_edge_pixels(img: torch.Tensor, n_pix: int, lambda_g: float = 8.0, cell: int = 16):
    """Spatially spread strong-gradient pixels of img [H, W] -> (uv [N, 2]
    float32, valid [N]): the top ceil(n_pix / tiles) of each cell x cell
    tile by packed ``score << 20 | index``, then the global top n_pix. The
    packed values are unique, so the selection is the reference's."""
    gx, gy, mag = sobel_gradients(img)
    H, W = img.shape
    border = 8
    dev = img.device
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    inb = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    score = torch.where(inb & (mag > lambda_g * 4.0), mag, torch.zeros_like(mag))
    idx_map = (ys * W + xs).to(torch.int32)
    comb = (torch.clamp(score, 0, 2047).to(torch.int32) << 20) | idx_map
    ph = (cell - H % cell) % cell
    pw = (cell - W % cell) % cell
    sp = torch.nn.functional.pad(comb, (0, pw, 0, ph))
    H2, W2 = sp.shape
    th, tw = H2 // cell, W2 // cell
    tiles = sp.reshape(th, cell, tw, cell).permute(0, 2, 1, 3).reshape(th * tw, cell * cell)
    m = max(1, -(-n_pix // (th * tw)))
    per_tile = torch.topk(tiles, min(m, cell * cell), dim=1).values
    top = torch.topk(per_tile.reshape(-1), n_pix).values
    pix = top & ((1 << 20) - 1)
    uv = torch.stack([(pix % W).to(torch.float32), (pix // W).to(torch.float32)], -1)
    return uv, (top >> 20) > 0


def _sweep(cam: Camera, ref, nb, T_ref, T_nb, uv_ref, px_valid, rho_min, rho_max,
           sd: SemiDenseConfig, n_depth: int):
    """depth_sweep on precomputed (img, gx, gy, mag): ref's [H, W] each,
    nb's [B, H, W] each with T_nb [B, 3, 4]. Returns (rho, sigma, ok, the
    sample index each pixel picked), [B, N] each."""
    img_r, gx_r, gy_r, mag_r = ref
    img_n, gx_n, gy_n, mag_n = nb
    B = img_n.shape[0]
    N = uv_ref.shape[0]
    D = n_depth
    dev = uv_ref.device

    i_ref = bilinear(img_r, uv_ref)
    g_ref = bilinear(mag_r, uv_ref)
    ang_ref = torch.atan2(bilinear(gy_r, uv_ref), bilinear(gx_r, uv_ref))

    T_rel = se3.compose(T_nb, se3.inverse(T_ref)[None])                 # [B, 3, 4]
    rhos = rho_min + (rho_max - rho_min) * linspace01(D, dev)
    xn = torch.stack([(uv_ref[:, 0] - cam.cx) / cam.fx, (uv_ref[:, 1] - cam.cy) / cam.fy,
                      torch.ones(N, device=dev)], -1)
    X = xn[:, None, :] / torch.clamp(rhos, min=1e-6)[None, :, None]     # [N, D, 3]
    xc = torch.einsum("bij,ndj->bndi", se3.rot(T_rel), X) + se3.trans(T_rel)[:, None, None, :]
    z = xc[..., 2]
    zc = torch.clamp(z, min=1e-6)
    u = cam.fx * xc[..., 0] / zc + cam.cx
    v = cam.fy * xc[..., 1] / zc + cam.cy
    uv_n = torch.stack([u, v], -1)                                      # [B, N, D, 2]
    in_img = (z > 0.1) & (u >= 2) & (u < cam.width - 2) & (v >= 2) & (v < cam.height - 2)

    bidx = torch.arange(B, device=dev)[:, None, None]
    i_nb = bilinear(img_n, uv_n, bidx)
    g_nb = bilinear(mag_n, uv_n, bidx)
    ang_nb = torch.atan2(bilinear(gy_n, uv_n, bidx), bilinear(gx_n, uv_n, bidx))

    # the reference's three gates (:787-808)
    epi_dir = uv_n - uv_n[:, :, :1, :]
    epi_ang = torch.atan2(epi_dir[..., 1], epi_dir[..., 0])
    d_epi = torch.abs(torch.remainder(ang_nb - epi_ang + np.pi / 2, np.pi) - np.pi / 2)
    d_ori = torch.abs(torch.remainder(ang_nb - ang_ref[:, None] + np.pi, 2 * np.pi) - np.pi)
    gate = in_img & (g_nb > sd.lambda_g)
    gate &= d_epi < _deg2rad(sd.lambda_l)
    gate &= d_ori < _deg2rad(sd.lambda_theta)

    err_i = i_nb - i_ref[:, None]
    err_g = g_nb - g_ref[:, None]
    score = (err_i * err_i + err_g * err_g / sd.theta) / (sd.sigma_i ** 2)
    score = torch.where(gate, score, torch.full_like(score, BIG))

    best = torch.argmin(score, dim=-1)                                  # [B, N]
    s_best = torch.gather(score, -1, best[..., None])[..., 0]
    ok = px_valid & (s_best < BIG * 0.5)

    sm = torch.gather(score, -1, torch.clamp(best - 1, 0, D - 1)[..., None])[..., 0]
    sp = torch.gather(score, -1, torch.clamp(best + 1, 0, D - 1)[..., None])[..., 0]
    denom = sm - 2 * s_best + sp
    delta = torch.where(torch.abs(denom) > 1e-9, 0.5 * (sm - sp) / denom,
                        torch.zeros_like(denom))
    delta = torch.clamp(delta, -1.0, 1.0)
    step = (rho_max - rho_min) / (D - 1)
    rho = rhos[best] + delta * step

    curv = torch.clamp(denom, min=1e-6) / (step * step)
    sigma = torch.sqrt(2.0 / curv)
    sigma = torch.clamp(sigma, step, rho_max - rho_min)
    return rho, sigma, ok, best


def _gradients(img: torch.Tensor):
    gx, gy, mag = sobel_gradients(img)
    return img, gx, gy, mag


def depth_sweep(cam: Camera, img_ref, img_nb, T_ref, T_nb, uv_ref, px_valid, rho_min, rho_max,
                sd: SemiDenseConfig = SemiDenseConfig(), n_depth: int = 64):
    """One (keyframe, neighbour) hypothesis per edge pixel: the best inverse
    depth [N], its uncertainty [N] and whether the sweep found one [N]
    (EpipolarSearch + ComputeInvDepthHypothesis,
    src/ProbabilityMapping.cc:749-845, 1310-1360). Images [H, W], poses
    [3, 4], rho_min / rho_max float32 scalars. ``sweep_and_fuse`` sweeps
    all of a keyframe's neighbours in one batch."""
    fp32_solvers()
    rho_min, rho_max = (torch.as_tensor(r, dtype=torch.float32, device=uv_ref.device)
                        for r in (rho_min, rho_max))
    rho, sigma, ok, _ = _sweep(cam, _gradients(img_ref), _gradients(img_nb[None]), T_ref,
                               T_nb[None], uv_ref, px_valid, rho_min, rho_max, sd, n_depth)
    return rho[0], sigma[0], ok[0]


def fuse_hypotheses(rho: torch.Tensor, sigma: torch.Tensor, ok: torch.Tensor, lambda_n: int = 3):
    """Chi-squared compatibility fusion over neighbour hypotheses [N, Hn]
    (InverseDepthHypothesisFusion, :978-1009): the hypothesis with the most
    compatible peers, inverse-variance fused with its clique."""
    diff = torch.abs(rho[:, :, None] - rho[:, None, :])
    tol = 2.0 * torch.sqrt(sigma[:, :, None] ** 2 + sigma[:, None, :] ** 2)
    compat = (diff < tol) & ok[:, :, None] & ok[:, None, :]
    support = compat.sum(2)
    best = torch.argmax(support, dim=1)
    clique = torch.gather(compat, 1, best[:, None, None].expand(-1, 1, compat.shape[2]))[:, 0]
    w = torch.where(clique, 1.0 / torch.clamp(sigma, min=1e-9) ** 2, torch.zeros_like(sigma))
    wsum = w.sum(1)
    rho_f = (w * rho).sum(1) / torch.clamp(wsum, min=1e-12)
    sigma_f = torch.sqrt(1.0 / torch.clamp(wsum, min=1e-12))
    n_support = torch.gather(support, 1, best[:, None])[:, 0]
    return rho_f, sigma_f, n_support >= lambda_n


def _round_index(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``clip(round(x).astype(int32), lo, hi)`` with XLA's saturating cast."""
    return torch.clamp(torch.round(x), lo, hi).long()


def inter_kf_check(cam: Camera, uv, rho, valid, T_ref, T_nbs, nb_rho_maps, nb_sig_maps,
                   min_support: int = 2, n_gn: int = 3):
    """Inter-keyframe depth check + Gauss-Newton refinement
    (InterKeyFrameDepthChecking, src/ProbabilityMapping.cc:1011-1295): each
    pixel's depth is projected into every neighbour, whose own fused depth
    at the landing pixel (best of a 3x3 probe) must agree under the
    chi2(1) 95 % gate; pixels with fewer than ``min_support`` agreeing
    neighbours are culled, the others refined against the agreeing set.
    Returns (rho_refined [N], keep [N], n_support [N])."""
    fp32_solvers()
    N = uv.shape[0]
    Hn = T_nbs.shape[0]
    H, W = nb_rho_maps.shape[1:]
    dev = uv.device
    xn = torch.stack([(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy,
                      torch.ones(N, device=dev)], -1)
    T_rel = se3.compose(T_nbs, se3.inverse(T_ref)[None])
    a = T_rel[:, 2, :3] @ xn.T                                          # [Hn, N]
    tz = T_rel[:, 2, 3][:, None]
    flat_rho = nb_rho_maps.reshape(Hn, -1)
    flat_sig = nb_sig_maps.reshape(Hn, -1)

    def project_lookup(rho_cur):
        X = xn[None] / torch.clamp(rho_cur, min=1e-6)[None, :, None]    # [1, N, 3]
        xc = torch.einsum("hij,nj->hni", se3.rot(T_rel), X[0]) + se3.trans(T_rel)[:, None, :]
        z = xc[..., 2]
        zc = torch.clamp(z, min=1e-6)
        u = cam.fx * xc[..., 0] / zc + cam.cx
        v = cam.fy * xc[..., 1] / zc + cam.cy
        ui = _round_index(u, 1, W - 2)
        vi = _round_index(v, 1, H - 2)
        in_img = (z > 0.1) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        rho_proj = rho_cur[None] / torch.clamp(a + tz * rho_cur[None], min=1e-6)
        best_err = torch.full((Hn, N), BIG, device=dev)
        rho_nb = torch.zeros((Hn, N), device=dev)
        sig_nb = torch.zeros((Hn, N), device=dev)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                idx = (vi + dy) * W + (ui + dx)
                r = torch.gather(flat_rho, 1, idx)
                s = torch.gather(flat_sig, 1, idx)
                ok = (r > 0.0) & (s > 0.0)
                err = torch.where(ok, torch.abs(r - rho_proj), torch.full_like(r, BIG))
                better = err < best_err
                best_err = torch.where(better, err, best_err)
                rho_nb = torch.where(better, r, rho_nb)
                sig_nb = torch.where(better, s, sig_nb)
        hit = in_img & (best_err < BIG * 0.5)
        return rho_proj, rho_nb, sig_nb, hit

    rho_proj, rho_nb, sig_nb, hit = project_lookup(rho)
    chi2 = (rho_nb - rho_proj) ** 2 / torch.clamp(sig_nb, min=1e-9) ** 2
    agree = hit & (chi2 < 3.84)
    n_support = agree.sum(0)
    keep = valid & (n_support >= min_support)

    rho_cur = rho
    for _ in range(n_gn):
        rho_p, r_nb, s_nb, _ = project_lookup(rho_cur)
        denom = torch.clamp(a + tz * rho_cur[None], min=1e-6)
        J = a / (denom * denom)
        w = torch.where(agree, 1.0 / torch.clamp(s_nb, min=1e-9) ** 2, torch.zeros_like(s_nb))
        r = rho_p - r_nb
        num = (w * J * r).sum(0)
        den = (w * J * J).sum(0)
        step = torch.where(den > 1e-12, num / torch.clamp(den, min=1e-12), torch.zeros_like(den))
        new = torch.clamp(rho_cur - step, 1e-4, 1e3)
        rho_cur = torch.where(keep, new, rho_cur)
    return rho_cur, keep, n_support


def rasterize_depth(uv, rho, sigma, valid, height: int, width: int, dilate: int = 1):
    """Sparse fused pixels -> dense inverse-depth and sigma maps [H, W] (0 =
    none), each pixel stamped into its (2 dilate + 1)^2 neighbourhood, the
    centre last. Where stamps collide the last write wins, in the
    reference's order (offset by offset, pixel by pixel), as XLA's CPU
    scatter applies them."""
    dev = uv.device
    N = uv.shape[0]
    HW = height * width
    ui = _round_index(uv[:, 0], dilate, width - 1 - dilate)
    vi = _round_index(uv[:, 1], dilate, height - 1 - dilate)
    offs = [(dy, dx) for dy in range(-dilate, dilate + 1) for dx in range(-dilate, dilate + 1)
            if (dy, dx) != (0, 0)] + [(0, 0)]
    tgt = torch.stack([torch.where(valid, (vi + dy) * width + (ui + dx),
                                   torch.full_like(ui, HW)) for dy, dx in offs])  # [O, N]
    order = torch.arange(tgt.numel(), device=dev).reshape(tgt.shape)
    last = torch.full((HW + 1,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, tgt.reshape(-1), order.reshape(-1), "amax")
    dest = torch.where((last[tgt] == order) & (tgt < HW), tgt, torch.full_like(tgt, HW))
    maps = []
    for val in (rho, sigma):
        out = torch.zeros(HW + 1, device=dev)
        out[dest.reshape(-1)] = val.expand(len(offs), N).reshape(-1)
        maps.append(out[:HW].reshape(height, width))
    return maps[0], maps[1]


def sweep_and_fuse(cam: Camera, imgs: torch.Tensor, Ts: torch.Tensor, depth_ranges,
                   neighbors: Sequence[Sequence[int]], sd: SemiDenseConfig = SemiDenseConfig(),
                   n_pix: int = 8192, n_depth: int = 64):
    """Pass 1 of ``semidense_reconstruct``: per keyframe the edge pixels,
    one sweep against each neighbour and the fused hypotheses. Returns
    (pixels [K, N, 2], rho [K, N], sigma [K, N], valid [K, N])."""
    fp32_solvers()
    grads = _gradients(imgs)
    out_px, out_rho, out_sig, out_val = [], [], [], []
    for k in range(len(imgs)):
        uv, pxv = select_edge_pixels(imgs[k], n_pix, sd.lambda_g)
        z_lo, z_hi = float(depth_ranges[k][0]), float(depth_ranges[k][1])
        rho_min = torch.tensor(1.0 / max(z_hi, 1e-3), dtype=torch.float32, device=imgs.device)
        rho_max = torch.tensor(1.0 / max(z_lo, 1e-3), dtype=torch.float32, device=imgs.device)
        nbs = torch.as_tensor(list(neighbors[k]), dtype=torch.int64, device=imgs.device)
        r, s, o, _ = _sweep(cam, tuple(g[k] for g in grads), tuple(g[nbs] for g in grads),
                            Ts[k], Ts[nbs], uv, pxv, rho_min, rho_max, sd, n_depth)
        rho_f, sig_f, val = fuse_hypotheses(r.T, s.T, o.T, sd.lambda_n)
        out_px.append(uv)
        out_rho.append(rho_f)
        out_sig.append(sig_f)
        out_val.append(val & pxv)
    return (torch.stack(out_px), torch.stack(out_rho), torch.stack(out_sig),
            torch.stack(out_val))


def cross_check(cam: Camera, Ts: torch.Tensor, neighbors, px, rho, sigma, valid,
                height: int, width: int, min_support: int = None):
    """Pass 2 of ``semidense_reconstruct``: every keyframe's fused depths
    rasterized, then each keyframe checked and refined against its
    neighbours' maps. The gate is the reference's lambdaN = 3 of covisN = 7
    neighbours (include/ProbabilityMapping.h:45,50), scaled to the actual
    neighbour count unless ``min_support`` is given. Returns (rho, valid)."""
    maps = [rasterize_depth(px[k], rho[k], sigma[k], valid[k], height, width)
            for k in range(len(px))]
    rho_maps = torch.stack([m[0] for m in maps])
    sig_maps = torch.stack([m[1] for m in maps])
    new_rho, new_val = [], []
    for k in range(len(px)):
        nbs = list(neighbors[k])
        ms = min_support if min_support is not None else max(1, round(len(nbs) * 3 / 7))
        idx = torch.as_tensor(nbs, dtype=torch.int64, device=px.device)
        rho_k, keep_k, _ = inter_kf_check(cam, px[k], rho[k], valid[k], Ts[k], Ts[idx],
                                          rho_maps[idx], sig_maps[idx], min_support=ms)
        new_rho.append(rho_k)
        new_val.append(keep_k)
    return torch.stack(new_rho), torch.stack(new_val)


def backproject(cam: Camera, Ts: torch.Tensor, px: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """World points [K, N, 3] of pixels [K, N, 2] at inverse depths [K, N]
    seen from camera-from-world poses Ts [K, 3, 4]."""
    xn = torch.stack([(px[..., 0] - cam.cx) / cam.fx, (px[..., 1] - cam.cy) / cam.fy,
                      torch.ones_like(px[..., 0])], -1)
    Xc = xn / torch.clamp(rho, min=1e-6)[..., None]
    return se3.apply(se3.inverse(Ts)[:, None], Xc)


def semidense_reconstruct(cam: Camera, images, poses, depth_ranges, neighbors,
                          sd: SemiDenseConfig = SemiDenseConfig(), n_pix: int = 8192,
                          n_depth: int = 64, inter_kf: bool = True, min_support: int = None,
                          device=None) -> SemiDenseResult:
    """Offline semi-dense pass over keyframes (SemiDenseLoop,
    src/ProbabilityMapping.cc:348-597): images [K, H, W] float32, poses
    [K, 3, 4] camera-from-world, depth_ranges [K, 2] (z_min, z_max) priors,
    each keyframe's neighbour indices. Pass 1 ``sweep_and_fuse``, pass 2
    (``inter_kf`` and K >= 2) ``cross_check``, then the world points. Runs
    on ``device`` (the card unless the caller asks for the CPU)."""
    fp32_solvers()
    dev = resolve_device(device)
    imgs = torch.as_tensor(np.asarray(images, np.float32), device=dev)
    Ts = torch.as_tensor(np.asarray(poses, np.float32), device=dev)
    px, rho, sig, val = sweep_and_fuse(cam, imgs, Ts, depth_ranges, neighbors, sd, n_pix, n_depth)
    if inter_kf and len(imgs) >= 2:
        rho, val = cross_check(cam, Ts, neighbors, px, rho, sig, val, imgs.shape[1],
                               imgs.shape[2], min_support)
    return SemiDenseResult(pixels=px, inv_depth=rho, sigma=sig, valid=val,
                           points_w=backproject(cam, Ts, px, rho))


def save_obj(path: str, result: SemiDenseResult, sigma_max: float = 0.05) -> int:
    """The fused cloud as a Wavefront .obj point set (``v x y z`` rows,
    SaveSemiDensePoints, src/ProbabilityMapping.cc:136-192): valid points
    with sigma under ``sigma_max``. Returns the point count."""
    pts = result.points_w.detach().cpu().numpy().reshape(-1, 3)
    val = result.valid.detach().cpu().numpy().reshape(-1)
    sig = result.sigma.detach().cpu().numpy().reshape(-1)
    keep = val & (sig < sigma_max)
    with open(path, "w") as f:
        for p in pts[keep]:
            f.write(f"v {p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n")
    return int(keep.sum())
