"""Surface reconstruction: TSDF fusion + marching tetrahedra.

The port of the reference's ``dense/mesh.py`` (its replacement for the
CARV carving of src/CARV/): each keyframe's semi-dense depth is densified
and fused into a truncated signed distance field over a regular voxel
grid, and the zero level set is extracted by marching tetrahedra (6
tetrahedra a cell, the case table derived as the reference derives it) in
x-slabs, so that peak memory is one slab's intermediates.

The views are fused one after another, in the reference's order, so the
sums round as the reference's scan rounds them. The truncations to the
slab budget and to ``max_tris`` keep the valid triangles in order, with a
stable sort as ``jnp.argsort`` is.
"""

from __future__ import annotations

import numpy as np
import torch

from eao_slam_torch.device import fp32_solvers
from eao_slam_torch.geometry import se3
from eao_slam_torch.geometry.camera import Camera
from eao_slam_torch.ops.image import max_filter3

# the 6 tetrahedra decomposing a cube, as corner indices of the cube's 8
# vertices (corner k = (k&1, (k>>1)&1, (k>>2)&1) in (x, y, z)); all share
# the main diagonal 0-6
_TETS = np.asarray([
    [0, 5, 1, 6], [0, 1, 3, 6], [0, 3, 2, 6],
    [0, 2, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6],
], np.int32)
_CORNER_OFF = np.asarray([[k & 1, (k >> 1) & 1, (k >> 2) & 1] for k in range(8)], np.int32)
_EDGES = np.asarray([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]])


def _case_table() -> np.ndarray:
    """[16, 2, 3] edge triples of each tetrahedron sign pattern (-1: none)."""
    tri_table = np.full((16, 2, 3), -1, np.int64)
    edge_of = {(a, b): e for e, (a, b) in enumerate(map(tuple, _EDGES))}
    edge_of.update({(b, a): e for (a, b), e in list(edge_of.items())})
    for case in range(16):
        ins = [v for v in range(4) if case >> v & 1]
        outs = [v for v in range(4) if not case >> v & 1]
        if len(ins) == 1:
            tri_table[case, 0] = [edge_of[(ins[0], o)] for o in outs]
        elif len(ins) == 3:
            tri_table[case, 0] = [edge_of[(outs[0], i)] for i in ins]
        elif len(ins) == 2:
            a, b = ins
            c, d = outs
            quad = [edge_of[(a, c)], edge_of[(a, d)], edge_of[(b, d)], edge_of[(b, c)]]
            tri_table[case, 0] = [quad[0], quad[1], quad[2]]
            tri_table[case, 1] = [quad[0], quad[2], quad[3]]
    return tri_table


_TRI_TABLE = _case_table()


def densify_depth(px: torch.Tensor, rho: torch.Tensor, valid: torch.Tensor, height: int,
                  width: int, dilate: int = 2) -> torch.Tensor:
    """Sparse semi-dense samples -> dense depth map [H, W] (0 = unknown):
    the largest depth per pixel, then ``dilate`` rounds that fill empty
    pixels with their 3x3 neighbourhood's maximum."""
    xi = torch.clamp(px[:, 0].to(torch.int64), 0, width - 1)
    yi = torch.clamp(px[:, 1].to(torch.int64), 0, height - 1)
    z = torch.where(valid & (rho > 1e-6), 1.0 / torch.clamp(rho, min=1e-6),
                    torch.zeros_like(rho))
    zmap = torch.zeros(height * width, device=px.device).scatter_reduce(
        0, yi * width + xi, z, "amax").reshape(height, width)
    for _ in range(dilate):
        zmap = torch.where(zmap > 0, zmap, max_filter3(zmap))
    return zmap


def tsdf_fuse(cam: Camera, depth_maps: torch.Tensor, poses: torch.Tensor, origin: torch.Tensor,
              voxel, nx: int = 96, ny: int = 96, nz: int = 96, trunc_factor: float = 4.0):
    """Fuse depth maps [K, H, W] (0 = unknown) seen from poses [K, 3, 4]
    into (tsdf [nx, ny, nz], weight [nx, ny, nz]) over the grid at
    ``origin`` [3] with float32 ``voxel`` (a 0-dim tensor): each voxel
    seen in front of or up to ``trunc_factor`` voxels behind a view's
    surface takes that view's truncated distance, averaged over views."""
    fp32_solvers()
    K, H, W = depth_maps.shape
    dev = depth_maps.device
    voxel = torch.as_tensor(voxel, dtype=torch.float32, device=dev)
    trunc = trunc_factor * voxel
    ii, jj, kk = torch.meshgrid(torch.arange(nx, device=dev), torch.arange(ny, device=dev),
                                torch.arange(nz, device=dev), indexing="ij")
    Xw = origin[None, :] + voxel * torch.stack(
        [ii.reshape(-1), jj.reshape(-1), kk.reshape(-1)], -1).to(torch.float32)
    V = Xw.shape[0]
    tsdf = torch.zeros(V, device=dev)
    wsum = torch.zeros(V, device=dev)
    for k in range(K):
        xc = se3.apply(poses[k], Xw)
        z = xc[:, 2]
        zc = torch.clamp(z, min=1e-6)
        u = cam.fx * xc[:, 0] / zc + cam.cx
        v = cam.fy * xc[:, 1] / zc + cam.cy
        ui = torch.clamp(u, 0, W - 1).to(torch.int64)
        vi = torch.clamp(v, 0, H - 1).to(torch.int64)
        d = depth_maps[k][vi, ui]
        ok = (z > 0.1) & (u >= 0) & (u < W) & (v >= 0) & (v < H) & (d > 0)
        sdf = d - z
        w = (ok & (sdf > -trunc)).to(torch.float32)
        sdf_t = torch.clamp(sdf, -trunc, trunc) / trunc
        tsdf = tsdf + w * sdf_t
        wsum = wsum + w
    tsdf = torch.where(wsum > 0, tsdf / torch.clamp(wsum, min=1e-9), torch.ones_like(tsdf))
    return tsdf.reshape(nx, ny, nz), wsum.reshape(nx, ny, nz)


def _valid_first(valid: torch.Tensor, budget: int) -> torch.Tensor:
    """Indices of ``jnp.argsort(~valid)[:budget]``: the valid entries in
    order, then the invalid ones (a stable sort)."""
    return torch.argsort((~valid).to(torch.uint8), stable=True)[:budget]


def marching_tetrahedra(tsdf: torch.Tensor, weight: torch.Tensor, origin: torch.Tensor, voxel,
                        min_weight: float = 2.0, max_tris: int = 200_000, n_slabs: int = 16):
    """Zero level set of ``tsdf`` as triangles: (tris [T, 3, 3], valid
    [T]), T = min(max_tris, n_slabs x max_tris). Cells whose 8 corners all
    carry ``min_weight`` are cut into 6 tetrahedra; the cells go through in
    ``n_slabs`` x-slabs, each keeping its first ``max_tris`` valid
    triangles, and the slabs' valid triangles are kept in order up to
    ``max_tris``."""
    dev = tsdf.device
    voxel = torch.as_tensor(voxel, dtype=torch.float32, device=dev)
    nx, ny, nz = tsdf.shape
    cx, cy, cz = nx - 1, ny - 1, nz - 1
    pad = (-cx) % n_slabs
    if pad:
        tsdf = torch.cat([tsdf, torch.ones((pad, ny, nz), device=dev)], 0)
        weight = torch.cat([weight, torch.zeros((pad, ny, nz), device=dev)], 0)
    sx = (cx + pad) // n_slabs
    off = torch.as_tensor(_CORNER_OFF, dtype=torch.int64, device=dev)
    tets = torch.as_tensor(_TETS, dtype=torch.int64, device=dev)
    E = torch.as_tensor(_EDGES, dtype=torch.int64, device=dev)
    tri_tab = torch.as_tensor(_TRI_TABLE, device=dev)
    bits = torch.as_tensor([1, 2, 4, 8], dtype=torch.int64, device=dev)
    x_step = torch.as_tensor([sx, 0, 0], dtype=torch.int64, device=dev)
    ii, jj, kk = torch.meshgrid(torch.arange(sx, device=dev), torch.arange(cy, device=dev),
                                torch.arange(cz, device=dev), indexing="ij")
    cells = torch.stack([ii.reshape(-1), jj.reshape(-1), kk.reshape(-1)], -1)   # [C, 3]
    C = cells.shape[0]
    bidx = (torch.arange(C * 6, device=dev) * 6).reshape(C, 6, 1, 1)

    slab_tris, slab_valid = [], []
    for s in range(n_slabs):
        base = cells + s * x_step
        corner = base[:, None, :] + off[None]                           # [C, 8, 3]
        f = tsdf[corner[..., 0], corner[..., 1], corner[..., 2]]
        wgt = weight[corner[..., 0], corner[..., 1], corner[..., 2]]
        pos = origin[None, None, :] + voxel * corner.to(torch.float32)
        cell_ok = (wgt >= min_weight).all(1)
        fv = f[:, tets]                                                 # [C, 6, 4]
        pv = pos[:, tets]                                               # [C, 6, 4, 3]
        inside = fv < 0.0
        fa = fv[..., E[:, 0]]
        fb = fv[..., E[:, 1]]
        t = fa / torch.where(torch.abs(fa - fb) < 1e-12, torch.full_like(fa, 1e-12), fa - fb)
        pa = pv[:, :, E[:, 0], :]
        pb = pv[:, :, E[:, 1], :]
        pe = pa + t[..., None] * (pb - pa)                              # [C, 6, 6, 3]
        code = (inside.to(torch.int64) * bits).sum(-1)
        tcase = tri_tab[code]                                           # [C, 6, 2, 3]
        tvalid = (tcase[..., 0] >= 0) & cell_ok[:, None, None]
        esafe = torch.clamp(tcase, 0, 5)
        tris = pe.reshape(-1, 3)[(bidx + esafe).reshape(-1)].reshape(-1, 3, 3)
        tvalid = tvalid.reshape(-1)
        take = _valid_first(tvalid, max_tris)
        slab_tris.append(tris[take])
        slab_valid.append(tvalid[take])
    tris = torch.cat(slab_tris)
    tvalid = torch.cat(slab_valid)
    take = _valid_first(tvalid, max_tris)
    return tris[take], tvalid[take]


def extract_mesh(cam: Camera, result, poses, height: int, width: int, n_voxels: int = 96,
                 margin: float = 0.2):
    """Semi-dense result -> (tris [T, 3, 3] numpy, T): the grid spans the
    fused cloud's 2nd to 98th percentiles plus ``margin`` (host numpy, as
    the reference), then densify, fuse and extract on the result's
    device."""
    dev = result.points_w.device
    pts = result.points_w.detach().cpu().numpy().reshape(-1, 3)
    val = result.valid.detach().cpu().numpy().reshape(-1)
    if val.sum() < 100:
        return np.zeros((0, 3, 3), np.float32), 0
    P = pts[val]
    lo = np.percentile(P, 2, axis=0) - margin
    hi = np.percentile(P, 98, axis=0) + margin
    voxel = np.float32((hi - lo).max() / (n_voxels - 1))
    origin = torch.as_tensor(np.asarray(lo, np.float32), device=dev)
    dms = torch.stack([densify_depth(result.pixels[k], result.inv_depth[k], result.valid[k],
                                     height, width) for k in range(len(poses))])
    tsdf, w = tsdf_fuse(cam, dms, torch.as_tensor(np.asarray(poses, np.float32), device=dev),
                        origin, voxel, nx=n_voxels, ny=n_voxels, nz=n_voxels)
    tris, tv = marching_tetrahedra(tsdf, w, origin, voxel)
    tris = tris[tv].cpu().numpy()
    return tris, len(tris)


def save_mesh_obj(path: str, tris: np.ndarray) -> int:
    """Triangle soup .obj (Model export, src/Modeler.cc:77): three ``v``
    rows and one ``f`` row per triangle. Returns the count."""
    with open(path, "w") as f:
        for t in tris:
            for v in t:
                f.write(f"v {v[0]:.5f} {v[1]:.5f} {v[2]:.5f}\n")
        for i in range(len(tris)):
            f.write(f"f {3*i+1} {3*i+2} {3*i+3}\n")
    return len(tris)
