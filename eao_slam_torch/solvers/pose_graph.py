"""Essential-graph Sim(3) optimization for monocular loop closing.

The reference package's ``solvers/pose_graph.py`` on tensors: per-keyframe
Sim3 vertices, edges for the temporal chain, strong covisibility and the
loop, and a dense damped Gauss-Newton over [7K] with per-edge Jacobians
from autodiff of the retraction, batched over the edges. float32 throughout
with TF32 off; the normal equations are summed in float64 so that the
order of the scatter's additions cannot move the float32 result.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eao_slam_torch.device import fp32_solvers
from eao_slam_torch.geometry import sim3


class PoseGraphProblem(NamedTuple):
    vertices: torch.Tensor     # [K, 8] Sim3 world->camera per keyframe
    v_fixed: torch.Tensor      # [K] bool (the loop-anchor keyframe)
    v_valid: torch.Tensor      # [K] bool
    edge_i: torch.Tensor       # [E] int
    edge_j: torch.Tensor       # [E] int
    edge_meas: torch.Tensor    # [E, 8] measured S_ji = S_j * S_i^-1
    edge_valid: torch.Tensor   # [E] bool
    edge_weight: torch.Tensor  # [E] f32


def edge_residual(Si: torch.Tensor, Sj: torch.Tensor, Sji: torch.Tensor) -> torch.Tensor:
    """r = log(S_ji_meas * S_i * S_j^-1) in the Sim3 tangent [7]."""
    return sim3.log(sim3.compose(Sji, sim3.compose(Si, sim3.inverse(Sj))))


def _edge_jacobians(Si, Sj, Sji):
    """Residuals [E, 7] and their Jacobians [E, 7, 7] wrt both endpoint
    tangents (at zero)."""
    def f(xi, xj):
        return edge_residual(sim3.retract(Si, xi), sim3.retract(Sj, xj), Sji)

    z = torch.zeros(Si.shape[:-1] + (7,), dtype=Si.dtype, device=Si.device)
    r, (Ji, Jj) = sim3.row_jacobians(f, (z, z), (0, 1))
    return r, Ji, Jj


def optimize_essential_graph(prob: PoseGraphProblem, iters: int = 20):
    """Gauss-Newton with LM damping over all Sim3 vertices. Returns
    ([K, 8] optimized vertices, final cost)."""
    fp32_solvers()
    K = prob.vertices.shape[0]
    dev = prob.vertices.device
    ei, ej = prob.edge_i.long(), prob.edge_j.long()
    w = prob.edge_valid.to(torch.float32) * prob.edge_weight
    free = ((~prob.v_fixed) & prob.v_valid).to(torch.float32)
    eye7 = torch.eye(7, dtype=torch.float32, device=dev)
    ar = torch.arange(K, device=dev)

    def cost_of(verts):
        r = edge_residual(verts[ei], verts[ej], prob.edge_meas)
        return (w * (r * r).sum(-1)).sum()

    def seg_sum(n_rows, idx, x):
        out = torch.zeros((n_rows,) + x.shape[1:], dtype=torch.float64, device=dev)
        return out.index_add_(0, idx, x.to(torch.float64)).to(torch.float32)

    verts = prob.vertices
    lam = torch.tensor(1e-6, dtype=torch.float32, device=dev)
    for _ in range(iters):
        r, Ji, Jj = _edge_jacobians(verts[ei], verts[ej], prob.edge_meas)
        wb = w[:, None, None]
        blocks = torch.cat([wb * torch.einsum("eki,ekj->eij", Ji, Ji),
                            wb * torch.einsum("eki,ekj->eij", Jj, Jj),
                            wb * torch.einsum("eki,ekj->eij", Ji, Jj),
                            wb * torch.einsum("eki,ekj->eij", Jj, Ji)])
        rows = torch.cat([ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei])
        H = seg_sum(K * K, rows, blocks).reshape(K, K, 7, 7)
        b = seg_sum(K, torch.cat([ei, ej]),
                    torch.cat([w[:, None] * torch.einsum("eki,ek->ei", Ji, r),
                               w[:, None] * torch.einsum("eki,ek->ei", Jj, r)]))

        # gauge / mask: fixed vertices become identity rows
        H = H * (free[:, None] * free[None, :])[..., None, None]
        H[ar, ar] += (1.0 - free)[:, None, None] * eye7[None]
        b = b * free[:, None]

        Hd = H.permute(0, 2, 1, 3).reshape(7 * K, 7 * K)
        Hd = Hd + lam * torch.diag(torch.diagonal(Hd)) + 1e-8 * torch.eye(7 * K, device=dev)
        dx = -torch.linalg.solve_ex(Hd, b.reshape(-1))[0].reshape(K, 7)
        dx = dx * free[:, None]
        nrm = torch.linalg.norm(dx, dim=-1, keepdim=True)
        dx = dx * torch.clamp(1.0 / torch.clamp(nrm, min=1e-12), max=1.0)

        new_verts = sim3.retract(verts, dx)
        accept = cost_of(new_verts) < cost_of(verts)
        verts = torch.where(accept, new_verts, verts)
        lam = torch.clamp(torch.where(accept, lam * 0.25, lam * 8.0), 1e-10, 1e3)
    return verts, cost_of(verts)
