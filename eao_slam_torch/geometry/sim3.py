"""Sim(3) similarity transforms (R, t, s) for monocular loop closing.

A Sim3 is a (..., 8) float32 tensor [q(wxyz), t(xyz), log_s]: log-scale so
that tangent updates are additive. Same layout and formulas as the
reference package's ``geometry/sim3.py``.
"""

from __future__ import annotations

import torch

from eao_slam_torch.geometry import so3


def make(R: torch.Tensor, t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    q = so3.mat_to_quat(R)
    return torch.cat([q, t, torch.log(s)[..., None]], -1)


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([1, 0, 0, 0, 0, 0, 0, 0], dtype=dtype, device=device)


def rot(S: torch.Tensor) -> torch.Tensor:
    return so3.quat_to_mat(S[..., :4])


def trans(S: torch.Tensor) -> torch.Tensor:
    return S[..., 4:7]


def scale(S: torch.Tensor) -> torch.Tensor:
    return torch.exp(S[..., 7])


def _mv(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (M @ x[..., None])[..., 0]


def apply(S: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x' = s * R @ x + t (broadcasting over leading axes)."""
    return scale(S)[..., None] * _mv(rot(S), x) + trans(S)


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(A*B)(x) = A(B(x))."""
    q = so3.quat_mul(A[..., :4], B[..., :4])
    t = scale(A)[..., None] * _mv(rot(A), trans(B)) + trans(A)
    return torch.cat([q, t, (A[..., 7] + B[..., 7])[..., None]], -1)


def inverse(S: torch.Tensor) -> torch.Tensor:
    Rt = rot(S).transpose(-1, -2)
    s_inv = torch.exp(-S[..., 7])
    t = -s_inv[..., None] * _mv(Rt, trans(S))
    return torch.cat([so3.mat_to_quat(Rt), t, -S[..., 7:8]], -1)


def from_se3(T: torch.Tensor, s=1.0) -> torch.Tensor:
    s = torch.as_tensor(s, dtype=T.dtype, device=T.device).expand(T.shape[:-2])
    return make(T[..., :3, :3], T[..., :3, 3], s)


def to_se3(S: torch.Tensor) -> torch.Tensor:
    """Drop scale into translation, [R, t/s] -> (..., 3, 4)."""
    t = trans(S) / scale(S)[..., None]
    return torch.cat([rot(S), t[..., None]], -1)


def exp(v: torch.Tensor) -> torch.Tensor:
    """Tangent (..., 7) = (rho, omega, sigma) -> Sim3, first-order V (the
    pose-graph LM needs a retraction only)."""
    q = so3.mat_to_quat(so3.exp(v[..., 3:6]))
    return torch.cat([q, v[..., :3], v[..., 6:7]], -1)


def retract(S: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative retraction: exp(v) * S."""
    return compose(exp(v), S)


def log(S: torch.Tensor) -> torch.Tensor:
    """Inverse of ``exp`` above (first-order translation part)."""
    return torch.cat([trans(S), so3.log(rot(S)), S[..., 7:8]], -1)


def row_jacobians(f, primals, argnums):
    """Residuals r = f(*primals) [..., M] and their Jacobians [..., M, D]
    with respect to each ``primals[a]`` [..., D], a in argnums, where
    r[i] depends on the primals' row i only (one edge, one point): one
    reverse pass per residual component gives that component's row of
    every block at once. (Forward-mode dual tensors and ``torch.func``
    give the same derivatives, but the first runs each elementwise op with
    a Python scalar through a Python decomposition, ~0.4 ms an op, and the
    second promotes such tangents of 0-dim values to float64.)"""
    with torch.enable_grad():
        xs = [p.detach().requires_grad_(i in argnums) for i, p in enumerate(primals)]
        r = f(*xs)
        M = r.shape[-1]
        rows = [torch.autograd.grad(r[..., m].sum(), [xs[a] for a in argnums],
                                    retain_graph=m < M - 1, allow_unused=True)
                for m in range(M)]
    jac = []
    for i, a in enumerate(argnums):
        cols = [g[i] if g[i] is not None else torch.zeros_like(xs[a]) for g in rows]
        jac.append(torch.stack(cols, -2))
    return r.detach(), jac
