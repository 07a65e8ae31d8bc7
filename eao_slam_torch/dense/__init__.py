"""The offline dense phase: semi-dense inverse depth, 3D line segments and
the TSDF surface mesh (the reference's ``dense/`` package)."""

from eao_slam_torch.dense.semidense import SemiDenseResult, semidense_reconstruct

__all__ = ["SemiDenseResult", "semidense_reconstruct"]
