"""The parallel layer: process groups and meshes (``distributed``), the
distributed bundle adjusters (``dist_ba``, ``dist_ba2``), frame-parallel
extraction (``frames``) and many sequences at once (``multi_seq``), over
``torch.distributed`` with one rank per card."""

from eao_slam_torch.parallel.dist_ba import distributed_bundle_adjust, make_ba_mesh

__all__ = ["distributed_bundle_adjust", "make_ba_mesh"]
