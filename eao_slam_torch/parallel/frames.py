"""Frame-parallel ORB extraction over the ranks.

The front end is independent frame by frame: each rank extracts its
contiguous block of a chunk's frames with the full pyramid / FAST /
BRIEF pipeline (``ops.orb.extract_orb``), and the feature arrays are
all-gathered in frame order (one collective over the integer bits of
every field, so each frame's features are the extracting rank's own,
bit for bit). The tracking that consumes them stays sequential in time
and runs replicated on every rank.
"""

from __future__ import annotations

import torch

from eao_slam_torch.ops.orb import Features, extract_orb
from eao_slam_torch.parallel.distributed import Mesh, all_gather_blocks, block_range, line_mesh

FRAME_AXIS = "frames"


def make_frame_mesh(device=None) -> Mesh:
    """The one-axis ("frames") mesh over every rank."""
    return line_mesh(FRAME_AXIS, device)


def frame_block(mesh: Mesh, n_frames: int) -> tuple:
    """[lo, hi) of the frames this rank extracts."""
    return block_range(n_frames, mesh.axis_size(), mesh.axis_index())


def frame_block_len(mesh: Mesh, n_frames: int, index: int) -> int:
    """The frames rank ``index`` extracts."""
    lo, hi = block_range(n_frames, mesh.axis_size(), index)
    return hi - lo


def gather_features(feats: Features, mesh: Mesh, n_frames: int) -> Features:
    """Every rank's block of per-frame features [c, F, ...] -> the whole
    chunk's [n_frames, F, ...] on every rank, in one collective: the
    fields' bits packed into one int32 buffer."""
    counts = [frame_block_len(mesh, n_frames, i) for i in range(mesh.axis_size())]
    parts = [feats.kp.contiguous().view(torch.int32),
             feats.desc.to(torch.int32),
             feats.octave.to(torch.int32)[..., None],
             feats.angle.contiguous().view(torch.int32)[..., None],
             feats.response.contiguous().view(torch.int32)[..., None],
             feats.valid.to(torch.int32)[..., None]]
    packed = torch.cat(parts, -1)
    allp = all_gather_blocks(packed, mesh, None, counts)
    kp = allp[..., 0:2].contiguous().view(torch.float32)
    desc = allp[..., 2:10].to(feats.desc.dtype)
    return Features(kp=kp, desc=desc, octave=allp[..., 10].to(feats.octave.dtype),
                    angle=allp[..., 11].contiguous().view(torch.float32),
                    response=allp[..., 12].contiguous().view(torch.float32),
                    valid=allp[..., 13] != 0)


def extract_batch_sharded(images: torch.Tensor, mesh: Mesh, n_features: int = 1024,
                          n_levels: int = 8, **orb) -> Features:
    """ORB features of a chunk [C, H, W] (uint8 or float32), each rank
    extracting its block of frames; every rank returns all C frames'
    features in frame order. ``orb``: further ``extract_orb`` settings."""
    C = images.shape[0]
    if C < mesh.axis_size():
        raise ValueError(f"{C} frames for {mesh.axis_size()} ranks: each rank needs a frame")
    lo, hi = frame_block(mesh, C)
    mine = extract_orb(images[lo:hi].to(torch.float32), n_features=n_features,
                       n_levels=n_levels, **orb)
    return gather_features(mine, mesh, C)
