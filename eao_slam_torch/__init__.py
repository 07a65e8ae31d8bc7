"""PyTorch + CUDA port of the monocular object-SLAM engine.

Chunked tracking, in geometry mode (DemoFlag.NONE), with the EAO object
layer (DemoFlag.EAO and its ablations) and with line-alignment yaw
(DemoFlag.LINE_IFOREST), runs from raw uint8 images (and detector boxes)
to per-frame poses and object landmarks on one NVIDIA GPU; DemoFlag.FULL
adds the offline dense phase at shutdown (dense/: semi-dense depth, 3D
lines, a TSDF mesh). The dense FAST-9/16 + 3x3 NMS + packing stage is a
hand-written CUDA kernel (csrc/fast_nms.cu); every other stage is plain
PyTorch on tensors.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Without a CUDA device and without an explicit ``device="cpu"`` they raise.
"""

from eao_slam_torch.device import resolve_device

__all__ = ["resolve_device"]
