"""PyTorch + CUDA port of the monocular object-SLAM engine.

Chunked tracking, in geometry mode (DemoFlag.NONE) and with the EAO object
layer (DemoFlag.EAO and its ablations), runs from raw uint8 images (and
detector boxes) to per-frame poses and object landmarks on one NVIDIA
GPU. The dense FAST-9/16 + 3x3 NMS + packing stage is a hand-written CUDA
kernel (csrc/fast_nms.cu); every other stage is plain PyTorch on tensors.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Without a CUDA device and without an explicit ``device="cpu"`` they raise.
"""

from eao_slam_torch.device import resolve_device

__all__ = ["resolve_device"]
