from eao_slam_torch.utils.profiling import TRACER, StageProfiler

__all__ = ["TRACER", "StageProfiler"]
