from eao_slam_torch.utils.profiling import StageProfiler, annotate, device_trace

__all__ = ["StageProfiler", "annotate", "device_trace"]
