from .observability import (Metrics, achieved_bandwidth, assert_bandwidth,
                            decode_token_stats, device_busy_us,
                            device_kernel_stats, metrics, trace)
from .profiling import (analyze_outliers, format_mse_profile,
                        profile_model_outliers)

__all__ = ["Metrics", "achieved_bandwidth", "analyze_outliers",
           "assert_bandwidth", "decode_token_stats", "device_busy_us",
           "device_kernel_stats", "format_mse_profile", "metrics",
           "profile_model_outliers", "trace"]
