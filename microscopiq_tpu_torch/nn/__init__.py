from .mapping import (find_linear_params, fuse_projections, pack_params,
                      quantize_params)
from .norms import RMSNorm

__all__ = ["find_linear_params", "fuse_projections", "pack_params",
           "quantize_params", "RMSNorm"]
