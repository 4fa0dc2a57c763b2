"""The MX layer library (fake-quant layers with straight-through quantized
backward passes) and the parameter-tree transforms; the counterpart of
``microscopiq_tpu/nn``."""

from .activations import (GELU, LeakyReLU, ReLU, ReLU6, Sigmoid, SiLU, Tanh,
                          gelu, leaky_relu, relu, relu6, sigmoid, silu, tanh)
from .conv import (Conv2d, adaptive_avg_pool2d, conv1d, conv2d, conv3d,
                   conv_transpose2d)
from .functional import ste_elemwise, ste_mx, ste_mx_outlier
from .linear import MXLinear, QuantizedLinear, bmm, linear, matmul, mx_linear
from .mapping import (find_linear_params, fuse_projections, mx_op_table,
                      pack_params, quantize_params)
from .norms import BatchNorm, GroupNorm, LayerNorm, RMSNorm
from .rnn import LSTM, LSTMCell
from .simd_ops import (simd_add, simd_div, simd_exp, simd_log, simd_mul,
                       simd_norm, simd_reduce_mean, simd_reduce_sum,
                       simd_split, simd_sqrt, simd_square, simd_sub)
from .softmax import Softmax, softmax
from .vector_ops import (vec_div, vec_exp, vec_exp2, vec_recip, vec_sqrt,
                         vec_tanh)

__all__ = [
    "GELU", "LeakyReLU", "ReLU", "ReLU6", "Sigmoid", "SiLU", "Tanh", "gelu",
    "leaky_relu", "relu", "relu6", "sigmoid", "silu", "tanh", "Conv2d",
    "adaptive_avg_pool2d", "conv1d", "conv2d", "conv3d", "conv_transpose2d",
    "ste_elemwise", "ste_mx", "ste_mx_outlier", "MXLinear",
    "QuantizedLinear", "bmm", "linear", "matmul", "mx_linear",
    "find_linear_params", "fuse_projections", "mx_op_table", "pack_params",
    "quantize_params", "BatchNorm", "GroupNorm", "LayerNorm", "RMSNorm",
    "LSTM", "LSTMCell", "simd_add", "simd_div", "simd_exp", "simd_log",
    "simd_mul", "simd_norm", "simd_reduce_mean", "simd_reduce_sum",
    "simd_split", "simd_sqrt", "simd_square", "simd_sub", "Softmax",
    "softmax", "vec_div", "vec_exp", "vec_exp2", "vec_recip", "vec_sqrt",
    "vec_tanh",
]
