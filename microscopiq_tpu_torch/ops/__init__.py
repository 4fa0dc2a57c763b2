"""MX codec, packing and the serving-path kernels."""

from .elemwise import (exp2_exact, floor_log2, mul_pow2, quantize_bfloat,
                       quantize_elemwise, quantize_elemwise_core,
                       quantize_elemwise_op, quantize_fp)
from .mx import (quantize_mx, quantize_mx_op, reshape_to_blocks,
                 shared_exponents)
from .packing import (PackedMX, dequantize_mx, from_serving_layout, pack_fp4,
                      pack_fp6, pack_int2, pack_int4, pack_mx,
                      to_serving_layout, unpack_fp4, unpack_fp6, unpack_int2,
                      unpack_int4)

__all__ = [
    "exp2_exact", "floor_log2", "mul_pow2", "quantize_bfloat",
    "quantize_elemwise", "quantize_elemwise_core", "quantize_elemwise_op",
    "quantize_fp", "quantize_mx", "quantize_mx_op", "reshape_to_blocks",
    "shared_exponents", "PackedMX", "dequantize_mx", "from_serving_layout",
    "pack_fp4", "pack_fp6", "pack_int2", "pack_int4", "pack_mx",
    "to_serving_layout", "unpack_fp4", "unpack_fp6", "unpack_int2",
    "unpack_int4",
]
