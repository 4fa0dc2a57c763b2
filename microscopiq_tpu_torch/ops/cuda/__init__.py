"""Hand-written CUDA kernels for Hopper (``sm_90a``), built with ``nvcc`` on
first use and bound with ``ctypes`` (see :mod:`.build`); the wrappers and
their plain twins are in :mod:`.dequant_matmul` (GEMV, GEMM, W8A8 GEMV),
:mod:`.outlier_matmul`, :mod:`.quant_attention` and :mod:`.mx_quant`."""
