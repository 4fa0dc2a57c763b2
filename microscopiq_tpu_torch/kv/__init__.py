"""KV caches (dense, quantized, H2O, sink) and the GEAR/KIVI codecs."""

from .cache import (DenseDecodeCache, DenseKVState, QuantizedDecodeCache,
                    QuantKVConfig, QuantKVState, init_dense_cache,
                    init_quant_cache)
from .config import CompressionConfig
from .gear import (compress_insert, fake_channel_group_quant,
                   fake_dense_sparse_quant, fake_token_group_quant,
                   fake_uniform_quant, gearl_channel_quant, gearl_token_quant,
                   gears_channel_quant, gears_token_quant,
                   gearsl_channel_quant, gearsl_token_quant,
                   pack_4bit_halves, power_iteration_lowrank,
                   true_gear_compress, true_gear_decompress,
                   true_outlier_compress, true_outlier_decompress,
                   true_poweriteration, true_uniform_compress,
                   true_uniform_compress_batchwise, true_uniform_decompress,
                   true_uniform_decompress_batchwise, unpack_4bit_halves)
from .h2o import (H2OCache, H2OKVState, QuantH2OCache, QuantH2OKVState,
                  init_h2o_cache, init_quant_h2o_cache)
from .sink import SinkDecodeCache, SinkKVState, init_sink_cache

__all__ = [
    "DenseDecodeCache", "DenseKVState", "QuantizedDecodeCache",
    "QuantKVConfig", "QuantKVState", "init_dense_cache", "init_quant_cache",
    "CompressionConfig", "compress_insert", "fake_channel_group_quant",
    "fake_dense_sparse_quant", "fake_token_group_quant",
    "fake_uniform_quant", "gearl_channel_quant", "gearl_token_quant",
    "gears_channel_quant", "gears_token_quant", "gearsl_channel_quant",
    "gearsl_token_quant", "pack_4bit_halves", "power_iteration_lowrank",
    "true_gear_compress", "true_gear_decompress", "true_outlier_compress",
    "true_outlier_decompress", "true_poweriteration",
    "true_uniform_compress", "true_uniform_compress_batchwise",
    "true_uniform_decompress", "true_uniform_decompress_batchwise",
    "unpack_4bit_halves", "H2OCache", "H2OKVState", "QuantH2OCache",
    "QuantH2OKVState", "init_h2o_cache", "init_quant_h2o_cache",
    "SinkDecodeCache", "SinkKVState", "init_sink_cache",
]
