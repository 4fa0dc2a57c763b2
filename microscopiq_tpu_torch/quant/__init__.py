"""Calibration: the GPTQ engine, its quantizer configs and the
layer-sequential driver; the vector quantizer is ``quant.vq``."""

from .gptq import GPTQ
from .quantizer import MXQuantizer, UniformQuantizer, quantize_uniform

__all__ = ["GPTQ", "MXQuantizer", "UniformQuantizer", "quantize_uniform"]
