"""Posit number system (vectorized codec)."""

from .posit import (Posit, decode_posit, encode_posit, posit_add, posit_div,
                    posit_mul, posit_sigmoid, posit_sub, posit_table,
                    quantize_posit)

__all__ = ["Posit", "decode_posit", "encode_posit", "posit_add", "posit_div",
           "posit_mul", "posit_sigmoid", "posit_sub", "posit_table",
           "quantize_posit"]
