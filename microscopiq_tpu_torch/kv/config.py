"""KV-cache compression configuration: plain Python, a copy of
``microscopiq_tpu/kv/config.py``.

Its parity target: ``kv_quant/GEARLM/Simulated/compress_config.py`` —
per-layer knob lists broadcast via ``copy_for_all_attention`` (:63-85) and
the analytic compression-ratio calculator (:87-281).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class CompressionConfig:
    compress_method: Optional[str] = None
    attention_number: int = 32
    quantize_bit: int = 4
    group_size: int = 64
    rank: float = 0.0
    rankv: float = 0.0
    loop: int = 3
    left: float = 0.0            # outlier fraction (GEAR-S)
    top_k: float = 0.0
    stage: int = 1
    device_num: int = 0
    batch_num: int = 1
    start_saving: float = 0.0
    locality_saving: float = 0.0
    token_preserving: bool = False
    streaming: bool = False
    streaming_gap: int = 0

    def __post_init__(self):
        self._scalar = {f.name: getattr(self, f.name)
                        for f in dataclasses.fields(self)}
        self._per_layer = False

    def copy_for_all_attention(self):
        """Broadcast every scalar knob to a per-layer list
        (compress_config.py:63-85)."""
        n = self.attention_number
        for f in dataclasses.fields(self):
            if f.name == "attention_number":
                continue
            setattr(self, f.name, [self._scalar[f.name]] * n)
        self._per_layer = True
        return self

    def compress_ratio(self, seq_len: int = 2048, model_dim: int = 4096
                       ) -> float:
        """Analytic bytes ratio vs fp16 KV (compress_config.py:87-281 /
        avg_cache.py:1-40)."""
        method = (self.compress_method[0] if self._per_layer
                  else self.compress_method)
        bits = (self.quantize_bit[0] if self._per_layer
                else self.quantize_bit)
        rank = self.rank[0] if self._per_layer else self.rank
        left = self.left[0] if self._per_layer else self.left
        group = self.group_size[0] if self._per_layer else self.group_size
        if method is None:
            return 1.0
        base = bits / 16.0
        # per-group (min, scale) fp16 metadata
        meta = 2 * 16.0 / (group * 16.0) if group else 0.0
        lowrank = 0.0
        if rank:
            r = int(rank * model_dim) if rank < 1 else int(rank)
            lowrank = r * (seq_len + model_dim) * 16.0 / (
                seq_len * model_dim * 16.0)
        sparse = left * (16 + 32) / 16.0  # fp16 value + int32 index
        return base + meta + lowrank + sparse

    def __getitem__(self, key):
        return getattr(self, key)
