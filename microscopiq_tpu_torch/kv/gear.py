"""GEAR / KIVI KV-cache quantization codecs in PyTorch.

Counterpart of ``microscopiq_tpu/kv/gear.py``: the simulated (fake-quant)
codecs (per-token and per-channel group quant, whole-tensor uniform,
dense + sparse outliers, GEAR-L, GEAR-S, GEAR-SL and the
``compress_insert`` dispatcher) and the true-compression codecs (packed
uint8 codes, the top-k outlier side-band, QR power iteration, GEAR
compress/decompress and the batchwise variants). Tensors follow the
reference layout (batch, num_heads, seq_len, head_dim).

These are the reference codecs of the standalone module; the quantized
decode cache keeps its own chunk codecs (``kv/cache.py``), whose semantics
differ.

Two choices differ from the JAX functions and are not semantics:

* the power iterations start from ``torch.rand`` of a CPU generator seeded
  7 (:func:`lowrank_start`) where JAX draws ``jax.random.uniform`` of
  ``PRNGKey(7)``. The start is made on the CPU, so the card and the CPU
  begin from the same one. QR may
  pick other column signs than ``jnp.linalg.qr``; the low-rank product
  ``q @ p^T`` does not depend on them, the factors do;
* top-k takes a stable descending sort, so among equal values the lower
  index wins, on the CPU and on the card alike.

Scales divide by 2^bits - 1 held in a tensor on the data's device
(:func:`_levels`), as eager JAX divides: PyTorch on CUDA multiplies by the
reciprocal of a Python-number divisor, which moves a scale by an ulp and
flips the rounding of codes that sit on a half step (common on bf16 data).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


# ---------------------------------------------------------------------------
# Simulated (fake-quant) codecs
# ---------------------------------------------------------------------------
def _levels(bits: int, like: torch.Tensor) -> torch.Tensor:
    """2^bits - 1 as a float32 tensor on ``like``'s device: a true divisor
    on every device."""
    return torch.full((), 2 ** bits - 1, dtype=torch.float32,
                      device=like.device)


def _group_dequant(g: torch.Tensor, dim: int, bits: int) -> torch.Tensor:
    """Asymmetric min/max quantize-dequantize of f32 groups along ``dim``."""
    mx = g.amax(dim, keepdim=True)
    mn = g.amin(dim, keepdim=True)
    scale = (mx - mn) / _levels(bits, g)
    q = torch.clamp((g - mn) / scale, min=0.0)
    return torch.round(q) * scale + mn


def _token_major(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) -> (B, S, H * D) float32."""
    B, H, S, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B, S, H * D).to(torch.float32)


def _from_token_major(xt: torch.Tensor, shape) -> torch.Tensor:
    B, H, S, D = shape
    return xt.reshape(B, S, H, D).permute(0, 2, 1, 3)


def fake_token_group_quant(x: torch.Tensor, bits: int, group_size: int = 128
                           ) -> torch.Tensor:
    """Per-token asymmetric group quant: groups tile the flattened
    head * dim axis of each token."""
    B, H, S, D = x.shape
    if (H * D) % group_size != 0:
        raise ValueError("group_size must divide num_heads*head_dim")
    g = _token_major(x).reshape(B, S, (H * D) // group_size, group_size)
    deq = _group_dequant(g, -1, bits)
    return _from_token_major(deq, x.shape).to(x.dtype)


def fake_channel_group_quant(x: torch.Tensor, bits: int,
                             group_size: int = 128) -> torch.Tensor:
    """Per-channel group quant over groups of ``group_size`` tokens;
    seq_len must divide by group_size."""
    B, H, S, D = x.shape
    if S % group_size != 0:
        raise ValueError("group_size must divide seq_len")
    g = _token_major(x).reshape(B, S // group_size, group_size, H * D)
    deq = _group_dequant(g, -2, bits)
    return _from_token_major(deq, x.shape).to(x.dtype)


def fake_uniform_quant(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Whole-tensor asymmetric quant."""
    flat = x.reshape(-1).to(torch.float32)
    mn, mx = flat.min(), flat.max()
    step = (mx - mn) / _levels(bits, flat)
    deq = torch.round((flat - mn) / step) * step + mn
    return deq.reshape(x.shape).to(x.dtype)


def fake_dense_sparse_quant(x: torch.Tensor, bits: int, left: float
                            ) -> torch.Tensor:
    """Uniform quant that keeps the ``left`` fraction of extreme values
    exactly."""
    flat = x.reshape(-1).to(torch.float32)
    k = int(flat.shape[0] * left / 2)
    if k == 0:
        return fake_uniform_quant(x, bits)
    order = torch.argsort(flat, stable=True)
    keep = torch.cat([order[:k], order[-k:]])
    inner = flat[order[k:-k]]
    mn, mx = inner.min(), inner.max()
    step = (mx - mn) / _levels(bits, flat)
    deq = torch.round((flat - mn) / step) * step + mn
    deq[keep] = flat[keep]
    return deq.reshape(x.shape).to(x.dtype)


def lowrank_start(batch: int, features: int, rank: int,
                  device) -> torch.Tensor:
    """The power iteration's start: U[0, 1) of a CPU generator seeded 7,
    (batch, features, rank) float32 on ``device``."""
    gen = torch.Generator().manual_seed(7)
    return torch.rand((batch, features, rank), generator=gen).to(device)


def _power_iteration(err: torch.Tensor, loop: int, rank: int):
    """(p (B, H*D, rank), q (B, S, rank)) of the (B, H, S, D) error, with
    e ~= q @ p^T: ``loop`` steps, QR on the last."""
    B, H, S, D = err.shape
    e = _token_major(err)
    p = lowrank_start(B, H * D, rank, e.device)
    q = None
    for i in range(loop):
        if i == loop - 1:
            p = torch.linalg.qr(p).Q
        q = e @ p
        if i == loop - 1:
            q = torch.linalg.qr(q).Q
        p = e.transpose(1, 2) @ q
    return p, q


def power_iteration_lowrank(err: torch.Tensor, loop: int, rank: int
                            ) -> torch.Tensor:
    """Rank-``rank`` approximation of the (B, H, S, D) error by batched
    power iteration with a final QR."""
    p, q = _power_iteration(err, loop, rank)
    approx = q @ p.transpose(1, 2)
    return _from_token_major(approx, err.shape).to(err.dtype)


def _plus_lowrank(x, out, rank, loop):
    err = x.to(torch.float32) - out.to(torch.float32)
    return (out.to(torch.float32)
            + power_iteration_lowrank(err, loop, rank)).to(x.dtype)


def gearl_token_quant(x, bits, group_size=128, rank=2, loop=3):
    """GEAR-L, token variant: group quant plus low-rank error."""
    return _plus_lowrank(x, fake_token_group_quant(x, bits, group_size),
                         rank, loop)


def gearl_channel_quant(x, bits, group_size=128, rank=2, loop=3):
    return _plus_lowrank(x, fake_channel_group_quant(x, bits, group_size),
                         rank, loop)


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis; ties go to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _scatter_last(x, idx, val):
    return x.scatter(-1, idx, val.to(x.dtype))


def _outlier_rows(xt: torch.Tensor, k: int, quant):
    """GEAR-S on rows of xt (..., n): the k smallest and k largest values
    of each row become the row's mean, ``quant`` runs on the cleaned rows,
    then the extremes are put back exactly."""
    sval, sidx = _top_k(-xt, k)
    sval = -sval
    lval, lidx = _top_k(xt, k)
    mean = xt.mean(-1, keepdim=True).expand(xt.shape)
    cleaned = _scatter_last(xt, sidx, torch.gather(mean, -1, sidx))
    cleaned = _scatter_last(cleaned, lidx, torch.gather(mean, -1, lidx))
    qt = quant(cleaned)
    qt = _scatter_last(qt, sidx, sval)
    return _scatter_last(qt, lidx, lval)


def gears_token_quant(x, bits, group_size=128, sparsity=0.02):
    """GEAR-S, token variant: extreme values of each token replaced by the
    mean before quantization and restored exactly after."""
    B, H, S, D = x.shape
    k = int(B * H * S * D * sparsity / (B * S) / 2)
    if k == 0:
        return fake_token_group_quant(x, bits, group_size)

    def quant(cleaned):
        q = fake_token_group_quant(_from_token_major(cleaned, x.shape),
                                   bits, group_size)
        return _token_major(q)

    return _from_token_major(_outlier_rows(_token_major(x), k, quant),
                             x.shape).to(x.dtype)


def gears_channel_quant(x, bits, group_size=128, sparsity=0.02):
    B, H, S, D = x.shape
    k = int(B * H * S * D * sparsity / (B * S) / 2)
    if k == 0:
        return fake_channel_group_quant(x, bits, group_size)
    to_rows = lambda t: t.transpose(2, 3).reshape(B, H * D, S).to(
        torch.float32)
    from_rows = lambda r: r.reshape(B, H, D, S).transpose(2, 3)

    def quant(cleaned):
        return to_rows(fake_channel_group_quant(from_rows(cleaned), bits,
                                                group_size))

    return from_rows(_outlier_rows(to_rows(x), k, quant)).to(x.dtype)


def gearsl_token_quant(x, bits, group_size=128, sparsity=0.02, rank=2,
                       loop=3):
    """GEAR (S + L): outliers kept, group quant, low-rank error."""
    return _plus_lowrank(x, gears_token_quant(x, bits, group_size, sparsity),
                         rank, loop)


def gearsl_channel_quant(x, bits, group_size=128, sparsity=0.02, rank=2,
                         loop=3):
    return _plus_lowrank(x, gears_channel_quant(x, bits, group_size,
                                                sparsity), rank, loop)


def compress_insert(key_states: torch.Tensor, value_states: torch.Tensor,
                    config, layer_idx: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the configured codec of ``layer_idx`` to the [start,
    -locality) token window of K and V; ``config`` is a per-layer
    :class:`CompressionConfig` (``copy_for_all_attention``)."""
    B, H, S, D = key_states.shape
    method = config.compress_method[layer_idx]
    bits = config.quantize_bit[layer_idx]
    group = config.group_size[layer_idx]
    if config.token_preserving[layer_idx]:
        start = int(config.start_saving[layer_idx] * S)
        loc = int(config.locality_saving[layer_idx] * S)
    else:
        start, loc = 0, -S
    sl = slice(start, -loc if loc > 0 else None)

    def apply(codec, x, *a, window=sl):
        out = x.clone()
        out[:, :, window] = codec(x[:, :, window], *a)
        return out

    if method == "channelQfixed":
        key_states = apply(fake_channel_group_quant, key_states, bits, S)
        value_states = apply(fake_channel_group_quant, value_states, bits, S)
    elif method == "tokenQfixed":
        key_states = apply(fake_token_group_quant, key_states, bits, H * D)
        value_states = apply(fake_token_group_quant, value_states, bits,
                             H * D)
    elif method == "kcvtQfixed":
        key_states = apply(fake_channel_group_quant, key_states, bits, S)
        value_states = apply(fake_token_group_quant, value_states, bits,
                             H * D)
    elif method == "KIVI":
        key_states = apply(fake_channel_group_quant, key_states, bits, group)
        value_states = apply(fake_token_group_quant, value_states, bits,
                             group)
    elif method == "GEARL-KIVI":
        rank, loop = config.rank[layer_idx], config.loop[layer_idx]
        key_states = apply(gearl_channel_quant, key_states, bits, group,
                           rank, loop)
        value_states = apply(gearl_token_quant, value_states, bits, group,
                             rank, loop)
    elif method == "GEARS-KIVI":
        sp = config.left[layer_idx]
        key_states = apply(gears_channel_quant, key_states, bits, group, sp)
        value_states = apply(gears_token_quant, value_states, bits, group,
                             sp)
    elif method == "Flexgen":
        res = S % group
        whole = slice(0, -res if res > 0 else None)
        key_states = apply(fake_channel_group_quant, key_states, bits, group,
                           window=whole)
        value_states = apply(fake_channel_group_quant, value_states, bits,
                             group, window=whole)
    elif method is None or method == "None":
        pass
    else:
        raise ValueError(f"unknown compress_method {method}")
    return key_states, value_states


# ---------------------------------------------------------------------------
# True compression (packed storage)
# ---------------------------------------------------------------------------
class CompressedTensor(NamedTuple):
    """Packed uint8 codes (4-bit: halves-packed) and their metadata."""
    codes: torch.Tensor
    shape: tuple
    mn: torch.Tensor
    scale: torch.Tensor
    bits: int


def pack_4bit_halves(u8: torch.Tensor) -> torch.Tensor:
    """First half of the flat array in the low nibble, second half in the
    high nibble."""
    half = u8.shape[0] // 2
    return (u8[:half] + u8[half:] * 16).to(torch.uint8)


def unpack_4bit_halves(packed: torch.Tensor) -> torch.Tensor:
    return torch.cat([packed % 16, packed // 16], 0)


def true_uniform_compress(x: torch.Tensor, bits: int) -> CompressedTensor:
    if bits not in (8, 4):
        raise ValueError("quantize_bit should be 8 or 4")
    flat = x.reshape(-1).to(torch.float32)
    mn, mx = flat.min(), flat.max()
    scale = (mx - mn) / _levels(bits, flat)
    q = torch.round((flat - mn) / scale).to(torch.uint8)
    if bits == 4:
        q = pack_4bit_halves(q)
    return CompressedTensor(q, tuple(x.shape), mn, scale, bits)


def true_uniform_decompress(c: CompressedTensor, dtype=torch.float32
                            ) -> torch.Tensor:
    q = unpack_4bit_halves(c.codes) if c.bits == 4 else c.codes
    return (q.to(torch.float32) * c.scale + c.mn).reshape(c.shape).to(dtype)


class GearCompressed(NamedTuple):
    base: CompressedTensor
    out_values: torch.Tensor
    out_indices: torch.Tensor     # int32, flat
    p: torch.Tensor               # (B, H*D, rank) float16
    q: torch.Tensor               # (B, S, rank) float16


def _flat_outliers(flat: torch.Tensor, k: int):
    """(values, int32 flat indices) of the k smallest then the k largest,
    and ``flat`` with them zeroed."""
    sval, sidx = _top_k(-flat, k)
    lval, lidx = _top_k(flat, k)
    vals = torch.cat([-sval, lval])
    idxs = torch.cat([sidx, lidx])
    flat = flat.clone()
    flat[idxs] = 0
    return vals, idxs.to(torch.int32), flat


def true_outlier_compress(x: torch.Tensor, bits: int, left: float):
    """(uniform codes, values, indices) with the ``left`` fraction of
    extremes kept aside."""
    flat = x.reshape(-1)
    vals, idxs, flat = _flat_outliers(flat, int(flat.shape[0] * left / 2))
    return true_uniform_compress(flat.reshape(x.shape), bits), vals, idxs


def true_outlier_decompress(base: CompressedTensor, vals, idxs,
                            dtype=torch.float32) -> torch.Tensor:
    x = true_uniform_decompress(base, dtype).reshape(-1)
    x[idxs.long()] = vals.to(x.dtype)
    return x.reshape(base.shape)


def true_poweriteration(err: torch.Tensor, loop: int, rank: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(p, q) bases, float16, of the (B, H, S, D) error."""
    p, q = _power_iteration(err, loop, rank)
    return p.to(torch.float16), q.to(torch.float16)


def true_gear_compress(x: torch.Tensor, bits: int, left: float, rank: int,
                       loop: int) -> GearCompressed:
    """Uniform codes, the outlier side-band and low-rank bases of the
    quantization error."""
    flat = x.reshape(-1)
    k = int(flat.shape[0] * left / 2)
    if k > 0:
        vals, idxs, flat = _flat_outliers(flat, k)
    else:
        vals = torch.zeros((0,), dtype=x.dtype, device=x.device)
        idxs = torch.zeros((0,), dtype=torch.int32, device=x.device)
    cleaned = flat.reshape(x.shape)
    base = true_uniform_compress(cleaned, bits)
    err = (cleaned.to(torch.float32)
           - true_uniform_decompress(base).to(torch.float32))
    if k > 0:
        err = err.reshape(-1)
        err[idxs.long()] = 0.0
        err = err.reshape(x.shape)
    p, q = true_poweriteration(err, loop, rank)
    return GearCompressed(base, vals, idxs, p, q)


def true_gear_decompress(g: GearCompressed, dtype=torch.float32
                         ) -> torch.Tensor:
    x = true_uniform_decompress(g.base, torch.float32).reshape(-1)
    if g.out_values.shape[0] > 0:
        x[g.out_indices.long()] = g.out_values.to(torch.float32)
    err = g.q.to(torch.float32) @ g.p.to(torch.float32).transpose(1, 2)
    err = _from_token_major(err, g.base.shape)
    return (x.reshape(g.base.shape) + err).to(dtype)


def true_uniform_compress_batchwise(x: torch.Tensor, bits: int):
    """Per-batch-element min and scale."""
    B = x.shape[0]
    flat = x.reshape(B, -1).to(torch.float32)
    mn = flat.amin(-1, keepdim=True)
    mx = flat.amax(-1, keepdim=True)
    scale = (mx - mn) / _levels(bits, flat)
    q = torch.round((flat - mn) / scale).to(torch.uint8)
    if bits == 4:
        half = q.shape[1] // 2
        q = (q[:, :half] + q[:, half:] * 16).to(torch.uint8)
    return CompressedTensor(q, tuple(x.shape), mn, scale, bits)


def true_uniform_decompress_batchwise(c: CompressedTensor,
                                      dtype=torch.float32) -> torch.Tensor:
    q = c.codes
    if c.bits == 4:
        q = torch.cat([q % 16, q // 16], 1)
    return (q.to(torch.float32) * c.scale + c.mn).reshape(c.shape).to(dtype)
