"""Quantized-KV decode attention: the CUDA kernel's wrappers, their plain
PyTorch twins, and the decode attention built on them.

Counterpart of ``microscopiq_tpu/ops/pallas/quant_attention.py``:
``chunk_attention`` stands for ``_chunk_attention`` (the Pallas
``_chunk_kernel``), ``residual_attention`` for ``_residual_attention``, and
``quant_attention_decode`` / ``quant_attention_decode_reference`` keep
their names. On the card one launch of ``csrc/quant_attention.cu`` computes
a layer's whole decode attention (the split of the length, the chunks, the
residual window, the combine and the normalisation); ``chunk_attention``
runs the same kernel without the residual window and returns the
unnormalised flash state.

Tensors on the CPU go to the plain twins (``chunk_attention_reference``,
and for the decode the chunks' twin, ``residual_attention`` and the flash
combine in plain PyTorch, as JAX composes them). Tensors on a CUDA device
go to the kernel or raise: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from ...kv.cache import _dequant_k, _dequant_v, _per
from . import build

NEG_INF = -1e30
# limits of csrc/quant_attention.cu: head_dim a multiple of 32 up to 256,
# up to 16 query rows a KV head (8 when hd > 128), the shared memory of one
# block on the H100
MAX_HEAD_DIM = 256
MAX_REP = 16
MAX_SMEM_BYTES = 227 * 1024
_WARPS = 4                        # kWarps: consumer warps of a block
MAX_STAGES = 4                    # kMaxStages: ring stages, a chunk each
MAX_SPLITS = 32                   # kMaxSplits: CTAs of a (b, g)
MAX_SLOTS = 8                     # kMaxSlots: chunks' scaled q made ahead
# chunks a split aims at: the Llama-3-8B decode at B = 4 (C = 51) then runs
# 4 x 8 x 11 CTAs, one wave at three an SM of an H100; the splits of a
# (b, g) stop short of ~4 CTAs an SM for one batch row
_SPLIT_CHUNKS = 5
_TARGET_CTAS = 4 * 132

# launches of the kernel wrapper, for showing that a run went through the
# kernel; chip_smoke.py zeroes them before the main path and reads them after
launch_counts = {"quant_attention": 0}

_ptr, _int = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_ptr] * 19 + [_int] * 21 + [ctypes.c_float, _ptr]
# the kernel's split scratch (f32) and (b, g) counters (int32), by device:
# every buffer ever made is kept (a captured CUDA graph holds its address),
# the last of each the current one; the counters are zero between launches
# (the last CTA of a (b, g) resets its)
_scratch: dict = {}
_BITS_OF_PER = {1: 8, 2: 4, 4: 2}
# dtype -> the kernel's Kind (q, the residual window, the output)
_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _up(v: int, a: int) -> int:
    return -(-v // a) * a


def stage_bytes(hd: int, gap: int, bits: int, Gh: int) -> int:
    """One ring stage of ``csrc/quant_attention.cu`` (``Stage``), in bytes:
    a chunk's K and V codes, its K scales and offsets, its V scales and
    offsets (16-byte aligned), rounded to 128."""
    codes = gap // _per(bits) * hd
    vs = _up(4 * gap * Gh, 16)
    return _up(2 * codes + 8 * hd + 2 * vs, 128)


def frag_rows(rep: int) -> int:
    """Query rows of a flash state in the kernel's mma fragment layout: 8
    or 16 (``frag_rows``)."""
    return 16 if rep > 8 else 8


def smem_bytes(rep: int, hd: int, gap: int, bits: int, Gh: int,
               stages: int = 1, slots: int = 2) -> int:
    """Shared memory of one kernel block, in bytes (``Smem``): 128 bytes of
    alignment slack and 128 of barriers, q as rep rows of hd + 4 floats,
    the scaled-q fragments of ``slots`` chunks (frag_rows x hd x 4 bytes
    each) and their q . k_mn (64 bytes each, to a multiple of 128), q as
    the caller holds it (up to f32, to a multiple of 128) and the slots' K
    scales and offsets (8 hd bytes each),
    then the larger of the ring (``stages`` stages)
    and the merge area (the warps' flash states in the fragment layout,
    their and the block's (m, l), the residual window's logits and the
    splits' weights). Mirrored here so that the route is chosen on any
    device; the card tests hold it to ``quant_attention_smem_bytes``."""
    fr = frag_rows(rep)
    merge = 4 * (_WARPS * fr * hd + (2 * _WARPS + 2 * MAX_SPLITS + 7) * rep
                 + rep * gap)
    scratch = (128 + _up(4 * rep * (hd + 4), 128) + slots * fr * hd * 4
               + _up(slots * 64, 128) + _up(4 * rep * hd, 128)
               + 8 * slots * hd)
    return 128 + scratch + max(stages * stage_bytes(hd, gap, bits, Gh),
                               merge)


def _geometry_fault(hd: int, rep: int, gap: int, bits: int, Gh: int
                    ) -> Optional[str]:
    """Why the kernel does not take this geometry, or None."""
    if hd % 32 or not 32 <= hd <= MAX_HEAD_DIM:
        return f"head_dim {hd} is not a multiple of 32 up to {MAX_HEAD_DIM}"
    max_rep = MAX_REP if hd <= 128 else MAX_REP // 2
    if rep > max_rep:
        return (f"{rep} query heads per KV head exceed {max_rep} at "
                f"head_dim {hd}")
    if bits not in _BITS_OF_PER.values() or gap % _per(bits):
        return f"bits {bits} with gap {gap}"
    if Gh < 1 or hd % Gh:
        return f"{Gh} V groups do not divide head_dim {hd}"
    smem = smem_bytes(rep, hd, gap, bits, Gh)
    if smem > MAX_SMEM_BYTES:
        return (f"gap {gap} x head_dim {hd} at {bits} bits needs {smem} "
                f"bytes of shared memory, over {MAX_SMEM_BYTES}")
    return None


def decode_route(hd: int, rep: int, gap: int, bits: int, v_group: int,
                 rank: int = 0) -> str:
    """The decode attention of a quantized KV cache of this geometry:
    ``"fused"``, the kernel (:func:`quant_attention_decode`), where it
    takes the head_dim ``hd``, ``rep`` query heads per KV head, the
    cache's gap, bits and V group (any low-rank ``rank``: the kernel reads
    the bases from device memory); else ``"update"``, ``cache.update`` and
    the model's own attention. Chosen from the config and shapes alone,
    before the launch, the same on every device; the kernel's operand
    checks share its limits."""
    Gh = hd // min(v_group, hd)
    fault = _geometry_fault(hd, rep, gap, bits, Gh)
    return "fused" if fault is None else "update"


def chunk_splits(C: int, KVH: int) -> Tuple[int, int]:
    """(nsplit, chunks per split) of the kernel's chunk axis: splits of
    about _SPLIT_CHUNKS chunks, at most MAX_SPLITS of them, fewer where KVH
    alone puts ~_TARGET_CTAS blocks on the card.

    Depends only on (C, KVH), never on the batch, so that a slot's result
    is the same in a batch of any size.
    """
    want = max(1, min(MAX_SPLITS, -(-C // _SPLIT_CHUNKS),
                      -(-_TARGET_CTAS // KVH)))
    cps = max(1, -(-C // want))
    return max(1, -(-C // cps)), cps


@functools.lru_cache(maxsize=None)
def attention_plan(C: int, KVH: int, rep: int, hd: int, gap: int, bits: int,
                   Gh: int) -> dict:
    """The launch plan of a geometry the kernel takes: ``nsplit`` and
    ``cps`` (:func:`chunk_splits`); ``slots``, the chunks whose scaled q
    the block makes ahead (cps where it is at most MAX_SLOTS and fits,
    else 2: each chunk's as it lands); ``stages`` (as many as fit beside
    them, up to MAX_STAGES and cps), ``stage_bytes`` and
    ``smem_bytes``."""
    nsplit, cps = chunk_splits(C, KVH)
    fits = lambda st, sl: smem_bytes(rep, hd, gap, bits, Gh, st,  # noqa
                                     sl) <= MAX_SMEM_BYTES
    slots = cps if 2 <= cps <= MAX_SLOTS and fits(1, cps) else 2
    stages = min(MAX_STAGES, cps)
    while stages > 1 and not fits(stages, slots):
        stages -= 1
    return {"nsplit": nsplit, "cps": cps, "stages": stages, "slots": slots,
            "stage_bytes": stage_bytes(hd, gap, bits, Gh),
            "smem_bytes": smem_bytes(rep, hd, gap, bits, Gh, stages,
                                     slots)}


def chunk_attention_reference(q, kq, kmn, ksc, vq, vmn, vsc, nfull, scale,
                              gap: int, bits: int, lowrank=None):
    """Plain twin of the kernel: dequantize every chunk, attend over the
    folded ones. q (B, KVH, rep, hd) is read as bf16, as the kernel reads it.
    Returns the unnormalised (o (B, KVH, rep, hd), m, l (B, KVH, rep, 1)) in
    f32; a slot with nfull = 0 gives o = 0, m = -1e30, l = 0."""
    B, KVH, _, hd = q.shape
    C = kq.shape[2]
    Gh = vsc.shape[-1]
    qf = q.to(torch.bfloat16).to(torch.float32)
    k = _dequant_k(kq, kmn, ksc, torch.float32, bits)
    v = _dequant_v(vq, vmn, vsc, hd // Gh, torch.float32, bits)
    if lowrank is not None:
        kp, kqb, vp, vqb = lowrank
        k = k + torch.einsum("bcrg,bkcrd->bkcgd", kqb.to(torch.float32),
                             kp.to(torch.float32))
        v = v + torch.einsum("bcrg,bkcrd->bkcgd", vqb.to(torch.float32),
                             vp.to(torch.float32))
    k = k.reshape(B, KVH, C * gap, hd)
    v = v.reshape(B, KVH, C * gap, hd)
    nfull = torch.as_tensor(nfull, device=q.device).reshape(-1).expand(B)
    chunk_of = torch.arange(C * gap, device=q.device) // gap
    valid = (chunk_of[None, :] < nfull[:, None])[:, None, None, :]
    logits = torch.einsum("bgrd,bgtd->bgrt", qf, k) * scale
    logits = torch.where(valid, logits, NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m) * valid
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bgrt,bgtd->bgrd", p, v)
    return o, m, l


def _check_cache(q, kq, kmn, ksc, vq, vmn, vsc, gap, bits, lowrank,
                 extra=()) -> Tuple[int, int]:
    """Raise on chunk operands the kernel does not take (q (B, KVH, rep,
    hd) of any dtype: the callers check it); returns (rank, lr_f32)."""
    dev = q.device
    ops = [q, kq, kmn, ksc, vq, vmn, vsc, *extra] + list(lowrank or ())
    if not all(t.is_cuda and t.device == dev for t in ops):
        raise ValueError("all operands must be on one CUDA device")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("operands must be contiguous")
    B, KVH, rep, hd = q.shape
    Gh = vsc.shape[-1]
    fault = _geometry_fault(hd, rep, gap, bits, Gh)
    if fault is not None:
        raise ValueError(fault)
    C = kq.shape[2]
    codes = (B, KVH, C, gap // _per(bits), hd)
    for name, t in (("kq", kq), ("vq", vq)):
        if t.dtype != torch.uint8 or tuple(t.shape) != codes:
            raise ValueError(f"{name} must be uint8 {codes}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t in (("k_mn", kmn), ("k_sc", ksc)):
        if t.dtype != torch.float32 or tuple(t.shape) != (B, KVH, C, hd):
            raise ValueError(f"{name} must be f32 {(B, KVH, C, hd)} (one K "
                             f"group per chunk), got {tuple(t.shape)}")
    for name, t in (("v_mn", vmn), ("v_sc", vsc)):
        if (t.dtype != torch.float32
                or tuple(t.shape) != (B, KVH, C, gap, Gh)):
            raise ValueError(f"{name} must be f32 (B, KVH, C, gap, Gh), got "
                             f"{tuple(t.shape)}")
    # the kernel bulk-copies codes and K scales (16-byte aligned sources)
    if any(t.data_ptr() % 16 for t in (kq, vq, kmn, ksc)):
        raise ValueError("kq, vq, k_mn and k_sc must be 16-byte aligned")
    if lowrank is None:
        return 0, 0
    kp, kqb, vp, vqb = lowrank
    rank = kp.shape[-2]
    lr_dtype = kp.dtype
    if lr_dtype not in (torch.bfloat16, torch.float32) or not all(
            t.dtype == lr_dtype for t in lowrank):
        raise ValueError("low-rank bases must all be bf16 or all f32")
    for name, t, shape in (("k_p", kp, (B, KVH, C, rank, hd)),
                           ("v_p", vp, (B, KVH, C, rank, hd)),
                           ("k_q", kqb, (B, C, rank, gap)),
                           ("v_q", vqb, (B, C, rank, gap))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    return rank, int(lr_dtype == torch.float32)


def _split_scratch(dev: torch.device, floats: int, counters: int):
    """(scratch, counters) for a launch on ``dev``: f32 scratch of at least
    ``floats`` and zeroed int32 counters of at least ``counters``, cached
    (and kept) per device. They are made outside any CUDA graph capture
    (zeroing the counters is a kernel that capture would only record)."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    kept = _scratch.setdefault(key, {"ws": [], "cnt": []})
    for name, size, make in (("ws", floats, torch.empty),
                             ("cnt", counters, torch.zeros)):
        if not kept[name] or kept[name][-1].numel() < size:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("quant_attention: run the call once "
                                   "outside CUDA graph capture first, to "
                                   "make its scratch")
            kept[name].append(make(size, device=dev, dtype=torch.float32
                                   if name == "ws" else torch.int32))
    return kept["ws"][-1], kept["cnt"][-1]


def _launch(q, kq, kmn, ksc, vq, vmn, vsc, lowrank, rank, lr_f32, gap,
            bits, scale, length, res, out, m_out=None, l_out=None) -> None:
    """One launch of the kernel. ``length``: the (B,) folded chunks when
    ``res`` is None (chunk_attention), else the live lengths as an int or
    an int32 tensor of () or (B,); ``res`` (res_k, res_v) the residual
    window; ``out`` the output (and m_out, l_out without a window)."""
    B, KVH, rep, hd = q.shape
    C = kq.shape[2]
    Gh = vsc.shape[-1]
    plan = attention_plan(C, KVH, rep, hd, gap, bits, Gh)
    if isinstance(length, torch.Tensor):
        len_ptr, stride, const = length.data_ptr(), int(length.dim() > 0), 0
    else:
        len_ptr, stride, const = None, 0, int(length)
    kp, kqb, vp, vqb = lowrank if lowrank is not None else (None,) * 4
    res_k, res_v = res if res is not None else (None, None)
    ws = cnt = None
    if plan["nsplit"] > 1:
        ws, cnt = _split_scratch(q.device, B * KVH * plan["nsplit"]
                                 * (rep * hd + _up(2 * rep, 4)), B * KVH)
    ptr = lambda t: None if t is None else t.data_ptr()      # noqa: E731
    err = build.entry("quant_attention", "quant_attention", _ARGTYPES)(
        q.data_ptr(), kq.data_ptr(), kmn.data_ptr(), ksc.data_ptr(),
        vq.data_ptr(), vmn.data_ptr(), vsc.data_ptr(), ptr(kp), ptr(kqb),
        ptr(vp), ptr(vqb), len_ptr, ptr(res_k), ptr(res_v), out.data_ptr(),
        ptr(m_out), ptr(l_out), ptr(ws), ptr(cnt), B, KVH, C, rep, hd, gap,
        bits, Gh, rank,
        lr_f32, plan["nsplit"], plan["cps"], plan["stages"], plan["slots"],
        plan["smem_bytes"], stride, const, int(res is not None),
        _KINDS[q.dtype], _KINDS[res_k.dtype] if res is not None else 0,
        _KINDS[out.dtype], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "quant_attention")
    launch_counts["quant_attention"] += 1


def chunk_attention(q, kq, kmn, ksc, vq, vmn, vsc, nfull, scale,
                    gap: int, bits: int, lowrank=None):
    """Partial flash state over one layer's quantized chunks.

    q (B, KVH, rep, hd) bf16; kq, vq (B, KVH, C, gap // per, hd) uint8;
    kmn, ksc (B, KVH, C, hd) f32; vmn, vsc (B, KVH, C, gap, Gh) f32;
    nfull (B,) int32 folded chunks per slot; lowrank (k_p, k_q, v_p, v_q)
    or None. Returns (o, m, l) as :func:`chunk_attention_reference`.
    """
    if q.device.type == "cpu":
        return chunk_attention_reference(q, kq, kmn, ksc, vq, vmn, vsc,
                                         nfull, scale, gap, bits, lowrank)
    rank, lr_f32 = _check_cache(q, kq, kmn, ksc, vq, vmn, vsc, gap, bits,
                                lowrank, (nfull,))
    if q.dtype != torch.bfloat16:
        raise ValueError(f"q must be bf16, got {q.dtype}")
    B, KVH, rep, hd = q.shape
    if nfull.dtype != torch.int32 or tuple(nfull.shape) != (B,):
        raise ValueError("nfull must be a (B,) int32 tensor")
    dev = q.device
    o = torch.empty((B, KVH, rep, hd), dtype=torch.float32, device=dev)
    m = torch.empty((B, KVH, rep, 1), dtype=torch.float32, device=dev)
    l = torch.empty((B, KVH, rep, 1), dtype=torch.float32, device=dev)
    _launch(q, kq, kmn, ksc, vq, vmn, vsc, lowrank, rank, lr_f32, gap, bits,
            scale, nfull, None, o, m, l)
    return o, m, l


def residual_attention(q, res_k, res_v, res_len, scale):
    """Partial flash state over the full-precision residual window.

    q (B, KVH, rep, hd); res_k, res_v (B, R, KVH, hd); res_len an int or a
    (B,) tensor. Products are summed along one axis per row (no batched
    matmul), so a slot's result does not depend on the batch size.
    """
    B, R = res_k.shape[:2]
    k = res_k.to(torch.float32).transpose(1, 2)          # (B, KVH, R, hd)
    v = res_v.to(torch.float32).transpose(1, 2)
    qf = q.to(torch.float32)
    logits = (qf[:, :, :, None, :] * k[:, :, None]).sum(-1) * scale
    res_len = torch.as_tensor(res_len, device=q.device).reshape(-1).expand(B)
    valid = (torch.arange(R, device=q.device)[None, :]
             < res_len[:, None])[:, None, None, :]
    logits = torch.where(valid, logits, NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m) * valid
    l = p.sum(-1, keepdim=True)
    o = (p[..., None] * v[:, :, None]).sum(-2)
    return o, m, l


def _layer_geometry(state_full: Sequence[torch.Tensor], q: torch.Tensor):
    kq, res_k = state_full[0], state_full[6]
    B, H, hd = q.shape
    KVH = kq.shape[2]
    gap = res_k.shape[2]                   # residual rows = streaming gap
    bits = _BITS_OF_PER[gap // kq.shape[4]]
    return B, H, hd, KVH, H // KVH, gap, bits


def quant_attention_decode(q, state_full, layer: int, length, v_group: int,
                           scale: float):
    """Decode attention over one layer of a quantized KV cache.

    q (B, H, hd): the step's queries. state_full: (kq, k_mn, k_sc, vq, v_mn,
    v_sc, res_k, res_v[, k_p, k_q, v_p, v_q]), the full (L-leading) cache
    buffers. length: live tokens including the current one, whose K/V are
    already in the residual window; an int, a 0-d tensor (every row), or
    a (B,) tensor of per-slot depths. Returns (B, H, hd) in q.dtype.

    On the card one kernel launch and nothing else (the layer's buffers are
    views); on the CPU the chunks' twin, ``residual_attention`` and the
    flash combine, as JAX composes them.
    """
    kq, kmn, ksc, vq, vmn, vsc, res_k, res_v = (b[layer]
                                                for b in state_full[:8])
    lowrank = (tuple(b[layer] for b in state_full[8:12])
               if len(state_full) >= 12 else None)
    B, H, hd, KVH, rep, gap, bits = _layer_geometry(state_full, q)
    qg = q.reshape(B, KVH, rep, hd)
    if q.device.type == "cpu":
        return _decode_plain(qg, kq, kmn, ksc, vq, vmn, vsc, res_k, res_v,
                             lowrank, length, gap, bits, scale
                             ).reshape(B, H, hd).to(q.dtype)
    if isinstance(length, torch.Tensor):
        if length.dtype != torch.int32:
            length = length.to(torch.int32)
        if length.dim() > 1 or length.numel() not in (1, B):
            raise ValueError(f"length must be () or ({B},), got "
                             f"{tuple(length.shape)}")
        length = length.reshape(-1) if length.numel() == B else length.reshape(())
    qg = qg.contiguous()
    if q.dtype not in _KINDS or res_k.dtype not in _KINDS \
            or res_v.dtype != res_k.dtype:
        raise ValueError(f"q {q.dtype} and the residual window "
                         f"{res_k.dtype} must be f32, bf16 or f16")
    extra = (res_k, res_v) + ((length,) if isinstance(length, torch.Tensor)
                              else ())
    rank, lr_f32 = _check_cache(qg, kq, kmn, ksc, vq, vmn, vsc, gap, bits,
                                lowrank, extra)
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    _launch(qg, kq, kmn, ksc, vq, vmn, vsc, lowrank, rank, lr_f32, gap, bits,
            scale, length, (res_k, res_v), out)
    return out


def _decode_plain(qg, kq, kmn, ksc, vq, vmn, vsc, res_k, res_v, lowrank,
                  length, gap: int, bits: int, scale: float):
    """The decode attention in plain PyTorch, as the JAX package composes
    it: the chunks' twin (q as bf16), the residual window (q as it is),
    the flash combine and max(l, 1e-30). Returns (B, KVH, rep, hd) f32."""
    B = qg.shape[0]
    if isinstance(length, torch.Tensor):
        # a 0-d length (the shared cache's) serves every row
        length = length.to(torch.int32).reshape(-1).expand(B)
        nfull = (length // gap).to(torch.int32)
        res_len = length - nfull * gap
    else:
        nfull = torch.full((B,), length // gap, dtype=torch.int32,
                           device=qg.device)
        res_len = length - (length // gap) * gap
    o1, m1, l1 = chunk_attention_reference(
        qg.to(torch.bfloat16), kq, kmn, ksc, vq, vmn, vsc, nfull, scale,
        gap, bits, lowrank)
    o2, m2, l2 = residual_attention(qg, res_k, res_v, res_len, scale)
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    o = o1 * a1 + o2 * a2
    l = l1 * a1 + l2 * a2
    return o / torch.clamp(l, min=1e-30)


def quant_attention_decode_reference(q, state_full, layer: int, length,
                                     v_group: int, scale: float,
                                     ) -> torch.Tensor:
    """Plain twin of :func:`quant_attention_decode`: dequantize everything,
    masked softmax attention, q in its own dtype."""
    kq, kmn, ksc, vq, vmn, vsc, res_k, res_v = (b[layer]
                                                for b in state_full[:8])
    B, H, hd, KVH, rep, gap, bits = _layer_geometry(state_full, q)
    C = kq.shape[2]
    k_chunks = _dequant_k(kq, kmn, ksc, torch.float32, bits)
    v_chunks = _dequant_v(vq, vmn, vsc, v_group, torch.float32, bits)
    if len(state_full) >= 12:
        kp, kqb, vp, vqb = (b[layer] for b in state_full[8:12])
        corr = lambda x, p, qb: x + torch.einsum(
            "bcrg,bkcrd->bkcgd", qb.to(torch.float32),
            p.to(torch.float32)).to(x.dtype)
        k_chunks = corr(k_chunks, kp, kqb)
        v_chunks = corr(v_chunks, vp, vqb)
    k_all = torch.cat([k_chunks.reshape(B, KVH, C * gap, hd),
                       res_k.to(torch.float32).transpose(1, 2)], dim=2)
    v_all = torch.cat([v_chunks.reshape(B, KVH, C * gap, hd),
                       res_v.to(torch.float32).transpose(1, 2)], dim=2)
    length = torch.as_tensor(length, device=q.device).reshape(-1).expand(B)
    nfull = length // gap
    res_len = length - nfull * gap
    chunk_valid = (torch.arange(C * gap, device=q.device)[None, :]
                   < (nfull * gap)[:, None])
    res_valid = torch.arange(gap, device=q.device)[None, :] < res_len[:, None]
    valid = torch.cat([chunk_valid, res_valid], dim=1)
    qg = q.reshape(B, KVH, rep, hd).to(torch.float32)
    logits = torch.einsum("bgrd,bgtd->bgrt", qg, k_all) * scale
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrt,bgtd->bgrd", probs, v_all)
    return out.reshape(B, H, hd).to(q.dtype)
