"""Fused flash-decode attention over a quantized KV cache: the CUDA kernel's
wrapper, its plain PyTorch twin, and the decode attention built on them.

Counterpart of ``microscopiq_tpu/ops/pallas/quant_attention.py``:
``chunk_attention`` stands for ``_chunk_attention`` (the Pallas
``_chunk_kernel``, here ``csrc/quant_attention.cu``), ``residual_attention``
for ``_residual_attention``, and ``quant_attention_decode`` /
``quant_attention_decode_reference`` keep their names. The flash combine of
the chunks' and the residual window's partial states is plain PyTorch, as it
lies outside the kernel in JAX.

Tensors on the CPU go to the plain twin ``chunk_attention_reference``.
Tensors on a CUDA device go to the kernel or raise: there is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ...kv.cache import _dequant_k, _dequant_v, _per
from . import build

NEG_INF = -1e30
# limits of csrc/quant_attention.cu: 4 or 8 head-dim columns per lane, up to
# 16 accumulator rows (8 when hd > 128), and the shared memory of one block
# on the H100
MAX_HEAD_DIM = 256
MAX_REP = 16
MAX_SMEM_BYTES = 227 * 1024
_WARPS = 4                        # kWarps: a block of 128 threads
# one chunk per block up to 512 / KVH chunks: at the Llama-3-8B shape (KVH =
# 8, C = 51) that is 51 * 8 * B blocks
_TARGET_SPLITS_X_KVH = 512

# launches of the kernel wrapper, for showing that a run went through the
# kernel; chip_smoke.py zeroes them before the main path and reads them after
launch_counts = {"quant_attention": 0}

_ptr, _int = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_ptr] * 16 + [_int] * 12 + [ctypes.c_float, _ptr]
_BITS_OF_PER = {1: 8, 2: 4, 4: 2}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def smem_bytes(rep: int, hd: int, gap: int, Gh: int, rank: int) -> int:
    """Shared memory of one kernel block, in bytes: ``Smem`` of
    ``csrc/quant_attention.cu`` (f32 arrays, each on a 16-byte boundary),
    mirrored here so that the route is chosen on any device; the card tests
    hold it to the kernel's ``quant_attention_smem_bytes``."""
    up = lambda n: (n + 3) & ~3                   # noqa: E731
    krep = next((b for b in (1, 2, 4, 8) if rep <= b), 16)   # rep_bucket
    k = up(rep * hd)                              # after the query rows
    p = up(k + max(gap * (hd + 1), _WARPS * rep * hd))
    pt = up(p + rep * gap)
    vsm = up(pt + gap * krep)
    lk = up(vsm + 2 * gap * Gh)
    lv = up(lk + rank * gap)
    pl = up(lv + rank * gap)
    m = up(pl + rep * rank)
    return (m + 3 * rep) * 4                      # m, l and the rescales


def _geometry_fault(hd: int, rep: int, gap: int, bits: int, Gh: int,
                    rank: int) -> Optional[str]:
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
    smem = smem_bytes(rep, hd, gap, Gh, rank)
    if smem > MAX_SMEM_BYTES:
        return (f"gap {gap} x head_dim {hd} needs {smem} bytes of shared "
                f"memory, over {MAX_SMEM_BYTES}")
    return None


def decode_route(hd: int, rep: int, gap: int, bits: int, v_group: int,
                 rank: int = 0) -> str:
    """The decode attention of a quantized KV cache of this geometry:
    ``"fused"``, the kernel (:func:`quant_attention_decode`), where it
    takes the head_dim ``hd``, ``rep`` query heads per KV head, the
    cache's gap, bits, V group and low-rank rank; else ``"update"``,
    ``cache.update`` and the model's own attention. Chosen from the config
    and shapes alone, before the launch, the same on every device; the
    kernel's operand checks share its limits."""
    Gh = hd // min(v_group, hd)
    fault = _geometry_fault(hd, rep, gap, bits, Gh, rank)
    return "fused" if fault is None else "update"


def chunk_splits(C: int, KVH: int) -> Tuple[int, int]:
    """(nsplit, chunks per split) of the kernel's chunk axis.

    Depends only on (C, KVH), never on the batch, so that a slot's result is
    the same in a batch of any size.
    """
    want = max(1, min(C, -(-_TARGET_SPLITS_X_KVH // KVH)))
    cps = -(-C // want)
    return -(-C // cps), cps


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


def _check_operands(q, kq, kmn, ksc, vq, vmn, vsc, nfull, gap, bits,
                    lowrank) -> Tuple[int, int]:
    """Raise on what the kernel does not take; returns (rank, lr_f32)."""
    dev = q.device
    ops = [q, kq, kmn, ksc, vq, vmn, vsc, nfull] + list(lowrank or ())
    if not all(t.is_cuda and t.device == dev for t in ops):
        raise ValueError("all operands must be on one CUDA device")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("operands must be contiguous")
    B, KVH, rep, hd = q.shape
    if q.dtype != torch.bfloat16:
        raise ValueError(f"q must be bf16, got {q.dtype}")
    Gh = vsc.shape[-1]
    rank = 0 if lowrank is None else lowrank[0].shape[-2]
    fault = _geometry_fault(hd, rep, gap, bits, Gh, rank)
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
    if nfull.dtype != torch.int32 or tuple(nfull.shape) != (B,):
        raise ValueError("nfull must be a (B,) int32 tensor")
    # the kernel loads codes as 4-byte words and K scales as 16-byte vectors
    if kq.data_ptr() % 4 or vq.data_ptr() % 4 or kmn.data_ptr() % 16 \
            or ksc.data_ptr() % 16:
        raise ValueError("kq, vq must be 4-byte and k_mn, k_sc 16-byte "
                         "aligned")
    if lowrank is None:
        return 0, 0
    kp, kqb, vp, vqb = lowrank
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
    rank, lr_f32 = _check_operands(q, kq, kmn, ksc, vq, vmn, vsc, nfull,
                                   gap, bits, lowrank)
    B, KVH, rep, hd = q.shape
    C = kq.shape[2]
    nsplit, cps = chunk_splits(C, KVH)
    dev = q.device
    o = torch.empty((B, KVH, rep, hd), dtype=torch.float32, device=dev)
    m = torch.empty((B, KVH, rep, 1), dtype=torch.float32, device=dev)
    l = torch.empty((B, KVH, rep, 1), dtype=torch.float32, device=dev)
    ws = torch.empty((B * KVH * nsplit * rep * (hd + 2),),
                     dtype=torch.float32, device=dev)
    kp, kqb, vp, vqb = lowrank if lowrank is not None else (None,) * 4
    ptr = lambda t: None if t is None else t.data_ptr()
    err = build.entry("quant_attention", "quant_attention_chunks",
                      _ARGTYPES)(
        q.data_ptr(), kq.data_ptr(), kmn.data_ptr(), ksc.data_ptr(),
        vq.data_ptr(), vmn.data_ptr(), vsc.data_ptr(), ptr(kp), ptr(kqb),
        ptr(vp), ptr(vqb), nfull.data_ptr(), ws.data_ptr(), o.data_ptr(),
        m.data_ptr(), l.data_ptr(), B, KVH, C, rep, hd, gap, bits,
        vsc.shape[-1], rank, lr_f32, nsplit, cps, float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "quant_attention")
    launch_counts["quant_attention"] += 1
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
    """Fused decode attention over one layer of a quantized KV cache.

    q (B, H, hd): the step's queries. state_full: (kq, k_mn, k_sc, vq, v_mn,
    v_sc, res_k, res_v[, k_p, k_q, v_p, v_q]), the full (L-leading) cache
    buffers. length: live tokens including the current one, whose K/V are
    already in the residual window; an int, a 0-d tensor (every row), or
    a (B,) tensor of per-slot depths. Returns (B, H, hd) in q.dtype.
    """
    kq, kmn, ksc, vq, vmn, vsc, res_k, res_v = (b[layer]
                                                for b in state_full[:8])
    lowrank = (tuple(b[layer] for b in state_full[8:12])
               if len(state_full) >= 12 else None)
    B, H, hd, KVH, rep, gap, bits = _layer_geometry(state_full, q)
    qg = q.reshape(B, KVH, rep, hd)
    if isinstance(length, torch.Tensor):
        # a 0-d length (the shared cache's) serves every row
        length = length.to(torch.int32).reshape(-1).expand(B)
        nfull = (length // gap).to(torch.int32)
        res_len = length - nfull * gap
    else:
        nfull = torch.full((B,), length // gap, dtype=torch.int32,
                           device=q.device)
        res_len = length - (length // gap) * gap
    o1, m1, l1 = chunk_attention(
        qg.to(torch.bfloat16).contiguous(), kq, kmn, ksc, vq, vmn, vsc,
        nfull, scale, gap, bits, lowrank)
    o2, m2, l2 = residual_attention(qg, res_k, res_v, res_len, scale)
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    o = o1 * a1 + o2 * a2
    l = l1 * a1 + l2 * a2
    out = o / torch.clamp(l, min=1e-30)
    return out.reshape(B, H, hd).to(q.dtype)


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
