"""Multimodal host-side utilities (image preprocessing, prompt token
expansion, data-parallel chunking).

Counterpart of ``microscopiq_tpu/vlm/mm_utils.py``: the port's own copy of
that numpy code (bit-exact with it), so that the port imports nothing of
the JAX package.

Parity targets: ``vlm/llava/mm_utils.py`` (``process_images``,
``tokenizer_image_token`` :49-66, ``get_model_name_from_path``,
``KeywordsStoppingCriteria``) and the eval chunking helpers
``split_list``/``get_chunk`` (``vlm/llava/eval/model_vqa.py:16-25``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from .llava import IMAGE_TOKEN_INDEX

# OpenAI CLIP normalization constants (HF CLIPImageProcessor defaults)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def _resize_bilinear(img: np.ndarray, size: int) -> np.ndarray:
    """(H, W, C) float → (size, size, C), bilinear, host-side numpy."""
    H, W, C = img.shape
    ys = (np.arange(size) + 0.5) * H / size - 0.5
    xs = (np.arange(size) + 0.5) * W / size - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def expand2square(img: np.ndarray, fill: Sequence[float]) -> np.ndarray:
    """Pad to square with the background color (mm_utils.py pad mode)."""
    H, W, C = img.shape
    if H == W:
        return img
    side = max(H, W)
    out = np.empty((side, side, C), img.dtype)
    out[...] = np.asarray(fill, img.dtype)
    y0 = (side - H) // 2
    x0 = (side - W) // 2
    out[y0:y0 + H, x0:x0 + W] = img
    return out


def process_images(images: List[np.ndarray], image_size: int,
                   aspect_ratio: str = "pad") -> np.ndarray:
    """uint8/float (H, W, 3) images → (N, size, size, 3) normalized."""
    out = []
    for img in images:
        img = np.asarray(img, np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        if aspect_ratio == "pad":
            img = expand2square(img, CLIP_MEAN)
        img = _resize_bilinear(img, image_size)
        out.append((img - CLIP_MEAN) / CLIP_STD)
    return np.stack(out).astype(np.float32)


def tokenizer_image_token(prompt: str, tokenizer,
                          image_token: str = "<image>") -> List[int]:
    """Tokenize, inserting IMAGE_TOKEN_INDEX at '<image>' placeholders
    (mm_utils.py:49-66 semantics: BOS kept once, chunks joined)."""
    chunks = [tokenizer.encode(c) for c in prompt.split(image_token)]
    ids: List[int] = list(chunks[0])
    bos = getattr(tokenizer, "bos_token_id", None)
    for ch in chunks[1:]:
        ids.append(IMAGE_TOKEN_INDEX)
        ids.extend(ch[1:] if (bos is not None and ch[:1] == [bos]) else ch)
    return ids


def expand_image_tokens(ids: Sequence[int], num_image_tokens: int,
                        pad_to: Optional[int] = None,
                        pad_id: int = 0):
    """Expand each IMAGE_TOKEN_INDEX into ``num_image_tokens`` slots.

    Returns (input_ids int32 (S,), image_token_mask bool (S,)). The
    static-shape analog of prepare_inputs_labels_for_multimodal
    (llava_arch.py:145-324).
    """
    out, mask = [], []
    for t in ids:
        if t == IMAGE_TOKEN_INDEX:
            out.extend([0] * num_image_tokens)
            mask.extend([True] * num_image_tokens)
        else:
            out.append(int(t))
            mask.append(False)
    if pad_to is not None:
        if len(out) > pad_to:
            raise ValueError(f"expanded prompt {len(out)} > pad_to "
                             f"{pad_to}")
        pad = pad_to - len(out)
        out = [pad_id] * pad + out      # left-pad (generation-friendly)
        mask = [False] * pad + mask
    return (np.asarray(out, np.int32), np.asarray(mask, bool))


def split_list(lst, n):
    """Split into n (roughly) equal chunks (model_vqa.py:16-20)."""
    size = math.ceil(len(lst) / n)
    return [lst[i:i + size] for i in range(0, len(lst), size)]


def get_chunk(lst, n, k):
    return split_list(lst, n)[k]


def get_model_name_from_path(model_path: str) -> str:
    parts = model_path.strip("/").split("/")
    if parts[-1].startswith("checkpoint-") and len(parts) > 1:
        return parts[-2] + "_" + parts[-1]
    return parts[-1]
