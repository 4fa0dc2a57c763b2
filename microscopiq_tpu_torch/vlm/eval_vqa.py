"""VQA-style generation eval for LLaVA.

Counterpart of ``microscopiq_tpu/vlm/eval_vqa.py`` (the reference's
``vlm/llava/eval/model_vqa.py``: question jsonl -> answers jsonl, chunked
across workers, and ``vlm/llava.py:90-141``'s single-query generate).

:func:`generate_mm` is greedy at batch 1: one prefill with the pixels
(the image features spliced into the expanded prompt, the logits of the
last position only), then one decode step per token. A decode step is the
language model's text step, run by ``eval.generate.DecodeStep``: on the
card the first step of each variant runs eagerly and the rest replay a
CUDA graph, as ``generate``'s steps do; on the CPU every step is eager.
The cache (``eval.generate._make_cache``, dense or quantized) holds
``S + max_new_tokens + 1`` slots rounded up to the quantization gap, plus
one gap (JAX's sizing), and the loop stops after a step whose token is
EOS, which is kept.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch

from ..eval.generate import DecodeStep, _holding_device_lock, _make_cache
from .conversation import conv_templates
from .mm_utils import (expand_image_tokens, get_chunk, process_images,
                       tokenizer_image_token)


def mm_cache_len(S: int, max_new_tokens: int, gap: int = 1) -> int:
    """The cache slots :func:`generate_mm` allocates for an S-token prompt:
    S + max_new_tokens + 1 rounded up to the gap, plus one gap."""
    n = S + max_new_tokens + 1
    return ((n + gap - 1) // gap) * gap + gap


@torch.inference_mode()
@_holding_device_lock
def generate_mm(model, input_ids, image_token_mask, pixel_values,
                max_new_tokens: int, eos_token_id: Optional[int] = None,
                cache_kind: str = "dense", quant_cfg=None) -> np.ndarray:
    """Greedy multimodal decode, batch 1 (the reference generates one
    question at a time); returns (1, T <= max_new_tokens) int32 tokens.

    input_ids: (1, S) expanded prompt (image slots zeroed, mask True);
    image_token_mask: (1, S) bool; pixel_values: (1, H, W, 3). Holds
    ``eval.generate.DEVICE_LOCK``.
    """
    input_ids = np.asarray(input_ids)
    B, S = input_ids.shape
    max_len = mm_cache_len(S, max_new_tokens,
                           1 if quant_cfg is None else quant_cfg.gap)
    dev = model.device
    state, wrap = _make_cache(cache_kind, model.cfg.text, B, max_len,
                              quant_cfg, None, dev)
    ids = torch.as_tensor(input_ids, device=dev).long()
    positions = torch.arange(S, device=dev)[None, :].expand(B, S)
    cache = wrap(state)
    logits = model(ids, positions=positions, cache=cache,
                   pixel_values=torch.as_tensor(pixel_values, device=dev),
                   image_token_mask=torch.as_tensor(image_token_mask,
                                                    device=dev),
                   last_only=True)
    state = cache.finalize()
    tok = torch.argmax(logits[:, -1], dim=-1)
    # copies: on the CPU .numpy() would share the step's token buffer
    out = [tok.cpu().numpy().copy()]
    step = DecodeStep(model, state, tok,
                      cache.cfg if cache_kind == "quant" else None)
    for _ in range(max_new_tokens - 1):
        if eos_token_id is not None and (out[-1] == eos_token_id).all():
            break
        out.append(step().cpu().numpy().copy())
    return np.stack(out, axis=1).astype(np.int32)


def eval_vqa(model, tokenizer, questions: List[dict], image_loader,
             answers_file: str, conv_mode: str = "llava_v1",
             max_new_tokens: int = 128, num_chunks: int = 1,
             chunk_idx: int = 0, model_id: str = "microscopiq-llava",
             cache_kind: str = "dense", quant_cfg=None) -> List[dict]:
    """questions: [{question_id, image, text}, ...]; image_loader(name) ->
    (H, W, 3) array. Writes this chunk's answers jsonl, one record a
    question: {question_id, prompt, text, model_id, metadata}."""
    questions = get_chunk(questions, num_chunks, chunk_idx)
    os.makedirs(os.path.dirname(answers_file) or ".", exist_ok=True)
    vis = model.cfg.vision
    eos = getattr(tokenizer, "eos_token_id", None)
    results = []
    with open(answers_file, "w") as f:
        for q in questions:
            conv = conv_templates[conv_mode].copy()
            conv.append_message(conv.roles[0], "<image>\n" + q["text"])
            conv.append_message(conv.roles[1], None)
            prompt = conv.get_prompt()
            ids = tokenizer_image_token(prompt, tokenizer)
            input_ids, img_mask = expand_image_tokens(
                ids, model.cfg.num_image_tokens)
            pix = process_images([image_loader(q["image"])],
                                 vis.image_size)
            out = generate_mm(model, input_ids[None], img_mask[None], pix,
                              max_new_tokens, eos_token_id=eos,
                              cache_kind=cache_kind, quant_cfg=quant_cfg)
            text = tokenizer.decode([int(t) for t in out[0]
                                     if t != getattr(tokenizer,
                                                     "eos_token_id", -1)])
            rec = {"question_id": q.get("question_id"),
                   "prompt": q["text"], "text": text.strip(),
                   "model_id": model_id, "metadata": {}}
            f.write(json.dumps(rec) + "\n")
            results.append(rec)
    return results


def merge_answer_chunks(chunk_files: List[str], out_file: str) -> None:
    """Concatenate chunk jsonls into one file (vqav2.sh:28-38)."""
    with open(out_file, "w") as out:
        for cf in chunk_files:
            with open(cf) as f:
                out.write(f.read())
