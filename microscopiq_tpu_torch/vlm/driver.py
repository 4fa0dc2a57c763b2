"""LLaVA GPTQ calibration over the language model.

Counterpart of ``microscopiq_tpu/vlm/driver.py`` (the reference's
``vlm/llava.py:154-264``, ``llava_sequential``): GPTQ runs over the
language model's decoder layers only, through ``quant.calibrate.
sequential_gptq`` and its true-sequential ``LLAMA_GROUPS``. The
calibration hidden states entering layer 0 come from the whole multimodal
embedding (``llava.multimodal_hidden``: vision tower, projector, splice),
so the Hessians see the image tokens' statistics. The vision tower, the
projector, the embedding and the lm_head come back untouched.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.llama import DecoderLayer, causal_mask
from ..quant.calibrate import LLAMA_GROUPS, _copy_dicts, sequential_gptq
from ..quant.quantizer import MXQuantizer
from .llava import multimodal_hidden


@torch.no_grad()
def llava_sequential(model, params, calib_ids, calib_image_masks,
                     calib_pixels, quantizer: Optional[MXQuantizer] = None,
                     mode: str = "mx_prune", blocksize: int = 128,
                     percdamp: float = 0.01, actorder: bool = False,
                     nsamples_batch: int = 4, verbose: bool = True,
                     timer=None):
    """GPTQ over the LM decoder layers of a LLaVA model; returns the new
    weight tree (``{"params": ...}``, the quantized kernels dense).

    model:             the LlavaForCausalLM (its config and device)
    params:            its weight tree, dense, on that device
    calib_ids:         (n, S) expanded prompts (image slots zeroed)
    calib_image_masks: (n, S) bool image-slot masks
    calib_pixels:      (n, H, W, 3) preprocessed images
    timer:             a ``quant.gptq.StageTimer`` for the seconds by stage
    The default quantizer is the reference's: int2 inliers, fp4_e2m1
    outliers, scale bits 8/8, block 16 on axis 0, std_dev 2.
    """
    cfg = model.cfg
    dev = model.device
    if quantizer is None:
        quantizer = MXQuantizer()
        quantizer.configure(8, 8, "int2", "fp4_e2m1", std_dev=2, axes=[0],
                            block_size=16)
    p = _copy_dicts(params.get("params", params))
    ids = torch.as_tensor(calib_ids, device=dev)
    masks = torch.as_tensor(calib_image_masks, device=dev)
    pixels = torch.as_tensor(calib_pixels, device=dev)
    n, S = ids.shape
    positions = torch.arange(S, device=dev)[None, :]
    mask = causal_mask(S, positions, cfg.text.sliding_window)

    # multimodal embeddings entering decoder layer 0
    hidden = torch.cat([
        multimodal_hidden(cfg, {"params": p}, ids[s0:s0 + nsamples_batch],
                          masks[s0:s0 + nsamples_batch],
                          pixels[s0:s0 + nsamples_batch])
        for s0 in range(0, n, nsamples_batch)])

    tree = p["model"]
    layer_params = [tree[f"layers_{i}"]
                    for i in range(cfg.text.num_hidden_layers)]
    new_layers, _, _ = sequential_gptq(
        DecoderLayer(cfg.text).to(dev), layer_params, hidden,
        lambda i, x: (positions, mask, None, i), quantizer,
        groups=LLAMA_GROUPS, nsamples_batch=nsamples_batch,
        blocksize=blocksize, percdamp=percdamp, actorder=actorder,
        mode=mode, verbose=verbose, timer=timer)
    for i, lp in enumerate(new_layers):
        tree[f"layers_{i}"] = lp
    return {"params": p}
