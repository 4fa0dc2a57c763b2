"""LLaVA-1.5 multimodal model: CLIP vision tower, projector and a
Llama-family language model.

Counterpart of ``microscopiq_tpu/vlm/llava.py``. The host expands each
image placeholder (``IMAGE_TOKEN_INDEX``) of a prompt into exactly
``num_image_tokens`` slots (``mm_utils.expand_image_tokens``), so the
splice of the image features into the embedded prompt is a static-shape
masked gather:

    slot j of sample b  <-  image_feats[b, (cumsum(mask) - 1)[b, j]]

One image per sample. The image features are cast to the text tower's
dtype before the splice. Only the language model's linears are packed
(:func:`pack_llava_lm`, as the JAX function packs only ``model``): they run
the port's dequant GEMM for the prefill and GEMV for decode; the tower,
the projector and the lm_head stay dense, the lm_head a ``torch.matmul`` in
the text dtype (a dense ``QLinear``), as JAX computes it in XLA. The
MPT-backed variant ties its logits to the embedding.

A decode step passes no pixels: it is the language model's ordinary text
step, so ``eval.generate.DecodeStep`` captures and replays it as it does
for ``LlamaForCausalLM``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from .. import resolve_device
from ..models.llama import LlamaConfig, LlamaModel, QLinear, install_tree
from .clip import (CLIPVisionConfig, CLIPVisionTower, Dense, FlaxLayerNorm,
                   _tensor)
from .projector import VisionProjector

IMAGE_TOKEN_INDEX = -200  # host-side placeholder (llava/constants.py)


@dataclasses.dataclass(frozen=True)
class LlavaConfig:
    text: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    vision: CLIPVisionConfig = dataclasses.field(
        default_factory=CLIPVisionConfig)
    projector_type: str = "mlp2x_gelu"
    vision_select_layer: int = -2
    vision_select_feature: str = "patch"

    @property
    def num_image_tokens(self) -> int:
        n = self.vision.num_patches
        return n if self.vision_select_feature == "patch" else n + 1

    @staticmethod
    def tiny(**kw) -> "LlavaConfig":
        base = dict(text=LlamaConfig.tiny(),
                    vision=CLIPVisionConfig.tiny())
        base.update(kw)
        return LlavaConfig(**base)

    @staticmethod
    def mistral(text_kw: Optional[dict] = None, **kw) -> "LlavaConfig":
        """Mistral-backed LLaVA: the same multimodal model over the
        sliding-window Mistral language model."""
        text = LlamaConfig.mistral_7b(**(text_kw or {}))
        base = dict(text=text, vision=CLIPVisionConfig())
        base.update(kw)
        return LlavaConfig(**base)

    @staticmethod
    def tiny_mistral(**kw) -> "LlavaConfig":
        base = dict(text=LlamaConfig.tiny(sliding_window=8),
                    vision=CLIPVisionConfig.tiny())
        base.update(kw)
        return LlavaConfig(**base)

    @staticmethod
    def mpt(text_kw: Optional[dict] = None, **kw) -> "LlavaConfig":
        """MPT-backed LLaVA (ALiBi, biasless LayerNorm, GELU MLP, tied
        embeddings) under the same multimodal model."""
        text = LlamaConfig.mpt_7b(**(text_kw or {}))
        base = dict(text=text, vision=CLIPVisionConfig())
        base.update(kw)
        return LlavaConfig(**base)

    @staticmethod
    def tiny_mpt(**kw) -> "LlavaConfig":
        base = dict(text=LlamaConfig.tiny_mpt(),
                    vision=CLIPVisionConfig.tiny())
        base.update(kw)
        return LlavaConfig(**base)


def splice_image_features(text_embeds, image_feats, image_token_mask):
    """Static-shape splice: where the mask is set, the next image feature
    in order.

    text_embeds:      (B, S, D) embeddings of the expanded prompt
    image_feats:      (B, T, D) projected vision features (T = slots)
    image_token_mask: (B, S) bool, True at image slots (T per sample)
    """
    idx = torch.cumsum(image_token_mask.to(torch.int32), dim=1) - 1
    idx = torch.clamp(idx, 0, image_feats.shape[1] - 1).long()
    gathered = torch.gather(image_feats, 1, idx[..., None].expand(
        *idx.shape, image_feats.shape[-1]))
    return torch.where(image_token_mask[..., None], gathered, text_embeds)


def _vision_modules(cfg: LlavaConfig):
    return (CLIPVisionTower(cfg.vision, cfg.vision_select_layer,
                            cfg.vision_select_feature),
            VisionProjector(cfg.text.hidden_size, cfg.projector_type,
                            dtype=cfg.text.dtype))


def _check_installed(module: nn.Module) -> None:
    """Raise KeyError for a weight the installed tree left unset."""
    for name, mod in module.named_modules():
        attrs = ["kernel", "embed_tokens", "class_embedding",
                 "position_embedding"]
        if isinstance(mod, (Dense, FlaxLayerNorm)):
            attrs += ["bias", "scale"]
        for attr in attrs:
            if attr in vars(mod) and getattr(mod, attr) is None:
                raise KeyError(f"no {attr} for {name or 'the model'} in the "
                               "weight tree")


class LlavaForCausalLM(nn.Module):
    """LLaVA: ``vision_tower`` (CLIP), ``mm_projector`` and the language
    model ``model`` with its ``lm_head`` (none under tied embeddings);
    weights go in with :meth:`load_params`.

    ``device`` defaults to "cuda" and must exist; ``device="cpu"`` runs the
    plain versions on the CPU. ``use_kernels`` is the counterpart of JAX's
    ``use_pallas`` for the packed language-model linears.
    """

    def __init__(self, cfg: LlavaConfig, use_kernels: bool = True,
                 device="cuda"):
        super().__init__()
        tc = cfg.text
        self.cfg = cfg
        self.device = resolve_device(device)
        self.vision_tower, self.mm_projector = _vision_modules(cfg)
        self.model = LlamaModel(tc, use_kernels)
        self.lm_head = (None if tc.tie_word_embeddings
                        else QLinear(tc.dtype, use_kernels))

    def load_params(self, params) -> "LlavaForCausalLM":
        """Install a flax-named tree (``{"params": ...}`` or bare) with
        ``vision_tower``, ``mm_projector`` (absent for ``identity``),
        ``model`` and ``lm_head`` (absent when tied)."""
        install_tree(self, params.get("params", params), self.device)
        _check_installed(self)
        return self

    def image_features(self, pixel_values):
        """Projected image features in the text dtype, (B, T, D)."""
        pix = torch.as_tensor(pixel_values, device=self.device)
        feats = self.mm_projector(self.vision_tower(pix))
        return feats.to(self.cfg.text.dtype)

    def forward(self, input_ids, positions=None, mask=None, cache=None,
                pixel_values=None, image_token_mask=None, inputs_embeds=None,
                last_only: bool = False, logit_index=None):
        tc = self.cfg.text
        image_feats = None
        if pixel_values is not None:
            if image_token_mask is None:
                raise ValueError("image_token_mask required with "
                                 "pixel_values")
            image_feats = self.image_features(pixel_values)
        x = self.model(input_ids, positions, mask, cache, inputs_embeds,
                       image_feats, image_token_mask)
        if last_only:        # prefill: vocab matmul on the last token only
            x = x[:, -1:]
        elif logit_index is not None:
            idx = torch.as_tensor(logit_index, device=x.device).long()
            x = torch.gather(x, 1, idx[:, None, None].expand(
                x.shape[0], 1, x.shape[-1]))
        if tc.tie_word_embeddings:     # MPT-backed LLaVA ties lm_head
            embed = self.model.embed_tokens
            dt = torch.promote_types(x.dtype, embed.dtype)
            return torch.matmul(x.to(dt), embed.to(dt).T)
        return self.lm_head(x)


@torch.no_grad()
def multimodal_hidden(cfg: LlavaConfig, params, input_ids, image_token_mask,
                      pixel_values):
    """The hidden states entering decoder layer 0: text embedding (image
    slots as id 0), vision tower, projector and splice, computed from the
    weight tree ``params`` on the device of its embedding (the calibration
    capture of LLaVA's GPTQ calibration; no kernel runs here)."""
    p = params.get("params", params)
    embed = p["model"]["embed_tokens"]
    dev = embed.device
    tower, proj = _vision_modules(cfg)
    install_tree(tower, p["vision_tower"], dev)
    install_tree(proj, p.get("mm_projector", {}), dev)
    ids = torch.as_tensor(input_ids, device=dev)
    mask = torch.as_tensor(image_token_mask, device=dev)
    feats = proj(tower(torch.as_tensor(pixel_values, device=dev)))
    text = embed[torch.where(mask, 0, ids)]
    return splice_image_features(text, feats.to(text.dtype), mask)


def convert_hf_llava(state_dict, cfg: LlavaConfig, vision_params=None,
                     projector_params=None) -> dict:
    """Full HF LLaVA state dict (torch tensors or numpy arrays) -> the
    weight tree.

    The language model lies under ``model.*`` / ``lm_head.*`` (Llama layout)
    or ``transformer.*`` (MPT layout, detected by ``transformer.blocks.``),
    converted by ``models.loading.convert_llama`` / ``convert_mpt``; the
    vision tower under ``<base>.vision_tower.vision_tower.vision_model.*``
    and the projector under ``<base>.mm_projector.*``.
    ``vision_params`` / ``projector_params`` graft converted subtrees
    instead (a text-only checkpoint with a separately loaded tower).
    """
    from ..models.loading import convert_llama, convert_mpt
    from .clip import convert_hf_clip_vision
    from .projector import convert_hf_projector

    lm_sd = {k: _tensor(v) for k, v in state_dict.items()
             if not k.startswith(("model.vision_tower",
                                  "model.mm_projector",
                                  "transformer.vision_tower",
                                  "transformer.mm_projector"))}
    is_mpt = any(k.startswith("transformer.blocks.") for k in lm_sd)
    conv = convert_mpt if is_mpt else convert_llama
    params = conv(lm_sd, cfg.text)["params"]
    base = "transformer" if is_mpt else "model"
    params["vision_tower"] = (
        vision_params if vision_params is not None else
        convert_hf_clip_vision(
            state_dict, cfg.vision,
            prefix=f"{base}.vision_tower.vision_tower.vision_model."))
    params["mm_projector"] = (
        projector_params if projector_params is not None else
        convert_hf_projector(state_dict, cfg.projector_type,
                             prefix=f"{base}.mm_projector."))
    return {"params": params}


def pack_llava_lm(params, specs):
    """Pack only the language model's linears (``model``) by
    ``nn.pack_params``; the vision tower, the projector and the lm_head
    stay dense."""
    from ..nn import pack_params

    out = dict(params.get("params", params))
    out["model"] = pack_params({"model": out["model"]}, specs)["model"]
    return {"params": out}


def build_vision_params(cfg: LlavaConfig, seed: int = 0, device="cuda",
                        vision_device=None) -> dict:
    """Random float32 weights of the tower and the projector,
    ``{"vision_tower": ..., "mm_projector": ...}``: N(0, 0.02) kernels and
    embeddings, zero biases, LayerNorm scales 1, drawn in that order on
    ``vision_device`` (default ``device``) from ``seed`` and moved to
    ``device``. Drawn on the CPU, one seed gives the same weights in every
    process."""
    from .projector import projector_depth

    dev = resolve_device(device)
    vdev = resolve_device(vision_device or device)
    gen = torch.Generator(device=vdev).manual_seed(seed)
    vis = cfg.vision
    D, I, p = vis.hidden_size, vis.intermediate_size, vis.patch_size

    def normal(*shape):
        return (torch.randn(shape, generator=gen, device=vdev) * 0.02
                ).to(dev)

    def lin(k, n):
        return {"kernel": normal(k, n), "bias": torch.zeros(n, device=dev)}

    def ln(n):
        return {"scale": torch.ones(n, device=dev),
                "bias": torch.zeros(n, device=dev)}

    vm = {"class_embedding": normal(D),
          "position_embedding": normal(vis.num_positions, D),
          "patch_embedding": {"kernel": normal(p, p, 3, D)},
          "pre_layrnorm": ln(D)}
    for i in range(vis.num_hidden_layers):
        vm[f"layers_{i}"] = {
            "self_attn": {n: lin(D, D) for n in ("q_proj", "k_proj",
                                                 "v_proj", "out_proj")},
            "mlp": {"fc1": lin(D, I), "fc2": lin(I, D)},
            "layer_norm1": ln(D), "layer_norm2": ln(D)}
    out = {"vision_tower": {"vision_model": vm}}
    feat = D
    for i in range(projector_depth(cfg.projector_type)):
        out.setdefault("mm_projector", {})[f"layers_{i}"] = lin(
            feat, cfg.text.hidden_size)
        feat = cfg.text.hidden_size
    return out


def build_llava_params(cfg: LlavaConfig, seed: int = 0, packed_specs=None,
                       device="cuda", vision_device=None):
    """Random LLaVA weight tree: the language model of
    ``models.llama.build_params`` (N(0, 0.02) bf16 linears, embedding and
    norms in the text dtype, drawn on ``device`` from ``seed``), its
    ``model`` packed by :func:`pack_llava_lm` with ``packed_specs`` (the
    lm_head stays dense), and :func:`build_vision_params` from
    ``seed + 1``."""
    from ..models.llama import build_params

    tree = build_params(cfg.text, seed=seed, device=device)
    if packed_specs is not None:
        tree = pack_llava_lm(tree, packed_specs)
    tree = tree["params"]
    tree.update(build_vision_params(cfg, seed + 1, device, vision_device))
    return {"params": tree}
