"""The LLaVA-1.5 stack of the port: CLIP vision tower, projector, the
multimodal Llama-family model, conversation templates, host-side image and
prompt utilities, VQA generation and its evaluators (POPE, ScienceQA,
TextVQA, MMBench, the LLM-judge review), the delta-checkpoint CLI and the
LLaVA GPTQ calibration.

Counterpart of ``microscopiq_tpu/vlm`` (the reference's ``vlm/`` tree:
llava_arch.py, multimodal_encoder/, multimodal_projector/,
conversation.py, mm_utils.py, eval/, llava.py's GPTQ calibration). The tower
and the projector are plain PyTorch matmuls, as JAX computes them in XLA;
the language model's packed linears run the port's dequant GEMM (prefill)
and GEMV (decode), and a 4-bit KV cache the quantized attention kernel
where its geometry allows.
"""

from .clip import CLIPVisionConfig, CLIPVisionModel, CLIPVisionTower
from .conversation import (Conversation, SeparatorStyle, conv_templates,
                           default_conversation)
from .driver import llava_sequential
from .eval_vqa import eval_vqa, generate_mm, merge_answer_chunks
from .gpt_review import (build_review_content, parse_score, review_answers,
                         summarize_reviews)
from .llava import (IMAGE_TOKEN_INDEX, LlavaConfig, LlavaForCausalLM,
                    convert_hf_llava, pack_llava_lm, splice_image_features)
from .mm_utils import (expand_image_tokens, get_chunk, process_images,
                       split_list, tokenizer_image_token)
from .mmbench import eval_mmbench, load_mmbench_table, score_mmbench
from .projector import VisionProjector
from .textvqa import (EvalAIAnswerProcessor, STVQAAccuracyEvaluator,
                      STVQAANLSEvaluator, TextVQAAccuracyEvaluator,
                      eval_textvqa_files)

__all__ = [
    "CLIPVisionConfig", "CLIPVisionModel", "CLIPVisionTower",
    "Conversation", "SeparatorStyle", "conv_templates",
    "default_conversation", "llava_sequential", "eval_vqa",
    "generate_mm", "merge_answer_chunks", "IMAGE_TOKEN_INDEX",
    "LlavaConfig", "LlavaForCausalLM", "convert_hf_llava",
    "pack_llava_lm", "splice_image_features", "expand_image_tokens",
    "get_chunk", "process_images", "split_list",
    "tokenizer_image_token", "VisionProjector",
    "build_review_content", "parse_score", "review_answers",
    "summarize_reviews", "eval_mmbench", "load_mmbench_table",
    "score_mmbench", "EvalAIAnswerProcessor",
    "STVQAAccuracyEvaluator", "STVQAANLSEvaluator",
    "TextVQAAccuracyEvaluator", "eval_textvqa_files",
]
