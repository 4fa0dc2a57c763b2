from .data import get_loaders, synthetic_corpus
from .generate import generate, pad_prompts
from .ppl import perplexity

__all__ = ["generate", "get_loaders", "pad_prompts", "perplexity",
           "synthetic_corpus"]
