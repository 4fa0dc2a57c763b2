"""Vision-language parts of the port. Only the conversation templates are
ported so far (the serving front-ends build their prompts with them); the
LLaVA stack is ROADMAP queue 1 item 13, the last part of the JAX package
the port lacks (posit, VQ and the parallel layer are ported)."""

from .conversation import (Conversation, SeparatorStyle, conv_templates,
                           default_conversation)

__all__ = ["Conversation", "SeparatorStyle", "conv_templates",
           "default_conversation"]
