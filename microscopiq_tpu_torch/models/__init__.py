from .llama import LlamaConfig, LlamaForCausalLM, build_params
from .opt import OPTConfig, OPTForCausalLM

__all__ = ["LlamaConfig", "LlamaForCausalLM", "build_params", "OPTConfig",
           "OPTForCausalLM"]
