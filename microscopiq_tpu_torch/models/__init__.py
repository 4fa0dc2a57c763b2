from .llama import LlamaConfig, LlamaForCausalLM, build_params
from .loading import (convert_llama, convert_mpt, convert_opt,
                      export_llama_state_dict, export_opt_state_dict,
                      load_hf_state_dict, read_safetensors,
                      state_dict_from_torch_model)
from .opt import OPTConfig, OPTForCausalLM

__all__ = ["LlamaConfig", "LlamaForCausalLM", "build_params", "OPTConfig",
           "OPTForCausalLM", "convert_llama", "convert_mpt", "convert_opt",
           "export_llama_state_dict", "export_opt_state_dict",
           "load_hf_state_dict", "read_safetensors",
           "state_dict_from_torch_model"]
