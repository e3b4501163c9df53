from .gpt import GPTConfig, GPTForCausalLM, GPTModel

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTModel"]
