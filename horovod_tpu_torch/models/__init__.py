from .gpt import (GPTConfig, GPTLMHeadModel, convert_flax_gpt_params,
                  gpt2_medium_config, gpt2_small_config, gpt_tiny_config,
                  lm_loss)

__all__ = [
    "GPTConfig", "GPTLMHeadModel", "convert_flax_gpt_params",
    "gpt2_small_config", "gpt2_medium_config", "gpt_tiny_config",
    "lm_loss",
]
