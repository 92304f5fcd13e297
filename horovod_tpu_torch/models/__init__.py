from .bert import (BertConfig, BertForMaskedLM, bert_base_config,
                   bert_large_config, bert_tiny_config,
                   convert_flax_bert_params, mlm_loss)
from .gpt import (GPTConfig, GPTLMHeadModel, convert_flax_gpt_params,
                  gpt2_medium_config, gpt2_small_config, gpt_tiny_config,
                  lm_loss)

__all__ = [
    "BertConfig", "BertForMaskedLM", "bert_base_config",
    "bert_large_config", "bert_tiny_config", "convert_flax_bert_params",
    "mlm_loss",
    "GPTConfig", "GPTLMHeadModel", "convert_flax_gpt_params",
    "gpt2_small_config", "gpt2_medium_config", "gpt_tiny_config",
    "lm_loss",
]
