from .resnet import (ResNet, ResNet18, ResNet34, ResNet50, ResNet101,
                     ResNet152, convert_flax_resnet_params)
from .bert import (BertConfig, BertEncoder, BertForMaskedLM,
                   bert_base_config, bert_large_config, bert_tiny_config,
                   convert_flax_bert_params, mlm_loss)
from .gpt import (GPTConfig, GPTLMHeadModel, convert_flax_gpt_params,
                  gpt2_medium_config, gpt2_small_config, gpt_tiny_config,
                  lm_loss)
from .mnist import (MnistCNN, MnistMLP, convert_flax_mnist_params,
                    cross_entropy_loss)
from .dlrm import (DLRMConfig, DLRMDense, bce_logits_loss,
                   convert_flax_dlrm_params, dlrm_tiny_config,
                   synthetic_click_batch)
from .lfm2 import LFM2MoEConfig, LFM2MoEForCausalLM

__all__ = [
    "ResNet", "ResNet18", "ResNet34", "ResNet50", "ResNet101",
    "ResNet152", "convert_flax_resnet_params",
    "BertConfig", "BertEncoder", "BertForMaskedLM", "bert_base_config",
    "bert_large_config", "bert_tiny_config", "convert_flax_bert_params",
    "mlm_loss",
    "GPTConfig", "GPTLMHeadModel", "convert_flax_gpt_params",
    "gpt2_small_config", "gpt2_medium_config", "gpt_tiny_config",
    "lm_loss",
    "MnistCNN", "MnistMLP", "convert_flax_mnist_params",
    "cross_entropy_loss",
    "DLRMConfig", "DLRMDense", "bce_logits_loss", "dlrm_tiny_config",
    "synthetic_click_batch", "convert_flax_dlrm_params",
    "LFM2MoEConfig", "LFM2MoEForCausalLM",
]
