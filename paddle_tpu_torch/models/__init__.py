"""Models of the port."""
from .bert import (BertConfig, BertForPretraining,  # noqa: F401
                   BertForSequenceClassification, BertModel, bert_base,
                   bert_large, bert_tiny)
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel, gpt_125m,  # noqa: F401
                  gpt_1p3b, gpt_350m, gpt_6p7b, gpt_tiny)

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt_tiny", "gpt_125m",
           "gpt_350m", "gpt_1p3b", "gpt_6p7b", "BertConfig", "BertModel",
           "BertForPretraining", "BertForSequenceClassification",
           "bert_tiny", "bert_base", "bert_large"]
