"""Models of the training slices: GPT, BERT and ERNIE; and the numpy
carry of weights, layer states and static scopes between the packages
(the vision models are in ``vision.models``)."""
from .bert import (BertConfig, BertEmbeddings, BertForPretraining, BertModel,
                   bert_base, bert_tiny)
from .ernie import (ErnieConfig, ErnieEmbeddings, ErnieForPretraining,
                    ErnieForSequenceClassification, ErnieModel,
                    apply_knowledge_mask, ernie_base, ernie_tiny)
from .gpt import (GPTConfig, GPTForPretraining, GPTModel, gpt2_medium,
                  gpt2_small, gpt_tiny)
from .weights import (layer_from_numpy, layer_to_numpy, scope_from_numpy,
                      scope_to_numpy)

__all__ = ["BertConfig", "BertEmbeddings", "BertForPretraining", "BertModel",
           "ErnieConfig", "ErnieEmbeddings", "ErnieForPretraining",
           "ErnieForSequenceClassification", "ErnieModel", "GPTConfig",
           "GPTForPretraining", "GPTModel", "apply_knowledge_mask",
           "bert_base", "bert_tiny", "ernie_base", "ernie_tiny",
           "gpt2_medium", "gpt2_small", "gpt_tiny", "layer_from_numpy",
           "layer_to_numpy", "scope_from_numpy", "scope_to_numpy"]
