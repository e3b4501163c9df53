from .bert import BertConfig, BertForSequenceClassification, BertModel
from .ernie import ErnieConfig, ErnieForSequenceClassification, ErnieModel
from .gpt import GPTConfig, GPTForCausalLM, GPTModel

__all__ = ["BertConfig", "BertForSequenceClassification", "BertModel",
           "ErnieConfig", "ErnieForSequenceClassification", "ErnieModel",
           "GPTConfig", "GPTForCausalLM", "GPTModel"]
