"""ERNIE-base (port of paddle_tpu/text/models/ernie.py).

The fine-tune graph of ERNIE-base is BERT's encoder (12 layers, hidden
768, 12 heads) with ERNIE's vocabulary (18000 tokens) and a 513-entry
position table, which sizes the table only; so the classes are the BERT
classes under ERNIE's configuration defaults.
"""
from __future__ import annotations

from .bert import BertConfig, BertForSequenceClassification, BertModel

__all__ = ["ErnieConfig", "ErnieModel", "ErnieForSequenceClassification"]


class ErnieConfig(BertConfig):
    def __init__(self, vocab_size=18000, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072, max_position=513,
                 type_vocab_size=2, dropout=0.1):
        super().__init__(vocab_size=vocab_size, hidden_size=hidden_size,
                         num_layers=num_layers, num_heads=num_heads,
                         intermediate_size=intermediate_size,
                         max_position=max_position,
                         type_vocab_size=type_vocab_size, dropout=dropout)


class ErnieModel(BertModel):
    def __init__(self, config=None, device=None, dtype=None, generator=None,
                 **kwargs):
        super().__init__(config or ErnieConfig(**kwargs), device=device,
                         dtype=dtype, generator=generator)


class ErnieForSequenceClassification(BertForSequenceClassification):
    def __init__(self, config=None, num_classes=2, device=None, dtype=None,
                 generator=None, **kwargs):
        super().__init__(config or ErnieConfig(**kwargs),
                         num_classes=num_classes, device=device, dtype=dtype,
                         generator=generator)
