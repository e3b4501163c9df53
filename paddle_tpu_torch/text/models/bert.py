"""BERT-style encoder and sequence classifier.

Port of paddle_tpu/text/models/bert.py, built on the port's
``nn.TransformerEncoder`` (post-LN layers, gelu FFN) as the reference
builds it. Same modules, parameter names and layouts (Linear weights are
(in, out)), so a reference state dict loads with no renaming:
``bert.embeddings.word_embeddings.weight``,
``bert.encoder.layers.{i}.self_attn.q_proj.weight``, ...,
``bert.pooler.weight``, ``classifier.weight``.

Construction takes ``device`` (default cuda:0; pass "cpu" for the host),
``dtype`` (default float32; ``bfloat16()`` is torch.nn.Module's own) and a
``torch.Generator``, from which the reference's init is drawn
(``_reference_init``). Position and token-type ids are made on the ids'
device (``arange``, ``zeros``), so a step captured as a CUDA graph copies
nothing from the host. ``attention_mask`` (b, s) of 1/0 becomes an
additive f32 (b, 1, 1, s) mask: with it attention takes the math path;
without it, at s >= 256 and no dropout, the flash kernels (non-causal).
``BertConfig.use_flash_attention`` (not in the reference) set to False
forces the math path, as GPTConfig's does.
"""
from __future__ import annotations

import torch

from ... import nn
from ...nn import functional as F
from ...nn import initializer as I
from ...ops.attention import NEG_BIG

__all__ = ["BertModel", "BertForSequenceClassification", "BertConfig"]


@torch.no_grad()
def _reference_init(root, std):
    """PaddleNLP's BERT init: every Linear and Embedding weight drawn from
    N(0, std) in place, from the layer's generator; LayerNorms and biases
    keep theirs."""
    for layer in root.sublayers(include_self=True):
        if isinstance(layer, (nn.Linear, nn.Embedding)):
            w = layer.weight
            w.copy_(I.Normal(0.0, std)(w.shape, w.dtype, w.device,
                                       layer._generator))


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072, max_position=512,
                 type_vocab_size=2, dropout=0.1, initializer_range=0.02,
                 use_flash_attention=True):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position = max_position
        self.type_vocab_size = type_vocab_size
        self.dropout = dropout
        self.initializer_range = initializer_range
        self.use_flash_attention = use_flash_attention

    @classmethod
    def base(cls):
        return cls()


class BertEmbeddings(nn.Layer):
    def __init__(self, cfg, **factory):
        super().__init__(**factory)
        fk = self.factory_kwargs()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            **fk)
        self.position_embeddings = nn.Embedding(cfg.max_position,
                                                cfg.hidden_size, **fk)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size, **fk)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, **fk)
        self.dropout = nn.Dropout(cfg.dropout, **fk)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros((b, s), dtype=torch.int64,
                                         device=input_ids.device)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class BertModel(nn.Layer):
    def __init__(self, config=None, device=None, dtype=None, generator=None,
                 **kwargs):
        super().__init__(device=device, dtype=dtype, generator=generator)
        cfg = config or BertConfig(**kwargs)
        self.config = cfg
        fk = self.factory_kwargs()
        self.embeddings = BertEmbeddings(cfg, **fk)
        enc_layer = nn.TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
            dropout=cfg.dropout, activation="gelu", **fk)
        self.encoder = nn.TransformerEncoder(enc_layer, cfg.num_layers)
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size, **fk)
        for layer in self.encoder.layers:
            layer.self_attn.use_flash_attention = cfg.use_flash_attention
        _reference_init(self, cfg.initializer_range)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """(sequence output (b, s, hidden), pooled output (b, hidden))."""
        x = self.embeddings(input_ids, token_type_ids)
        if attention_mask is not None:
            # (b, s) 1/0 mask -> additive f32 (b, 1, 1, s)
            attention_mask = torch.where(
                attention_mask[:, None, None, :] > 0, 0.0,
                NEG_BIG).to(torch.float32)
        seq = self.encoder(x, attention_mask)
        pooled = F.tanh(self.pooler(seq[:, 0]))
        return seq, pooled


class BertForSequenceClassification(nn.Layer):
    def __init__(self, config=None, num_classes=2, device=None, dtype=None,
                 generator=None, **kwargs):
        super().__init__(device=device, dtype=dtype, generator=generator)
        fk = self.factory_kwargs()
        self.bert = BertModel(config, **fk, **kwargs)
        cfg = self.bert.config
        self.dropout = nn.Dropout(cfg.dropout, **fk)
        self.classifier = nn.Linear(cfg.hidden_size, num_classes, **fk)
        _reference_init(self.classifier, cfg.initializer_range)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        """Logits (b, num_classes); with ``labels`` (b,) the mean f32
        softmax cross-entropy of the logits against them."""
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is not None:
            # f32 softmax-CE whatever the compute dtype, as the reference
            return F.cross_entropy(logits.float(), labels)
        return logits
