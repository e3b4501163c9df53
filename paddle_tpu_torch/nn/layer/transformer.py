"""Transformer layers (port of paddle_tpu/nn/layer/transformer.py).

MultiHeadAttention with separate q/k/v/out projections (paddle's (in, out)
Linear weights), ``Cache`` (incremental self-attention keys and values,
grown by concatenation) and ``StaticCache`` (cross-attention keys and
values projected once); the encoder and decoder layers, pre-LN or post-LN,
whose post-LN residual writes go through ``post_residual_ln``; the stacks
and the encoder-decoder ``Transformer``. Parameter names are the
reference's, so state dicts cross unchanged.

Attention goes through ``ops/attention.scaled_dot_product_attention``,
whose rule takes the flash kernels (B1, B2, B3, non-causal here) on the
card when there is no mask and no dropout and the sequence is at least 256
long; ``use_flash_attention = False`` on a MultiHeadAttention forces the
math path (the reference stores no such switch). A bool mask becomes an
additive -1e30 mask in q's dtype; any other mask is added to the logits as
it is.

Every layer takes the port's ``device``, ``dtype`` and ``generator``
keywords and hands them to its sublayers. The stacks deep-copy the given
layer with its generator shared, not copied: a copied ``torch.Generator``
would give every layer the same dropout masks and the same fresh weights.
"""
from __future__ import annotations

import collections
import copy

import torch

from ...ops.attention import NEG_BIG, scaled_dot_product_attention
from ...ops.fused_ffn import fused_ffn
from ...ops.fused_residual_ln import post_residual_ln
from .. import functional as F
from .. import initializer as I
from .common import Dropout, Linear
from .container import LayerList
from .layers import Layer
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


def _convert_attn_mask(attn_mask, dtype):
    """A bool mask (True = attend) becomes an additive 0 / -1e30 mask in
    ``dtype``; other masks pass through."""
    if attn_mask is None or attn_mask.dtype != torch.bool:
        return attn_mask
    return torch.where(attn_mask, 0.0, NEG_BIG).to(dtype)


class MultiHeadAttention(Layer):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, **factory):
        super().__init__(**factory)
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.head_dim = embed_dim // num_heads
        assert self.head_dim * num_heads == embed_dim
        self.use_flash_attention = True
        fk = self.factory_kwargs()
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             **fk)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr,
                             **fk)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr,
                             **fk)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **fk)

    def _split_heads(self, x):
        b, s, _ = x.shape
        return x.reshape(b, s, self.num_heads, self.head_dim)

    def gen_cache(self, key, value=None, type=Cache):  # noqa: A002
        """A ``StaticCache`` of the projected ``key``/``value`` (cross
        attention), or an empty ``Cache`` of (b, 0, heads, head_dim)."""
        if type == MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(
                value if value is not None else key))
            return self.StaticCache(k, v)
        shape = (key.shape[0], 0, self.num_heads, self.head_dim)
        return self.Cache(torch.zeros(shape, dtype=key.dtype,
                                      device=key.device),
                          torch.zeros(shape, dtype=key.dtype,
                                      device=key.device))

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
                cache = self.Cache(k, v)
        out = scaled_dot_product_attention(
            q, k, v, attn_mask=_convert_attn_mask(attn_mask, q.dtype),
            dropout_p=self.dropout, training=self.training,
            use_kernel=None if self.use_flash_attention else False,
            generator=self._generator)
        b, s = out.shape[0], out.shape[1]
        out = self.out_proj(out.reshape(b, s, self.embed_dim))
        if isinstance(cache, self.Cache):
            return out, cache
        return out


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 **factory):
        super().__init__(**factory)
        fk = self.factory_kwargs()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **fk)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **fk)
        self.dropout = Dropout(act_dropout, **fk)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **fk)
        self.norm1 = LayerNorm(d_model, **fk)
        self.norm2 = LayerNorm(d_model, **fk)
        self.dropout1 = Dropout(dropout, **fk)
        self.dropout2 = Dropout(dropout, **fk)
        self._activation_name = activation
        self.activation = getattr(F, activation)

    def _ffn(self, src):
        """linear1 -> activation -> dropout -> linear2; through fused_ffn
        (whose backward recomputes the activation) when the inner dropout
        is inactive and the activation is relu or gelu."""
        drop_active = self.training and self.dropout.p > 0.0
        if (not drop_active and self._activation_name in ("relu", "gelu")
                and self.linear1.bias is not None
                and self.linear2.bias is not None):
            return fused_ffn(src, self.linear1.weight, self.linear1.bias,
                             self.linear2.weight, self.linear2.bias,
                             activation=self._activation_name)
        return self.linear2(self.dropout(self.activation(self.linear1(src))))

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        if self.normalize_before:
            src = residual + self.dropout1(src)
        else:
            src = post_residual_ln(residual, self.dropout1(src), self.norm1)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self._ffn(src)
        if self.normalize_before:
            src = residual + self.dropout2(src)
        else:
            src = post_residual_ln(residual, self.dropout2(src), self.norm2)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


def _copies(layer, num_layers):
    """``layer`` and ``num_layers - 1`` deep copies of it that share its
    generators, each copy re-initialised (``_reinit``)."""
    memo = {id(m._generator): m._generator for m in layer.modules()
            if isinstance(m, Layer) and m._generator is not None}
    layers = [layer] + [copy.deepcopy(layer, dict(memo))
                        for _ in range(num_layers - 1)]
    for other in layers[1:]:
        _reinit(other)
    return LayerList(layers)


@torch.no_grad()
def _reinit(layer):
    """Fresh weights for a deep-copied layer, as the reference draws them:
    every Linear's weight XavierNormal, its bias zeros, in place and from
    the layer's generator."""
    for sub in layer.sublayers(include_self=True):
        if isinstance(sub, Linear):
            w = sub.weight
            w.copy_(I.XavierNormal()(w.shape, w.dtype, w.device,
                                     sub._generator))
            if sub.bias is not None:
                sub.bias.zero_()


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None, **factory):
        # the stack's own device, dtype and generator default to its
        # layer's
        super().__init__(**{**encoder_layer.factory_kwargs(), **factory})
        self.layers = _copies(encoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, c = mod(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 **factory):
        super().__init__(**factory)
        fk = self.factory_kwargs()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **fk)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr, **fk)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **fk)
        self.dropout = Dropout(act_dropout, **fk)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **fk)
        self.norm1 = LayerNorm(d_model, **fk)
        self.norm2 = LayerNorm(d_model, **fk)
        self.norm3 = LayerNorm(d_model, **fk)
        self.dropout1 = Dropout(dropout, **fk)
        self.dropout2 = Dropout(dropout, **fk)
        self.dropout3 = Dropout(dropout, **fk)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        """``cache`` is the pair (incremental Cache, StaticCache) of
        ``gen_cache``; with it the grown pair is returned beside the
        output."""
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
            incremental_cache = None
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                                    cache[0])
        if self.normalize_before:
            tgt = residual + self.dropout1(tgt)
        else:
            tgt = post_residual_ln(residual, self.dropout1(tgt), self.norm1)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
            static_cache = None
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask, cache[1])
            static_cache = cache[1]
        if self.normalize_before:
            tgt = residual + self.dropout2(tgt)
        else:
            tgt = post_residual_ln(residual, self.dropout2(tgt), self.norm2)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        if self.normalize_before:
            tgt = residual + self.dropout3(tgt)
        else:
            tgt = post_residual_ln(residual, self.dropout3(tgt), self.norm3)
        if cache is None:
            return tgt
        return tgt, (incremental_cache, static_cache)

    def gen_cache(self, memory):
        incremental = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(memory, memory,
                                           MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None, **factory):
        # the stack's own device, dtype and generator default to its
        # layer's
        super().__init__(**{**decoder_layer.factory_kwargs(), **factory})
        self.layers = _copies(decoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, c = mod(output, memory, tgt_mask, memory_mask,
                                cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        caches = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            caches = list(zip(*caches))
        return caches


class Transformer(Layer):
    """The encoder-decoder; ``custom_encoder``/``custom_decoder`` replace
    the stacks it would build."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, **factory):
        super().__init__(**factory)
        fk = self.factory_kwargs()
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **fk)
            enc_norm = LayerNorm(d_model, **fk) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm, **fk)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **fk)
            dec_norm = LayerNorm(d_model, **fk) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm, **fk)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    def generate_square_subsequent_mask(self, length):
        """(length, length) f32: 0 on and below the diagonal, -1e30
        above, on the layer's device."""
        keep = torch.ones((length, length), dtype=torch.bool,
                          device=self._device).tril()
        return torch.where(keep, 0.0, NEG_BIG).to(torch.float32)
