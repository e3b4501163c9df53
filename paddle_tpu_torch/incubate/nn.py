"""incubate.nn: the fused transformer API (port of
paddle_tpu/incubate/nn.py).

The reference's "fused" is one XLA region with its Pallas flash attention
on the hot path. The port composes the same ops: attention through
``ops/attention.py`` (B1-B3 where its rule selects flash: s >= 256, no
mask, no dropout), the feed-forward core through ``ops/fused_ffn.py`` and
the post-LN residual write through ``post_residual_ln``. The names and
shapes of the parameters are the reference's, so weights cross by name.
"""
from __future__ import annotations

import torch

from .. import nn
from ..nn import functional as F
from ..ops.attention import scaled_dot_product_attention

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "FusedBiasDropoutResidualLayerNorm",
           "fused_feedforward", "fused_bias_dropout_residual_layer_norm",
           "softmax_mask_fuse", "softmax_mask_fuse_upper_triangle"]


def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.5, epsilon=1e-5,
                                           training=True, name=None,
                                           generator=None):
    """``layer_norm(residual + dropout(x + bias))``, the norm's statistics
    and affine in f32, the result in the residual stream's dtype. The
    dropout mask draws from ``generator`` (None: torch's default one)."""
    h = x if bias is None else x + bias
    if training and dropout_rate > 0.0:
        h = F.dropout(h, p=dropout_rate, training=True, generator=generator)
    h = residual + h
    hf = h.float()
    mean = hf.mean(-1, keepdim=True)
    var = hf.var(-1, unbiased=False, keepdim=True)
    out = (hf - mean) * torch.rsqrt(var + epsilon)
    if ln_scale is not None:
        out = out * ln_scale.float()
    if ln_bias is not None:
        out = out + ln_bias.float()
    return out.to(h.dtype)


class FusedBiasDropoutResidualLayerNorm(nn.Layer):
    def __init__(self, embed_dim, dropout_rate=0.5, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, name=None, **factory):
        super().__init__(**factory)
        self.embed_dim = embed_dim
        self.dropout_rate = dropout_rate
        self._epsilon = epsilon
        I = nn.initializer
        self.linear_bias = self.create_parameter(
            shape=[embed_dim], attr=bias_attr, is_bias=True)
        self.ln_scale = self.create_parameter(
            shape=[embed_dim], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.ln_bias = self.create_parameter(shape=[embed_dim], attr=None,
                                             is_bias=True)

    def forward(self, x, residual):
        return fused_bias_dropout_residual_layer_norm(
            x, residual, self.linear_bias, self.ln_scale, self.ln_bias,
            dropout_rate=self.dropout_rate, epsilon=self._epsilon,
            training=self.training, generator=self._generator)


def _factory(kwargs):
    """The layer's device, dtype and generator among the keywords (the
    reference's layers take and ignore other ones)."""
    return {k: kwargs[k] for k in ("device", "dtype", "generator")
            if k in kwargs}


def _ffn_act(activation):
    """'gelu' is the erf gelu (the reference's fused op's GeluFunctor),
    'gelu_tanh' the tanh form."""
    if activation == "gelu":
        return F.gelu
    if activation == "gelu_tanh":
        return lambda h: F.gelu(h, approximate=True)
    return getattr(F, activation)


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True,
                      mode="upscale_in_train", name=None, generator=None):
    """``residual + dropout2(linear2(dropout1(act(linear1(ln1(x))))))``,
    ln1 before under ``pre_layer_norm``, else ln2 after the residual add.
    The linear1 -> act -> linear2 core runs through ops/fused_ffn.py when
    both biases are there and the dropout between the matmuls is the
    identity (rate 0, or inference under upscale_in_train), else as the
    composed ops."""
    from ..ops.fused_ffn import fused_ffn
    residual = x
    if pre_layer_norm:
        x = F.layer_norm(x, x.shape[-1], ln1_scale, ln1_bias, ln1_epsilon)

    def identity(rate):
        return rate == 0.0 or (not training and mode == "upscale_in_train")

    if (linear1_bias is not None and linear2_bias is not None
            and identity(dropout1_rate)
            and activation in ("gelu", "gelu_tanh", "relu")):
        out = fused_ffn(x, linear1_weight, linear1_bias, linear2_weight,
                        linear2_bias, activation=activation)
    else:
        h = _ffn_act(activation)(F.linear(x, linear1_weight, linear1_bias))
        if not identity(dropout1_rate):
            h = F.dropout(h, p=dropout1_rate, training=training, mode=mode,
                          generator=generator)
        out = F.linear(h, linear2_weight, linear2_bias)
    if not identity(dropout2_rate):
        out = F.dropout(out, p=dropout2_rate, training=training, mode=mode,
                        generator=generator)
    out = residual + out
    if not pre_layer_norm:
        out = F.layer_norm(out, out.shape[-1],
                           ln2_scale if ln2_scale is not None else ln1_scale,
                           ln2_bias if ln2_bias is not None else ln1_bias,
                           ln2_epsilon)
    return out


class FusedMultiHeadAttention(nn.Layer):
    """Self-attention with one (embed, 3·embed) qkv projection; post-LN
    (the residual write through ``post_residual_ln``) unless
    ``normalize_before``. At s >= 256 with no mask and no attention
    dropout it runs flash attention (B1, B2, B3)."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.0,
                 attn_dropout_rate=0.0, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, **kwargs):
        super().__init__(**_factory(kwargs))
        assert embed_dim % num_heads == 0
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        fk = self.factory_kwargs()
        self.qkv = nn.Linear(embed_dim, 3 * embed_dim, **fk)
        self.out_proj = nn.Linear(embed_dim, embed_dim, **fk)
        self.norm = nn.LayerNorm(embed_dim, **fk)
        self.dropout = nn.Dropout(dropout_rate, **fk)
        self.attn_dropout_rate = attn_dropout_rate

    def forward(self, x, attn_mask=None):
        residual = x
        if self.normalize_before:
            x = self.norm(x)
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv(x).reshape(b, s, 3, self.num_heads, self.head_dim)
        out = scaled_dot_product_attention(
            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], attn_mask=attn_mask,
            dropout_p=self.attn_dropout_rate, training=self.training,
            generator=self._generator)
        out = self.dropout(self.out_proj(out.reshape(b, s, self.embed_dim)))
        if self.normalize_before:
            return residual + out
        from ..ops.fused_residual_ln import post_residual_ln
        return post_residual_ln(residual, out, self.norm)


class FusedFeedForward(nn.Layer):
    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 activation="relu", act_dropout_rate=None,
                 normalize_before=False, **kwargs):
        super().__init__(**_factory(kwargs))
        self.normalize_before = normalize_before
        fk = self.factory_kwargs()
        self.linear1 = nn.Linear(d_model, dim_feedforward, **fk)
        self.linear2 = nn.Linear(dim_feedforward, d_model, **fk)
        self.norm = nn.LayerNorm(d_model, **fk)
        self.dropout = nn.Dropout(dropout_rate, **fk)
        self.act_dropout = nn.Dropout(
            dropout_rate if act_dropout_rate is None else act_dropout_rate,
            **fk)
        self._activation = activation
        self.act = getattr(F, activation)

    def forward(self, x):
        return fused_feedforward(
            x, self.linear1.weight, self.linear2.weight,
            self.linear1.bias, self.linear2.bias,
            ln1_scale=self.norm.weight, ln1_bias=self.norm.bias,
            ln2_scale=self.norm.weight, ln2_bias=self.norm.bias,
            dropout1_rate=self.act_dropout.p, dropout2_rate=self.dropout.p,
            activation=self._activation,
            ln1_epsilon=self.norm._epsilon, ln2_epsilon=self.norm._epsilon,
            pre_layer_norm=self.normalize_before, training=self.training,
            generator=self._generator)


class FusedTransformerEncoderLayer(nn.Layer):
    """FusedMultiHeadAttention then FusedFeedForward. ``dropout_rate`` is
    also the attention's dropout unless ``attn_dropout_rate`` is given,
    as in the reference: at its default 0.1 the flash rule does not fire
    in training."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False, **kwargs):
        super().__init__(**_factory(kwargs))
        fk = self.factory_kwargs()
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=(dropout_rate if attn_dropout_rate is None
                               else attn_dropout_rate),
            normalize_before=normalize_before, **fk)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, **fk)

    def forward(self, src, src_mask=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))


def softmax_mask_fuse(x, mask, name=None):
    """softmax(x + mask) over the last axis in f32, in x's dtype."""
    return torch.softmax((x + mask).float(), dim=-1).to(x.dtype)


def softmax_mask_fuse_upper_triangle(x):
    """softmax over the causal scores (the lower triangle, aligned to the
    last key), 0 above it; in f32, in x's dtype."""
    s_q, s_k = x.shape[-2], x.shape[-1]
    causal = torch.ones((s_q, s_k), dtype=torch.bool,
                        device=x.device).tril(s_k - s_q)
    logits = torch.where(causal, x, torch.full_like(x, -1e30))
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.where(causal, probs, 0.0).to(x.dtype)
