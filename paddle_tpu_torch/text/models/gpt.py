"""GPT decoder: prefill and KV-cached decode for serving, and the
causal-LM loss for training.

Port of paddle_tpu/text/models/gpt.py. Same modules, parameter names and
layouts (Linear weights are (in, out)), so a reference state dict loads
with no renaming: ``gpt.wte.weight``, ``gpt.h.{i}.attn.qkv.weight``, ...
The blocks use the reference's carried-residual form, where each residual
add happens inside the fused_residual_ln that consumes it.

Construction takes an explicit ``device`` (default cuda:0; pass "cpu" for
the host), ``dtype`` (default float32; the reference's ``bfloat16()`` cast
is torch.nn.Module's own) and ``torch.Generator`` (initial weights are
drawn from it). ``GPTForCausalLM(ids, labels=...)`` returns the f32
softmax cross-entropy that a training step differentiates; the fused ops
and flash attention carry their own backwards. ``recompute=True``
reruns each block's forward in the backward when training
(distributed/fleet/utils.py), as the reference does. Tensor parallelism
comes with a later slice. ``use_flash_attention``, stored but unread in
the reference, chooses here between the automatic selection (True) and
the math path (False). The head is ``F.linear`` against the tied token
embedding, as in the reference, so ``amp.auto_cast`` casts it as a
``linear``.
"""
from __future__ import annotations

import math

import torch

from ... import nn
from ...distributed.fleet.utils import recompute
from ...nn import functional as F
from ...nn import initializer as I
from ...ops.attention import scaled_dot_product_attention
from ...ops.fused_ffn import fused_ffn
from ...ops.fused_residual_ln import fuse_enabled, fused_residual_ln

__all__ = ["GPTModel", "GPTForCausalLM", "GPTConfig"]

# GPT-2 init (normal(0, 0.02), residual-write projections scaled by
# 1/sqrt(2 * num_layers)), as in the reference
INITIALIZER_RANGE = 0.02


def _normal(std):
    return I.Normal(0.0, std)


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, max_position_embeddings=1024,
                 intermediate_size=None, dropout=0.1, tensor_parallel=False,
                 use_flash_attention=True, recompute=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_position_embeddings = max_position_embeddings
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.dropout = dropout
        self.tensor_parallel = tensor_parallel
        self.use_flash_attention = use_flash_attention
        self.recompute = recompute

    @classmethod
    def gpt3_1p3b(cls, **kw):
        return cls(vocab_size=50304, hidden_size=2048, num_layers=24,
                   num_heads=16, **kw)


class GPTAttention(nn.Layer):
    def __init__(self, cfg, **factory):
        super().__init__(**factory)
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.hidden = cfg.hidden_size
        self.dropout = cfg.dropout
        self.use_flash = cfg.use_flash_attention
        fk = self.factory_kwargs()
        w_res = _normal(INITIALIZER_RANGE / math.sqrt(2.0 * cfg.num_layers))
        self.qkv = nn.Linear(cfg.hidden_size, 3 * cfg.hidden_size,
                             weight_attr=_normal(INITIALIZER_RANGE), **fk)
        self.out_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size,
                                  weight_attr=w_res, **fk)

    def forward(self, x, cache=None):
        """Self-attention; ``cache`` (a (k, v) pair of (b, past, heads, dim)
        tensors, or (None, None) to start a stream) switches on incremental
        decode: the new keys/values are appended and the grown pair is
        returned beside the output. q, k and v are strided views of the
        fused projection; the flash kernel reads them in place."""
        b, s, _ = x.shape
        qkv = self.qkv(x).reshape(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(dim=2)
        if cache is not None:
            if cache[0] is not None:
                k = torch.cat([cache[0], k], dim=1)
                v = torch.cat([cache[1], v], dim=1)
            cache = (k, v)
        out = scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=self.dropout,
            training=self.training,
            use_kernel=None if self.use_flash else False,
            generator=self._generator)
        out = self.out_proj(out.reshape(b, s, self.hidden))
        if cache is not None:
            return out, cache
        return out


class GPTMLP(nn.Layer):
    def __init__(self, cfg, **factory):
        super().__init__(**factory)
        fk = self.factory_kwargs()
        w_res = _normal(INITIALIZER_RANGE / math.sqrt(2.0 * cfg.num_layers))
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size,
                             weight_attr=_normal(INITIALIZER_RANGE), **fk)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size,
                             weight_attr=w_res, **fk)
        self.dropout = nn.Dropout(cfg.dropout, **fk)

    def forward(self, x):
        out = fused_ffn(x, self.fc1.weight, self.fc1.bias, self.fc2.weight,
                        self.fc2.bias, activation="gelu_tanh")
        return self.dropout(out)


class GPTBlock(nn.Layer):
    def __init__(self, cfg, **factory):
        super().__init__(**factory)
        fk = self.factory_kwargs()
        self.ln1 = nn.LayerNorm(cfg.hidden_size, **fk)
        self.attn = GPTAttention(cfg, **fk)
        self.ln2 = nn.LayerNorm(cfg.hidden_size, **fk)
        self.mlp = GPTMLP(cfg, **fk)
        self.dropout = nn.Dropout(cfg.dropout, **fk)

    def forward(self, x, pending=None, cache=None):
        """Carried-residual form: the stream entering this block is
        x + pending (pending = the previous block's MLP output, not yet
        added). Returns (stream, pending_mlp_out), plus the grown cache
        when ``cache`` is given. PADDLE_TPU_FUSED_RESIDUAL_LN=0 runs the
        plain residual + LayerNorm composition instead (pending is then
        always None)."""
        has_cache = cache is not None
        if not fuse_enabled():
            if pending is not None:
                x = x + pending
            a = self.attn(self.ln1(x), cache=cache)
            if has_cache:
                a, cache = a
            x = x + self.dropout(a)
            x = x + self.mlp(self.ln2(x))
            return (x, None, cache) if has_cache else (x, None)
        if pending is None:
            x1, h1 = x, self.ln1(x)
        else:
            x1, h1 = fused_residual_ln(x, pending, self.ln1.weight,
                                       self.ln1.bias,
                                       epsilon=self.ln1._epsilon,
                                       return_residual=True)
        a = self.attn(h1, cache=cache)
        if has_cache:
            a, cache = a
        a = self.dropout(a)
        x2, h2 = fused_residual_ln(x1, a, self.ln2.weight, self.ln2.bias,
                                   epsilon=self.ln2._epsilon,
                                   return_residual=True)
        if has_cache:
            return x2, self.mlp(h2), cache
        return x2, self.mlp(h2)


class GPTModel(nn.Layer):
    def __init__(self, config=None, device=None, dtype=None, generator=None,
                 **kwargs):
        super().__init__(device=device, dtype=dtype, generator=generator)
        cfg = config or GPTConfig(**kwargs)
        if cfg.tensor_parallel:
            raise NotImplementedError(
                "tensor-parallel GPT comes with the port's distributed slice")
        self.config = cfg
        fk = self.factory_kwargs()
        w_emb = _normal(INITIALIZER_RANGE)
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                weight_attr=w_emb, **fk)
        self.wpe = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size,
                                weight_attr=w_emb, **fk)
        self.drop = nn.Dropout(cfg.dropout, **fk)
        self.h = nn.LayerList([GPTBlock(cfg, **fk)
                               for _ in range(cfg.num_layers)])
        self.ln_f = nn.LayerNorm(cfg.hidden_size, **fk)

    def init_decode_caches(self):
        """Empty per-layer KV caches for a fresh decode stream: pass to
        ``forward(caches=...)`` and thread the returned caches onward."""
        return [(None, None) for _ in range(len(self.h))]

    def forward(self, input_ids, position_ids=None, caches=None):
        b, s = input_ids.shape
        past = 0
        if caches is not None and caches[0][0] is not None:
            past = caches[0][0].shape[1]
        if position_ids is None:
            # cached decode: these tokens sit at positions [past, past + s)
            position_ids = torch.arange(past, past + s,
                                        device=input_ids.device)[None, :]
        x = self.drop(self.wte(input_ids) + self.wpe(position_ids))
        pending = None
        new_caches = []
        remat = caches is None and self.config.recompute and self.training
        for i, block in enumerate(self.h):
            if remat:
                x, pending = recompute(block, x, pending)
            elif caches is None:
                x, pending = block(x, pending)
            else:
                x, pending, c = block(x, pending, cache=caches[i])
                new_caches.append(c)
        if pending is None:
            h = self.ln_f(x)
        else:
            h = fused_residual_ln(x, pending, self.ln_f.weight,
                                  self.ln_f.bias, epsilon=self.ln_f._epsilon)
        if caches is not None:
            return h, new_caches
        return h


class GPTForCausalLM(nn.Layer):
    def __init__(self, config=None, device=None, dtype=None, generator=None,
                 **kwargs):
        super().__init__(device=device, dtype=dtype, generator=generator)
        self.gpt = GPTModel(config, **self.factory_kwargs(), **kwargs)
        # the head is tied to the token embedding
        self.config = self.gpt.config

    def forward(self, input_ids, labels=None, caches=None):
        """Logits (b, s, vocab); with ``caches`` returns (logits, caches);
        with ``labels`` (b, s) returns the mean f32 softmax cross-entropy
        of the logits against them."""
        if caches is not None:
            h, caches = self.gpt(input_ids, caches=caches)
            return F.linear(h, self.gpt.wte.weight.t()), caches
        logits = F.linear(self.gpt(input_ids), self.gpt.wte.weight.t())
        if labels is not None:
            # f32 softmax-CE, as the reference computes it
            return F.cross_entropy(
                logits.reshape(-1, self.config.vocab_size).float(),
                labels.reshape(-1))
        return logits
