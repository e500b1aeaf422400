"""GPT-style autoregressive decoder.

Counterpart of the JAX package's ``gluon/model_zoo/gpt.py``: a pre-norm
decoder-only transformer (LayerNorm before attention/FFN, learned position
embeddings, untied LM head) with three entry points over one parameter set:

* ``forward(tokens) -> logits``: the full causal pass;
* ``prefill(tokens)``: the same pass, also returning the per-layer K/V
  planes ``(L, B, H, T, D)`` that seed a KV cache;
* ``decode_step(tokens, k_cache, v_cache, cache_len)``: advances every slot
  of an ``[L, S, H, T, D]`` cache by one token. The new token's K/V is
  written in place at the slot's fill level, and attention reads exactly
  ``[0, cache_len]`` through the ``cache_offset`` mode of
  ``flash_attention``.

Attention is ``ops.flash_attention``: on a CUDA tensor, the hand-written
kernel, in causal mode for ``forward``/``prefill`` and in cache-offset mode
for ``decode_step``. A ``forward`` with grad enabled goes through its
autograd Function, so training's backward runs the two backward kernels;
``prefill`` and ``decode_step`` run without grad. Q/K/V enter it as strided head-split views of the
fused QKV projection (no copies), and its output comes back already in
(B, T, H, D) order, so merging the heads is a view too.
"""

from __future__ import annotations

import torch

from ...ops.flash_attention import flash_attention
from ...ops.nn import activation
from ...ops.registry import recorded
from ..block import HybridBlock
from ..nn import Dense, Dropout, Embedding, LayerNorm

__all__ = ["CausalSelfAttention", "GPTBlockCell", "GPTDecoder", "get_gpt"]


def _kv_cache_write(cache, new, total_lens):
    """Write each slot's new K/V row at its fill position, in place.

    ``cache`` (S, H, T, D), ``new`` (S, H, 1, D), ``total_lens`` (S,) valid
    length per slot INCLUDING the new token: the row lands at
    ``total_lens - 1``. The index must lie in ``[0, T)``; torch raises (or
    asserts on the device) where XLA would clamp, and the serving scheduler
    never feeds one outside (it resets a finished slot's fill to 0)."""
    s = cache.shape[0]
    slots = torch.arange(s, device=cache.device)
    cache[slots, :, total_lens.long() - 1] = new[:, :, 0]
    return cache


class CausalSelfAttention(HybridBlock):
    """Fused-QKV multi-head causal self-attention with a decode mode."""

    def __init__(self, units, num_heads, dropout=0.0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            if units % num_heads:
                raise ValueError(f"units {units} not divisible by heads "
                                 f"{num_heads}")
            self._units = units
            self._heads = num_heads
            self.qkv = Dense(3 * units, flatten=False, in_units=units)
            self.proj = Dense(units, flatten=False, in_units=units)
            self.drop = Dropout(dropout)

    def _project(self, x):
        """(B, H, T, D) views of q, k, v over the fused projection."""
        b, t, _ = x.shape
        qkv = self.qkv(x).view(b, t, 3, self._heads,
                               self._units // self._heads)
        q, k, v = qkv.unbind(2)
        return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def _merge(self, out):
        b, _, t, _ = out.shape
        return out.transpose(1, 2).reshape(b, t, self._units)

    def forward(self, x):
        out, _, _ = self.forward_with_kv(x)
        return out

    def forward_with_kv(self, x):
        """Full-sequence causal attention; also returns this layer's K/V
        planes (B, H, T, D) for cache seeding (prefill)."""
        q, k, v = self._project(x)
        out = flash_attention(q, k, v, causal=True)
        return self.drop(self.proj(self._merge(out))), k, v

    def decode_step(self, x, k_cache, v_cache, total_lens):
        """One-token decode over this layer's cache plane.

        ``x`` (S, 1, C); ``k_cache``/``v_cache`` (S, H, T, D), updated in
        place; ``total_lens`` (S,) int32 valid length per slot including
        the new token."""
        q, k_new, v_new = self._project(x)
        _kv_cache_write(k_cache, k_new, total_lens)
        _kv_cache_write(v_cache, v_new, total_lens)
        out = flash_attention(q, k_cache, v_cache, total_lens,
                              cache_offset=True)
        return self.drop(self.proj(self._merge(out))), k_cache, v_cache


class GPTBlockCell(HybridBlock):
    """Pre-norm decoder block: x + attn(ln1(x)); x + ffn(ln2(x))."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.1,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.ln1 = LayerNorm(in_channels=units)
            self.attn = CausalSelfAttention(units, num_heads, dropout=dropout)
            self.ln2 = LayerNorm(in_channels=units)
            self.ffn1 = Dense(hidden_size, flatten=False, in_units=units)
            self.ffn2 = Dense(units, flatten=False, in_units=hidden_size)
            self.ffn_drop = Dropout(dropout)

    def _ffn(self, x):
        return self.ffn_drop(self.ffn2(activation(self.ffn1(x), "gelu")))

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self._ffn(self.ln2(x))

    def forward_with_kv(self, x):
        a, k, v = self.attn.forward_with_kv(self.ln1(x))
        x = x + a
        return x + self._ffn(self.ln2(x)), k, v

    def decode_step(self, x, k_cache, v_cache, total_lens):
        a, k_cache, v_cache = self.attn.decode_step(
            self.ln1(x), k_cache, v_cache, total_lens)
        x = x + a
        return x + self._ffn(self.ln2(x)), k_cache, v_cache


class GPTDecoder(HybridBlock):
    """GPT-style decoder LM: tokens (B, T) int -> logits (B, T, V).

    ``max_length`` bounds both the sequence length and the serving KV-cache
    ``max_len`` (learned position table size)."""

    def __init__(self, vocab_size=50257, units=768, hidden_size=None,
                 num_layers=12, num_heads=12, max_length=1024, dropout=0.1,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._vocab = vocab_size
            self._units = units
            self._layers = num_layers
            self._heads = num_heads
            self._max_length = max_length
            hidden_size = 4 * units if hidden_size is None else hidden_size
            self.word_embed = Embedding(vocab_size, units)
            self.position_embed = Embedding(max_length, units)
            self.embed_dropout = Dropout(dropout)
            for i in range(num_layers):
                setattr(self, f"layer{i}",
                        GPTBlockCell(units, hidden_size, num_heads,
                                     dropout=dropout))
            self.ln_f = LayerNorm(in_channels=units)
            self.head = Dense(vocab_size, flatten=False, use_bias=False,
                              in_units=units)

    # serving/decode.py sizes the KV cache off these
    @property
    def num_layers(self):
        return self._layers

    @property
    def num_heads(self):
        return self._heads

    @property
    def head_dim(self):
        return self._units // self._heads

    @property
    def max_length(self):
        return self._max_length

    @property
    def vocab_size(self):
        return self._vocab

    def _cells(self):
        return [getattr(self, f"layer{i}") for i in range(self._layers)]

    def _embed(self, tokens, positions):
        return self.embed_dropout(self.word_embed(tokens)
                                  + self.position_embed(positions))

    @staticmethod
    @recorded("positions")
    def _positions(tokens):
        b, t = tokens.shape
        return torch.arange(t, device=tokens.device).expand(b, t)

    def forward(self, tokens):
        x = self._embed(tokens, self._positions(tokens))
        for cell in self._cells():
            x = cell(x)
        return self.head(self.ln_f(x))

    @torch.no_grad()
    def prefill(self, tokens):
        """Full causal forward that ALSO returns the per-layer K/V planes
        for cache seeding: ``logits`` (B, T, V), ``k``/``v``
        (L, B, H, T, D). Positions past a prompt's true length carry
        garbage K/V that no valid position attends; the serving tier's
        per-slot ``cache_len`` keeps decode from reading them."""
        x = self._embed(tokens, self._positions(tokens))
        ks, vs = [], []
        for cell in self._cells():
            x, k, v = cell.forward_with_kv(x)
            ks.append(k)
            vs.append(v)
        return self.head(self.ln_f(x)), torch.stack(ks), torch.stack(vs)

    @torch.no_grad()
    def decode_step(self, tokens, k_cache, v_cache, cache_len):
        """Advance every slot one token: ``tokens`` (S,) int, the next
        input token per slot; ``k_cache``/``v_cache`` (L, S, H, T, D),
        updated IN PLACE; ``cache_len`` (S,) int32 tokens already cached
        per slot (the new token lands at that position). Returns
        ``logits`` (S, V) and the caches. Free slots compute too: the
        scheduler ignores their rows and their writes land in freed
        space."""
        s = tokens.shape[0]
        x = self._embed(tokens.view(s, 1), cache_len.view(s, 1))
        total = (cache_len + 1).to(torch.int32)
        for i, cell in enumerate(self._cells()):
            x, _, _ = cell.decode_step(x, k_cache[i], v_cache[i], total)
        return self.head(self.ln_f(x)).squeeze(1), k_cache, v_cache


#: GPT-2-family configs (117M/345M) plus a tiny config for tests
_GPT_SPECS = {
    "gpt_decoder_tiny": dict(num_layers=2, units=64, num_heads=4),
    "gpt_decoder_117m": dict(num_layers=12, units=768, num_heads=12),
    "gpt_decoder_345m": dict(num_layers=24, units=1024, num_heads=16),
}


def get_gpt(model_name="gpt_decoder_117m", vocab_size=50257, dropout=0.1,
            max_length=1024, **kwargs):
    """GPT decoder factory. The parameters are declared, not drawn: call
    ``initialize(init, ctx)`` or load weights next."""
    if model_name not in _GPT_SPECS:
        raise ValueError(f"unknown gpt spec {model_name!r}; "
                         f"known {sorted(_GPT_SPECS)}")
    spec = dict(_GPT_SPECS[model_name])
    spec.update(kwargs)
    return GPTDecoder(vocab_size=vocab_size, dropout=dropout,
                      max_length=max_length, **spec)
