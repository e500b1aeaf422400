"""Transformer encoder and BERT.

Counterpart of the JAX package's ``models/transformer.py`` (GluonNLP's
BERT-base capability): multi-head attention over separate query, key,
value and output projections, the position-wise FFN, the post-norm
encoder cell, the encoder stack and ``BERTModel`` with its pooler, masked
LM decoder and next-sentence classifier, and the ``get_bert`` factory.
Parameter names are the JAX package's structural names
(``encoder.layer0.attention.query.weight``, ``mlm_decoder.2.bias``), so
``gluon.model_zoo.load_jax_params`` carries weights across by name.

Attention takes one of two implementations, as in the reference:
``attention_impl="xla"`` (the default) is the dense chain of
``ops.nn.scaled_dot_product_attention``, with the per-sample
``valid_length`` expanded to a key mask; ``"pallas"`` calls
``ops.flash_attention`` with the lengths and no causal mask, so on a CUDA
tensor the forward runs K4 and a backward K5/K6 (a CPU tensor takes their
plain versions). A float ``valid_length`` reaches both as the reference
has it: the key mask compares positions with the float value (9.7 admits
10 keys), the flash path truncates it (9 keys). ``"ring"`` (sequence
parallelism) waits for the multi-GPU slice.
"""

from __future__ import annotations

import torch

from ..gluon.block import HybridBlock
from ..gluon.nn import Dense, Dropout, Embedding, HybridSequential, LayerNorm
from ..ops.flash_attention import flash_attention
from ..ops.nn import activation, scaled_dot_product_attention
from ..ops.registry import recorded

__all__ = ["BERTEncoder", "BERTModel", "MultiHeadAttention",
           "PositionwiseFFN", "TransformerEncoderCell", "get_bert"]

_MULTI_GPU = "the multi-GPU slice of the port (ROADMAP.md queue 1, item 10)"


def _length_mask(lengths, t_k):
    """(B,) valid lengths -> (B, 1, 1, Tk) fp32 key mask, 1 where the key
    position is below the sample's length (compared as the length's own
    type, as the reference does)."""
    cols = torch.arange(t_k, device=lengths.device)
    return (cols.view(1, 1, 1, t_k)
            < lengths.reshape(-1, 1, 1, 1)).to(torch.float32)


@recorded("positions")
def _positions(token_ids):
    b, t = token_ids.shape
    return torch.arange(t, device=token_ids.device).expand(b, t)


class MultiHeadAttention(HybridBlock):
    """Self-attention over (B, T, C) with ``num_heads`` heads (GluonNLP
    ``MultiHeadAttentionCell`` capability). ``attn_dropout`` is declared
    and, as in the reference, never applied."""

    def __init__(self, units, num_heads, dropout=0.0, use_bias=True,
                 attention_impl="xla", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            if units % num_heads:
                raise ValueError(f"units {units} not divisible by heads "
                                 f"{num_heads}")
            if attention_impl == "ring":
                raise NotImplementedError(
                    f"attention_impl='ring' (ring attention over a sequence "
                    f"mesh) waits for {_MULTI_GPU}")
            self._units = units
            self._heads = num_heads
            self._impl = attention_impl
            for name in ("query", "key", "value", "proj"):
                setattr(self, name, Dense(units, flatten=False,
                                          use_bias=use_bias, in_units=units))
            self.attn_dropout = Dropout(dropout)

    def _split(self, x):
        """(B, T, C) -> a (B, H, T, D) view."""
        b, t, _ = x.shape
        return x.view(b, t, self._heads,
                      self._units // self._heads).transpose(1, 2)

    def forward(self, x, mask=None, lengths=None):
        q = self._split(self.query(x))
        k = self._split(self.key(x))
        v = self._split(self.value(x))
        if self._impl == "pallas" and mask is None:
            # the flash kernels take per-sample key lengths natively
            out = flash_attention(q, k, v, lengths)
        else:
            if lengths is not None and mask is None:
                mask = _length_mask(lengths, k.shape[2])
            out = scaled_dot_product_attention(q, k, v, mask=mask)
        b, _, t, _ = out.shape
        return self.proj(out.transpose(1, 2).reshape(b, t, self._units))


class PositionwiseFFN(HybridBlock):
    """``dropout(ffn2(act(ffn1(x))))``; gelu is the tanh approximation."""

    def __init__(self, units, hidden_size, dropout=0.0, activation="gelu",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.ffn1 = Dense(hidden_size, flatten=False, in_units=units)
            self.ffn2 = Dense(units, flatten=False, in_units=hidden_size)
            self.dropout = Dropout(dropout)
            self._act = activation

    def forward(self, x):
        return self.dropout(self.ffn2(activation(self.ffn1(x), self._act)))


class TransformerEncoderCell(HybridBlock):
    """Post-norm encoder layer (BERT convention): ``h = ln1(x +
    dropout(attention(x)))``, then ``ln2(h + ffn(h))``."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.1,
                 attention_impl="xla", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.attention = MultiHeadAttention(units, num_heads,
                                                dropout=dropout,
                                                attention_impl=attention_impl)
            self.dropout = Dropout(dropout)
            self.ln1 = LayerNorm(in_channels=units)
            self.ffn = PositionwiseFFN(units, hidden_size, dropout)
            self.ln2 = LayerNorm(in_channels=units)

    def forward(self, x, mask=None, lengths=None):
        h = self.ln1(x + self.dropout(self.attention(x, mask, lengths)))
        return self.ln2(h + self.ffn(h))


class BERTEncoder(HybridBlock):
    """``num_layers`` encoder cells, named ``layer0``, ``layer1``, ...."""

    def __init__(self, num_layers, units, hidden_size, num_heads,
                 dropout=0.1, attention_impl="xla", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            for i in range(num_layers):
                setattr(self, f"layer{i}",
                        TransformerEncoderCell(units, hidden_size, num_heads,
                                               dropout, attention_impl))
            self._num_layers = num_layers

    def forward(self, x, mask=None, lengths=None):
        for i in range(self._num_layers):
            x = getattr(self, f"layer{i}")(x, mask, lengths)
        return x


class BERTModel(HybridBlock):
    """BERT with MLM + NSP heads (GluonNLP ``BERTModel`` capability).

    The heads are opt-in by constructor flags, as in the reference: a head
    that is not part of the training objective is not registered.

    forward(token_ids, segment_ids=None, valid_length=None) -> tuple of
        sequence_output (B, T, C),
        pooled_output (B, C)      (if use_pooler),
        mlm_scores    (B, T, V)   (if use_decoder),
        nsp_scores    (B, 2)      (if use_classifier; requires use_pooler)
    or the sequence output alone when every head is off. ``segment_ids``
    None means segment 0 everywhere; ``valid_length`` (B,) None means
    every key is valid.
    """

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512,
                 type_vocab_size=2, dropout=0.1, attention_impl="xla",
                 use_pooler=True, use_decoder=True, use_classifier=True,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            if use_classifier and not use_pooler:
                raise ValueError(
                    "use_classifier=True requires use_pooler=True (NSP "
                    "scores come from the pooled output)")
            self._units = units
            self._use_pooler = use_pooler
            self._use_decoder = use_decoder
            self._use_classifier = use_classifier
            self.word_embed = Embedding(vocab_size, units)
            self.token_type_embed = Embedding(type_vocab_size, units)
            self.position_embed = Embedding(max_length, units)
            self.embed_ln = LayerNorm(in_channels=units)
            self.embed_dropout = Dropout(dropout)
            self.encoder = BERTEncoder(num_layers, units, hidden_size,
                                       num_heads, dropout, attention_impl)
            if use_pooler:
                self.pooler = Dense(units, in_units=units, activation="tanh")
            if use_classifier:
                self.nsp_classifier = Dense(2, in_units=units)
            if use_decoder:
                self.mlm_decoder = HybridSequential(prefix="mlm_")
                with self.mlm_decoder.name_scope():
                    self.mlm_decoder.add(
                        Dense(units, flatten=False, in_units=units,
                              activation="gelu"),
                        LayerNorm(in_channels=units),
                        Dense(vocab_size, flatten=False, in_units=units))

    def forward(self, token_ids, segment_ids=None, valid_length=None):
        pos = _positions(token_ids)
        if segment_ids is None:
            # segment 0 everywhere: token_type_embed contributes (and gets
            # a gradient) on every forward
            segment_ids = torch.zeros_like(token_ids)
        emb = (self.word_embed(token_ids) + self.position_embed(pos)
               + self.token_type_embed(segment_ids))
        emb = self.embed_dropout(self.embed_ln(emb))
        seq = self.encoder(emb, None, valid_length)
        outputs = [seq]
        if self._use_pooler:
            pooled = self.pooler(seq[:, 0])
            outputs.append(pooled)
        if self._use_decoder:
            outputs.append(self.mlm_decoder(seq))
        if self._use_classifier:
            outputs.append(self.nsp_classifier(pooled))
        return tuple(outputs) if len(outputs) > 1 else outputs[0]


_BERT_SPECS = {
    "bert_12_768_12": dict(num_layers=12, units=768, hidden_size=3072,
                           num_heads=12),
    "bert_24_1024_16": dict(num_layers=24, units=1024, hidden_size=4096,
                            num_heads=16),
}


def get_bert(model_name="bert_12_768_12", vocab_size=30522, dropout=0.1,
             max_length=512, attention_impl="xla", **kwargs):
    """BERT factory (GluonNLP ``get_model('bert_12_768_12')``
    capability). The parameters are declared, not drawn: call
    ``initialize(init, ctx)`` or load weights next."""
    if model_name not in _BERT_SPECS:
        raise ValueError(f"unknown bert spec {model_name!r}; "
                         f"known {sorted(_BERT_SPECS)}")
    spec = dict(_BERT_SPECS[model_name])
    spec.update(kwargs)
    return BERTModel(vocab_size=vocab_size, dropout=dropout,
                     max_length=max_length, attention_impl=attention_impl,
                     **spec)
