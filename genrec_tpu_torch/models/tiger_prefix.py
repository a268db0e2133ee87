"""TIGER-prefix: prefix-conditioned generative retrieval.

Counterpart of ``genrec_tpu/models/tiger_prefix.py``
(`RQVAE-T5-prefix/model.py:8-210`): three ``ProfessionalAdapter``
cross-attention modules (one per major-hierarchy level) each turn (student
token embeddings × top-5 major BERT vectors) into one prefix token; the 3
prefix tokens go before the encoder's input embeddings, and the attention
mask gains 3 ones, in training and in generation. The T5 is the port's
``T5EncoderDecoder``: its attention without a KV cache runs through kernels
#1 and #2 (``ops/t5_attention.py``), at Lq = Lk = 3 + history tokens in the
encoder. The adapters' attention (80 queries over 5 keys) takes the plain
route of ``ops/attention.multi_head_attention``, as in the reference.

Parameter names follow the Flax tree (``model.*``, ``adapter_lvl{1,2,3}.*``),
so ``convert.tiger_prefix_params_from_flax`` maps it leaf for leaf. Dropout
runs in training mode, its masks drawn from the ``generator`` given to
``forward``; generation wants ``.eval()``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from genrec_tpu_torch.configs import TIGERPrefixConfig
from genrec_tpu_torch.models.layers import dense
from genrec_tpu_torch.models.t5 import T5EncoderDecoder, cross_entropy_with_ignore, shift_right
from genrec_tpu_torch.ops.attention import multi_head_attention
from genrec_tpu_torch.ops.beam_search import ConstraintSpec, beam_search


class ProfessionalAdapter(nn.Module):
    """Cross-attention adapter → one prefix token
    (`RQVAE-T5-prefix/model.py:8-48`): Q = student embeddings, K = V =
    projected BERT vectors, attention-weight dropout (torch
    ``nn.MultiheadAttention(dropout=)``); post-norm residuals with Flax's
    LayerNorm ε = 1e-6; a tanh-GELU FFN of width 4·d; mean-pooled over the
    sequence to (B, 1, d)."""

    def __init__(self, bert_dim: int, d_model: int, num_heads: int, dropout: float,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.bert_proj = dense(bert_dim, d_model, generator)
        self.q_proj = dense(d_model, d_model, generator)
        self.k_proj = dense(d_model, d_model, generator)
        self.v_proj = dense(d_model, d_model, generator)
        self.out_proj = dense(d_model, d_model, generator)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        self.ffn_in = dense(d_model, 4 * d_model, generator)
        self.ffn_out = dense(4 * d_model, d_model, generator)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, student_hidden, bert_vecs, generator: Optional[torch.Generator] = None):
        # Flax's nn.Dense without a dtype promotes a bf16 input and its f32
        # kernel to f32: the adapter computes in its parameters' dtype at
        # either compute dtype
        student_hidden = student_hidden.to(self.q_proj.weight.dtype)
        kv = self.bert_proj(bert_vecs)  # (B, 5, d)
        drop = self.training and self.dropout > 0.0
        if drop and generator is None:
            raise ValueError("training-mode dropout draws its masks from a torch.Generator: "
                             "pass generator=..., or call .eval()")
        attn = multi_head_attention(self.q_proj(student_hidden), self.k_proj(kv),
                                    self.v_proj(kv), num_heads=self.num_heads,
                                    dropout_rate=self.dropout if drop else 0.0,
                                    generator=generator if drop else None)
        x = self.norm1(student_hidden + self.out_proj(attn))
        h = self.ffn_out(F.gelu(self.ffn_in(x), approximate="tanh"))
        x = self.norm2(x + h)
        return x.mean(dim=1, keepdim=True)


class TIGERPrefix(nn.Module):
    def __init__(self, cfg: TIGERPrefixConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        a = cfg.arch
        self.model = T5EncoderDecoder(a, generator)
        for i in range(3):
            setattr(self, f"adapter_lvl{i + 1}",
                    ProfessionalAdapter(cfg.bert_dim, a.d_model, a.num_heads, a.dropout_rate,
                                        generator))

    def build_prefix_inputs(self, input_ids, attention_mask, prof_lvl1, prof_lvl2, prof_lvl3,
                            generator: Optional[torch.Generator] = None):
        """Embed ids, compute 3 prefix tokens, prepend them
        (`RQVAE-T5-prefix/model.py:96-124`): (inputs_embeds (B, 3 + L, d),
        the mask with 3 ones in front)."""
        embeds = self.model.shared(input_ids)  # (B, L, d)
        adapters = (self.adapter_lvl1, self.adapter_lvl2, self.adapter_lvl3)
        prefixes = [ad(embeds, prof, generator)
                    for ad, prof in zip(adapters, (prof_lvl1, prof_lvl2, prof_lvl3))]
        # the prefixes (in the adapters' dtype) promote the embeddings, which
        # are bf16 at a bf16 compute dtype
        inputs_embeds = torch.cat(prefixes + [embeds.to(prefixes[0].dtype)], dim=1)
        if attention_mask is not None:
            ones = torch.ones((input_ids.shape[0], 3), dtype=attention_mask.dtype,
                              device=attention_mask.device)
            attention_mask = torch.cat([ones, attention_mask], dim=1)
        return inputs_embeds, attention_mask

    def forward(self, input_ids, attention_mask=None, labels=None, prof_lvl1=None,
                prof_lvl2=None, prof_lvl3=None, generator: Optional[torch.Generator] = None):
        """(loss, logits); without ``prof_lvl1`` the plain TIGER forward."""
        c = self.cfg.arch
        if prof_lvl1 is not None:
            inputs_embeds, attention_mask = self.build_prefix_inputs(
                input_ids, attention_mask, prof_lvl1, prof_lvl2, prof_lvl3, generator)
            enc_out = self.model.encode(None, attention_mask, inputs_embeds, generator)
        else:
            enc_out = self.model.encode(input_ids, attention_mask, generator=generator)
        dec_in = shift_right(labels, c.decoder_start_token_id, c.pad_token_id)
        logits = self.model.decode(dec_in, enc_out, attention_mask, generator)
        return cross_entropy_with_ignore(logits, labels), logits

    def encode_with_prefix(self, input_ids, attention_mask, prof_lvl1, prof_lvl2, prof_lvl3):
        """(encoder output, extended mask); call in ``.eval()``."""
        inputs_embeds, attention_mask = self.build_prefix_inputs(
            input_ids, attention_mask, prof_lvl1, prof_lvl2, prof_lvl3)
        return self.model.encode(None, attention_mask, inputs_embeds), attention_mask

    def decode(self, decoder_input_ids, enc_out, enc_mask=None):
        return self.model.decode(decoder_input_ids, enc_out, enc_mask)

    def precompute_cross_kv(self, enc_out):
        return self.model.precompute_cross_kv(enc_out)

    def decode_step(self, decoder_prefix_ids, cross_kvs, enc_mask=None, num_beams=None):
        return self.model.decode_step(decoder_prefix_ids, cross_kvs, enc_mask, num_beams)


@torch.no_grad()
def generate(model: TIGERPrefix, input_ids, attention_mask, prof_lvl1, prof_lvl2, prof_lvl3,
             *, num_beams: int, constraint: Optional[ConstraintSpec] = None):
    """Prefix-conditioned beam generation (`RQVAE-T5-prefix/model.py:168-210`)
    on the model's device: tokens (B, num_beams, max_gen_len) int64 with the
    start token, and scores (B, num_beams) f32, best first. The extended
    mask goes to every decode step; the decoder runs incrementally, one new
    position a step, as TIGER's ``generate`` does."""
    cfg = model.cfg
    device = model.model.shared.weight.device
    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    enc_out, ext_mask = model.encode_with_prefix(t(input_ids), t(attention_mask), t(prof_lvl1),
                                                 t(prof_lvl2), t(prof_lvl3))
    # per-sample cross-attention K/V, the beams folded into the query axis
    cross_kvs = model.precompute_cross_kv(enc_out)
    # the earlier positions' self-attention K/V, following the beams' parents
    cache = model.model.start_decode(cross_kvs, ext_mask, num_beams, cfg.max_gen_len - 1)

    def decode_fn(tokens, step):
        return model.model.decode_next(tokens[:, step], step, cache)

    return beam_search(
        decode_fn, enc_out.shape[0], num_beams, cfg.max_gen_len, cfg.arch.vocab_size,
        decoder_start=cfg.arch.decoder_start_token_id,
        pad_token=cfg.arch.pad_token_id,
        eos_token=cfg.arch.eos_token_id,
        constraint=constraint,
        reorder=cache.reorder,
        device=device,
    )
