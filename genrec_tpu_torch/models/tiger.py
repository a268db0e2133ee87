"""TIGER: generative retrieval over semantic-ID sequences.

Counterpart of ``genrec_tpu/models/tiger.py``: a scratch-config T5
encoder-decoder over the 64-token offset-code vocabulary, with beam-search
generation returning ``num_beams`` sequences per sample (``max_gen_len``
tokens including the decoder start) under an optional level or trie
constraint (``ops/beam_search.py``). The forward returns (loss, logits) and
trains with dropout in training mode; generation wants ``.eval()``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from genrec_tpu_torch.configs import TIGERConfig
from genrec_tpu_torch.data import tiger_tokens
from genrec_tpu_torch.models.t5 import T5EncoderDecoder
from genrec_tpu_torch.ops.beam_search import ConstraintSpec, beam_search
from genrec_tpu_torch.utils.profiling import span


class TIGER(nn.Module):
    """The reference's ``TIGER`` module: parameters live under ``model.``
    (``convert.tiger_params_from_flax`` fills them from a Flax tree)."""

    def __init__(self, cfg: TIGERConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.model = T5EncoderDecoder(cfg.arch, generator)

    def forward(self, input_ids, attention_mask=None, labels=None,
                generator: Optional[torch.Generator] = None):
        """(loss, logits) like `RQVAE-T5/model.py:42-60`. In training mode
        (``.train()``) with ``arch.dropout_rate > 0`` dropout is on, its masks
        drawn from ``generator``; in ``.eval()`` the forward is deterministic."""
        return self.model(input_ids, attention_mask, labels, generator=generator)

    def encode(self, input_ids, attention_mask=None):
        return self.model.encode(input_ids, attention_mask)

    def decode(self, decoder_input_ids, enc_out, enc_mask=None):
        return self.model.decode(decoder_input_ids, enc_out, enc_mask)

    def precompute_cross_kv(self, enc_out):
        return self.model.precompute_cross_kv(enc_out)

    def decode_step(self, decoder_prefix_ids, cross_kvs, enc_mask=None, num_beams=None):
        return self.model.decode_step(decoder_prefix_ids, cross_kvs, enc_mask, num_beams)


def make_constraint(cfg: TIGERConfig, codes: Optional[np.ndarray] = None) -> ConstraintSpec:
    """Decode-constraint tables for a TIGER config, on the CPU (the beam
    search moves them to its device)."""
    a = cfg.arch
    steps = cfg.max_gen_len - 1
    if cfg.constrained_decoding == "none":
        return ConstraintSpec(mode="none")
    if cfg.constrained_decoding == "level":
        masks = tiger_tokens.build_level_masks(a.vocab_size, cfg.codebook_size, steps)
        return ConstraintSpec(mode="level", level_masks=torch.from_numpy(masks))
    if cfg.constrained_decoding == "trie":
        if codes is None:
            raise ValueError("trie mode needs the item code table")
        children, allowed = tiger_tokens.build_trie_nodes(codes, cfg.codebook_size)
        return ConstraintSpec(mode="trie", trie_children=torch.from_numpy(children),
                              trie_allowed=torch.from_numpy(allowed),
                              codebook_size=cfg.codebook_size, token_base=1)
    raise ValueError(cfg.constrained_decoding)


@torch.no_grad()
def generate(model: TIGER, input_ids, attention_mask, *, num_beams: int,
             constraint: Optional[ConstraintSpec] = None):
    """Beam-search generation on the model's device: tokens
    (B, num_beams, max_gen_len) int64 including the start token, and
    scores (B, num_beams) f32, best first. The decoder runs incrementally:
    one new position a step, the earlier positions' self-attention K/V read
    from a :class:`~genrec_tpu_torch.models.t5.DecodeCache` that beam search
    reorders by the beams' parents. Spans (``utils.profiling.span``):
    ``generate.encode``, the encoder, the cross K/V and the cache, then beam
    search's (``ops.beam_search.beam_search``)."""
    cfg = model.cfg
    device = model.model.shared.weight.device
    input_ids = torch.as_tensor(input_ids, device=device)
    attention_mask = torch.as_tensor(attention_mask, device=device)
    with span("generate.encode"):
        enc_out = model.encode(input_ids, attention_mask)
        # cross-attention K/V projected once per SAMPLE and kept per sample:
        # decode folds the beams into the cross-attention query axis
        cross_kvs = model.precompute_cross_kv(enc_out)
        cache = model.model.start_decode(cross_kvs, attention_mask, num_beams,
                                         cfg.max_gen_len - 1)

    def decode_fn(tokens, step):
        return model.model.decode_next(tokens[:, step], step, cache)

    return beam_search(
        decode_fn, input_ids.shape[0], num_beams, cfg.max_gen_len, cfg.arch.vocab_size,
        decoder_start=cfg.arch.decoder_start_token_id,
        pad_token=cfg.arch.pad_token_id,
        eos_token=cfg.arch.eos_token_id,
        constraint=constraint,
        reorder=cache.reorder,
        device=device,
    )
