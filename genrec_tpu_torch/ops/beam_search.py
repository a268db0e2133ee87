"""Fixed-shape beam search with optional constrained decoding.

Counterpart of ``genrec_tpu/ops/beam_search.py``: beam tensors are
(B, beams, max_len) and beams fold into the batch dimension for the decoder
call. The JAX reference's decoder re-attends over the live prefix at every
step; the port's models decode incrementally, with the same mathematics:
``decode_fn`` runs the decoder over the one new position, its
self-attention reading the earlier positions' K/V from a cache, and the
optional ``reorder`` callback gathers that cache by each survivor's parent
beam after the step's selection. Modes:
``none`` (unconstrained), ``level`` (each step masked to its semantic-ID
level range) and ``trie`` (a prefix trie over the actual item codes, so
every decoded tuple is a real item). A beam that emits eos is frozen and
extends with pad at zero cost. Beams 1.. start at −1e30, so many candidates
tie exactly at −1e30 or −2e30: the top-k and the final ordering use
STABLE sorts, keeping the lower flat index first on ties as
``lax.top_k`` and ``jnp.argsort`` do, so tokens match the reference
exactly.

Under the trie the search walks a node table over the prefixes that exist
(``data/tiger_tokens.build_trie_nodes``) and sorts only the candidates that
can win: each beam's W child tokens of the step's level (digit d is token
``token_base + step·K + d``) and the first K + 1 tokens outside them. Every
other token of a beam is ruled out (for a frozen beam: is not pad), so its
candidate ties with those K + 1 at the beam's score − 1e30 and a stable
sort ranks them first: the kept candidates, in flat-index order, give the
top K of all K·V exactly, ties included.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from genrec_tpu_torch.utils.profiling import span, wait_span

_NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class ConstraintSpec:
    """Decode-constraint tables (any device; moved to the search's)."""

    mode: str = "none"  # none | level | trie
    level_masks: Optional[torch.Tensor] = None    # (steps, V) bool
    trie_children: Optional[torch.Tensor] = None  # (nodes, W) int64, node 0 the root
    trie_allowed: Optional[torch.Tensor] = None   # (nodes, W) bool
    codebook_size: int = 8
    token_base: int = 1  # token of digit d at level p: token_base + p·codebook_size + d

    def to(self, device) -> "ConstraintSpec":
        move = lambda t: None if t is None else t.to(device)  # noqa: E731
        return dataclasses.replace(self, level_masks=move(self.level_masks),
                                   trie_children=move(self.trie_children),
                                   trie_allowed=move(self.trie_allowed))


def beam_search(
    decode_fn: Callable[[torch.Tensor, int], torch.Tensor],
    batch_size: int,
    num_beams: int,
    max_len: int,
    vocab_size: int,
    *,
    decoder_start: int = 0,
    pad_token: int = 0,
    eos_token: Optional[int] = None,
    constraint: Optional[ConstraintSpec] = None,
    reorder: Optional[Callable[[torch.Tensor], None]] = None,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run beam search on ``device``.

    ``decode_fn(tokens, step)`` maps the (B*beams, max_len) token buffer and
    the 0-based step index to next-token logits (B*beams, V) for position
    ``step + 1``. ``reorder(flat_parents)``, where given, is called after
    each step's selection that another step follows, with the (B*beams,)
    flat row index b·beams + parent beam of each surviving beam, so that a
    ``decode_fn`` holding per-row state (a K/V cache) can follow the beams.
    Returns (tokens (B, beams, max_len) int64, scores (B, beams) f32)
    sorted by descending score.

    Spans (``utils.profiling.span``): ``beam.search``, all of it;
    ``beam.search.wait``, the blocking copies of two scalars to a card
    (the frozen row's 0 and −1e30); and at each step ``beam.decode`` (the
    ``decode_fn`` call) and ``beam.select`` (log-softmax, masks, the stable
    sort and the gathers).
    """
    with span("beam.search"):
        constraint = (constraint or ConstraintSpec()).to(device)
        B, K, V = batch_size, num_beams, vocab_size
        steps = max_len - 1

        tokens = torch.full((B, K, max_len), pad_token, dtype=torch.int64, device=device)
        tokens[:, :, 0] = decoder_start
        scores = torch.full((B, K), _NEG_INF, dtype=torch.float32, device=device)
        scores[:, 0] = 0.0
        finished = torch.zeros((B, K), dtype=torch.bool, device=device)
        node = torch.zeros((B, K), dtype=torch.int64, device=device)  # trie walk state
        frozen_row = torch.full((V,), _NEG_INF, dtype=torch.float32, device=device)
        if constraint.mode == "trie":
            kc, width = constraint.codebook_size, constraint.trie_allowed.shape[1]
            n_cand = K + 1 + width
            slot = torch.arange(n_cand, device=device)
        row_base = torch.arange(0, B * K, K, device=device)[:, None] if reorder else None
        with wait_span("beam.search.wait", device):  # two scalars from pageable memory
            frozen_row[pad_token] = 0.0
            neg = torch.tensor(_NEG_INF, dtype=torch.float32, device=device)

        for step in range(steps):
            with span("beam.decode"):
                logits = decode_fn(tokens.view(B * K, max_len), step)  # (BK, V)
            with span("beam.select"):
                logp = torch.log_softmax(logits, dim=-1, dtype=torch.float32).view(B, K, V)

                if constraint.mode == "trie":
                    lo = constraint.token_base + step * kc  # digit 0's token at this level
                    below = min(K + 1, lo)
                    if lo + n_cand - below > V:
                        raise ValueError("the trie's tokens run past the vocabulary")
                    cand_tok = torch.where(slot < below, slot, slot + (lo - below))  # (C,)
                    col = cand_tok - lo
                    allowed = (constraint.trie_allowed[node][:, :, col.clamp(0, width - 1)]
                               & (col >= 0) & (col < width))                  # (B, K, C)
                    logp = torch.gather(logp, 2, cand_tok.expand(B, K, n_cand))
                    logp = torch.where(allowed, logp, neg)
                    frozen = frozen_row[cand_tok]
                else:
                    if constraint.mode == "level":
                        logp = torch.where(constraint.level_masks[step][None, None, :], logp, neg)
                    cand_tok, frozen = None, frozen_row

                # frozen beams may only extend with pad at zero cost
                logp = torch.where(finished[:, :, None], frozen, logp)

                width_c = logp.shape[2]
                cand = (scores[:, :, None] + logp).view(B, K * width_c)
                top_scores, top_idx = torch.sort(cand, dim=1, descending=True, stable=True)
                top_scores, top_idx = top_scores[:, :K], top_idx[:, :K]
                beam_idx = top_idx // width_c
                tok_idx = top_idx % width_c
                if cand_tok is not None:
                    tok_idx = cand_tok[tok_idx]

                tokens = torch.gather(tokens, 1, beam_idx[:, :, None].expand(B, K, max_len))
                tokens[:, :, step + 1] = tok_idx
                finished = torch.gather(finished, 1, beam_idx)
                scores = top_scores

                if eos_token is not None:
                    finished = finished | (tok_idx == eos_token)
                if constraint.mode == "trie":
                    code = torch.clamp(tok_idx - lo, 0, kc - 1)
                    node = constraint.trie_children[torch.gather(node, 1, beam_idx), code]
                if reorder is not None and step + 1 < steps:
                    reorder((beam_idx + row_base).view(B * K))

        scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
        tokens = torch.gather(tokens, 1, order[:, :, None].expand(B, K, max_len))
        return tokens, scores
