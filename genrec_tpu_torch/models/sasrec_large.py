"""SASRec at catalog scale: counterpart of ``genrec_tpu/models/sasrec_large.py``.

It departs from the parity SASRec (``models/sasrec.py``) as the reference
does: the item table is one (V+1, D) parameter ``item_table`` read by a
pad-masked row gather, and training scores only the positive row and
``num_neg_samples`` sampled negative rows per position (sampled BCE), so the
(B, n, V) score matrix never exists. The tower (positional embedding,
pre-norm causal blocks, final LayerNorm) is :class:`SASRecBlock` unchanged;
at the long-context configuration (``configs.long_context_sasrec_config``,
L ≥ 512) its attention runs through the flash kernels whenever no attention
dropout is drawn (``ops/attention.dot_product_attention``).

Over a mesh (``parallel/mesh.py``) the table is row-sharded over 'model'
(``use_sharded=True``, the default): each rank holds V/M rows, reads go
through the psum or all_to_all lookup (``ops/embedding.py``) and
``predict_topk`` through :func:`sharded_topk_scores`. Without a mesh the
model is the 1 × 1 case: the same code, every collective the identity. The
table may be stored in bfloat16 (``cfg.embedding.dtype``); its rows are
upcast to f32 before every product, as JAX promotes them. ``ctx_axis``
shards the sequence over a mesh axis and runs every block's attention as
the ring of ``ops/ring_attention.py``.

On a (data, ctx, model) mesh (``parallel.mesh.make_named_mesh``), as the
reference's ``tests/test_long_context.py`` composes it, the three compose:
the batch rows on 'data', the ring on 'ctx' and the table row-sharded on
'model'; the losses' sums and the gradients go over the (data, ctx) group.
One axis cannot carry both the ring and the table.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

from genrec_tpu_torch.configs import SASRecLargeConfig
from genrec_tpu_torch.models.sasrec import SASRecBlock, _bce
from genrec_tpu_torch.ops.embedding import alltoall_embedding_lookup, sharded_embedding_lookup
from genrec_tpu_torch.ops.negative_sampling import sample_negatives
from genrec_tpu_torch.parallel.mesh import ONE_BY_ONE, Mesh, all_reduce_sum
from genrec_tpu_torch.parallel.sharding import shard_tensor

TOPK_CHUNK_ROWS = 1 << 20  # table rows scored at a time: a bf16 table's f32 upcast stays 256 MB


def _upcast(t: torch.Tensor) -> torch.Tensor:
    """``t`` in f32 at least: a bf16 table's rows in f32 (exact), f32 and
    f64 as they are."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _chunked_topk(h: torch.Tensor, table: torch.Tensor,
                  k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (values, row indices) of ``h @ table.T`` in f32 (or f64),
    scoring ``TOPK_CHUNK_ROWS`` rows at a time (a bf16 chunk upcast) and merging
    each chunk's top-k: the (B, V) logits never exist whole."""
    h = _upcast(h)
    vals, idx = [], []
    for lo in range(0, table.shape[0], TOPK_CHUNK_ROWS):
        logits = h @ _upcast(table[lo:lo + TOPK_CHUNK_ROWS]).T
        v, i = torch.topk(logits, min(k, logits.shape[1]), dim=-1)
        vals.append(v)
        idx.append(i + lo)
    if len(vals) == 1:
        return vals[0], idx[0]
    v, j = torch.topk(torch.cat(vals, 1), k, dim=-1)
    return v, torch.gather(torch.cat(idx, 1), 1, j)


def sharded_topk_scores(table_shard: torch.Tensor, h: torch.Tensor, k: int,
                        mesh: Mesh, *, axis_name: str = "model"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of ``h @ table.T`` over a table row-sharded on
    ``axis_name`` (this rank holds ``table_shard``) without the (B, V)
    logits: each shard takes its local top-k, its rows' global index is
    local + model index · rows, one ``all_gather`` of the (B, kk) candidates
    gives (B, M·kk) in shard order, and a last top-k picks k."""
    rows = table_shard.shape[0]
    v, i = _chunked_topk(h, table_shard, min(k, rows))
    group = mesh.group(axis_name)
    if group is None:
        return v, i
    i = i + mesh.index(axis_name) * rows
    n = mesh.size(axis_name)
    v_all, i_all = [torch.empty_like(v) for _ in range(n)], [torch.empty_like(i) for _ in range(n)]
    dist.all_gather(v_all, v.contiguous(), group=group)
    dist.all_gather(i_all, i.contiguous(), group=group)
    vv, jj = torch.topk(torch.cat(v_all, 1), k, dim=-1)
    return vv, torch.gather(torch.cat(i_all, 1), 1, jj)


class SASRecLarge(nn.Module):
    """SASRec tower over a (V+1, D) item table, row-sharded over the mesh's
    'model' axis when ``use_sharded`` (V+1 must divide it).

    ``lookup_impl`` selects the sharded read: ``"psum"`` (masked gather and
    all-reduce), ``"alltoall"`` (id exchange at ``alltoall_capacity``; an
    overflowing id reads a zero row and gets no gradient) or ``"auto"``,
    the reference's byte rule ``ShardedEmbeddingConfig.preferred_lookup``.
    ``ctx_axis`` names the mesh axis the sequence is sharded over (each rank
    holds L/C positions, attention runs as a ring over it, without
    attention dropout, as in the reference); ``ctx_batch_axis`` the axis the
    batch rows are sharded over beside it (None: every rank of the other
    axis holds the same rows). ``generator`` draws the weights; each rank
    draws the whole table and keeps its rows."""

    def __init__(self, item_num: int, cfg: SASRecLargeConfig, *, mesh: Optional[Mesh] = None,
                 use_sharded: bool = True, lookup_impl: str = "auto",
                 alltoall_capacity: float = 2.0, ctx_axis: Optional[str] = None,
                 ctx_batch_axis: Optional[str] = "data",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.item_num = item_num
        self.cfg = cfg
        self.mesh = mesh = mesh if mesh is not None else ONE_BY_ONE
        self.use_sharded = use_sharded
        self.lookup_impl = lookup_impl
        self.alltoall_capacity = alltoall_capacity
        self.ctx_axis = ctx_axis
        self.ctx_batch_axis = ctx_batch_axis
        V, dim = item_num + 1, cfg.embedding.dim
        model_dim = mesh.size("model")
        assert V % model_dim == 0, (
            f"padded vocab {V} must divide the model axis {model_dim}; round item_num up")
        if ctx_axis is not None and use_sharded and ctx_axis == "model" and model_dim > 1:
            raise NotImplementedError(
                "the table's 'model' axis cannot also carry the sequence: put the ring on an "
                "axis of its own (a data x ctx x model mesh) or pass use_sharded=False")
        table = torch.empty(V, dim)
        self.pos_emb = nn.Embedding(cfg.max_len, dim)
        with torch.no_grad():
            nn.init.normal_(table, 0.0, 1.0 / math.sqrt(dim), generator=generator)
            nn.init.normal_(self.pos_emb.weight, 0.0, 1.0 / math.sqrt(dim), generator=generator)
        if use_sharded:
            table = shard_tensor(table, ("model", None), mesh)
        self.item_table = nn.Parameter(table.to(getattr(torch, cfg.embedding.dtype)).contiguous())
        attn_fn = None
        if ctx_axis is not None:
            from genrec_tpu_torch.ops.ring_attention import ring_multi_head_attention

            def attn_fn(q, k, v, *, num_heads, causal=True, dropout_rate=0.0, generator=None):
                # the reference's ring takes no attention-weight dropout: the
                # kwargs are accepted so SASRecBlock passes them alike
                del dropout_rate, generator
                return ring_multi_head_attention(q, k, v, mesh, num_heads=num_heads,
                                                 axis_name=ctx_axis, causal=causal)
        self.blocks = nn.ModuleList(
            SASRecBlock(dim, cfg.num_heads, cfg.mlp_layer, cfg.dropout, cfg.layernorm_eps,
                        attn_fn=attn_fn, generator=generator)
            for _ in range(cfg.num_blocks))
        self.last_norm = nn.LayerNorm(dim, eps=cfg.layernorm_eps)

    def _resolved_lookup(self) -> str:
        if self.lookup_impl != "auto":
            return self.lookup_impl
        return self.cfg.embedding.preferred_lookup(self.alltoall_capacity)

    def batch_group(self):
        """The group of the ranks that hold other rows or positions of the
        batch (the batch axis, and the context axis): the one a loss's sums
        and its gradients are summed over. None without a process group."""
        batch_axis = self.ctx_batch_axis if self.ctx_axis is not None else "data"
        return self.mesh.group_over((batch_axis, self.ctx_axis))

    def embed(self, ids):
        """Pad-masked row gather (torch ``padding_idx=0`` semantics): row 0
        reads zero and gets zero gradient through the mask product. Rows come
        back in f32 at least (a bf16 table's upcast, exact). The replicated gather is
        ``F.embedding``: the backward of advanced indexing took most of a
        long-context train step's device time on the H100 (PERF.md)."""
        if self.use_sharded and self._resolved_lookup() == "alltoall":
            e, _ok = alltoall_embedding_lookup(self.item_table, ids, self.mesh,
                                               capacity_factor=self.alltoall_capacity)
        elif self.use_sharded:
            e = sharded_embedding_lookup(self.item_table, ids, self.mesh)
        else:
            e = F.embedding(ids, self.item_table)
        return _upcast(e * (ids != 0)[..., None].to(e.dtype))

    def _positions(self, n: int):
        """The positional rows of this rank's n positions: with ``ctx_axis``
        those of its block of the sequence."""
        c = self.mesh.index(self.ctx_axis) if self.ctx_axis is not None else 0
        return self.pos_emb.weight[c * n:(c + 1) * n]

    def forward(self, log_seqs, generator: Optional[torch.Generator] = None):
        x = self.embed(log_seqs) + self._positions(log_seqs.shape[1])[None]
        for blk in self.blocks:
            x = blk(x, generator)
        return self.last_norm(x)

    def sampled_scores(self, inputs, targets, neg_ids,
                       generator: Optional[torch.Generator] = None):
        """(pos_scores (B, n), neg_scores (B, n, K)): only 1 + K rows of the
        table are read per position, never the (B, n, V) matrix."""
        feats = self(inputs, generator)
        pos_scores = (feats * self.embed(targets)).sum(dim=-1)
        neg_scores = torch.einsum("bnd,bkd->bnk", feats, self.embed(neg_ids))
        return pos_scores, neg_scores

    @torch.no_grad()
    def predict_topk(self, log_seqs, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Exact top-k (values, item ids) of the last position over the whole
        table, row 0 included, scored in f32. With ``ctx_axis`` the last
        position lives on the last rank of the context axis, which sends its
        features to the others."""
        h_t = self(log_seqs)[:, -1, :].contiguous()
        group = self.mesh.group(self.ctx_axis) if self.ctx_axis is not None else None
        if group is not None:
            dist.broadcast(h_t, dist.get_global_rank(group, self.mesh.size(self.ctx_axis) - 1),
                           group=group)
        if self.use_sharded:
            return sharded_topk_scores(self.item_table, h_t, k, self.mesh)
        return _chunked_topk(h_t, self.item_table, k)


def train_loss_sampled(model: SASRecLarge, inputs, targets,
                       generator: Optional[torch.Generator], cfg: SASRecLargeConfig,
                       item_num: int, neg=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sampled-BCE training loss, with the parity loss's masking and
    normalisation (`SASRec/train.py:140-168`); returns (normalised loss,
    valid-timestep count). ``neg`` (B, K) defaults to ``sample_negatives``
    from ``generator`` against the full rated set, history AND shifted
    targets (the reference's setdiff1d-vs-rated, `SASRec/train.py:15-30`);
    with ``ctx_axis`` the rows' positions are gathered from the whole
    context axis first.

    Over a mesh the sums run over this rank's rows and positions and the
    valid count over the model's :meth:`~SASRecLarge.batch_group`, so the
    group's losses add up to the batch's loss and their gradients to its
    gradient; the count returned is the batch's."""
    if neg is None:
        rated = torch.cat([inputs, targets], dim=1)
        ctx = model.mesh.group(model.ctx_axis)
        if ctx is not None:
            parts = [torch.empty_like(rated) for _ in range(model.mesh.size(model.ctx_axis))]
            dist.all_gather(parts, rated.contiguous(), group=ctx)
            rated = torch.cat(parts, dim=1)
        neg = sample_negatives(generator, rated, item_num, cfg.num_neg_samples)
    pos_scores, neg_scores = model.sampled_scores(inputs, targets, neg, generator)
    mask = (targets != 0).float()
    pos_loss = _bce(pos_scores, True, cfg.loss_eps) * mask
    neg_loss = _bce(neg_scores, False, cfg.loss_eps).sum(dim=-1) * mask
    valid = all_reduce_sum(mask.sum(), model.batch_group())
    return (pos_loss + neg_loss).sum() / torch.clamp(valid, min=1.0), valid


def make_train_step(model: SASRecLarge, optimizer: torch.optim.Optimizer,
                    cfg: SASRecLargeConfig, item_num: int):
    """``step(inputs, targets, generator, neg=None) -> loss``: one forward in
    training mode, backward and ``optimizer`` update of ``model`` in place.
    The reference steps ``optax.adam(lr)``; ``torch.optim.Adam(lr=lr,
    betas=(0.9, 0.999), eps=1e-8)`` computes the same update. Over a mesh
    each rank passes its rows (and positions) of the batch; the gradients
    are summed over the batch group before the update, and the loss
    returned is the batch's."""
    group = model.batch_group()

    def step(inputs, targets, generator: Optional[torch.Generator], neg=None):
        model.train()
        loss, _ = train_loss_sampled(model, inputs, targets, generator, cfg, item_num, neg)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if group is not None:
            for p in model.parameters():
                if p.grad is not None:
                    dist.all_reduce(p.grad, group=group)
        optimizer.step()
        return all_reduce_sum(loss.detach(), group)

    return step
