"""Configuration dataclasses of the port.

A copy of ``genrec_tpu.configs``' ``MeshConfig``, ``TrainerConfig``,
``RQVAEConfig``, ``T5ArchConfig``, ``TIGERConfig``, ``TIGERPrefixConfig``,
``DenseT5Config``, ``SASRecConfig``, ``ShardedEmbeddingConfig``,
``SASRecLargeConfig`` and ``long_context_sasrec_config``: the same fields with the same defaults, so
that a configuration compares field for field with the reference's.
Defaults reproduce the reference configurations (`RQ-VAE/main.py:6-36`,
`RQVAE-T5/main.py:4-35`, `RQVAE-T5/model.py:9-23`,
`RQVAE-T5-prefix/main.py:4-43`, `T5/main.py:5-38`, `SASRec/main.py:6-42`).

``T5ArchConfig.fused_attention`` stays as a field for that comparison, but
the port does not read it: the port always runs attention without a KV
cache (encoder self-attention, and the decoder in full-sequence
``decode``, in training and in eval) through the structured-bias fused
kernels (``ops/t5_attention.py``), forward and backward, with the
attention-weight dropout as the kernels' mask input. The reference's "on"
and "off" compute the same function (its "off" path draws the dropout bits
inside XLA), so nothing is lost; its "auto" gate was set from TPU
measurements and is not carried over.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout (``data`` × ``model`` must divide the device
    count; -1 puts all devices on the data axis)."""

    data_axis: int = -1
    model_axis: int = 1
    axis_names: Tuple[str, str] = ("data", "model")


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """Shared trainer knobs (``train/trainer.py``). The trainer does not
    read ``param_dtype`` and ``compute_dtype``, which the reference reads
    nowhere either (the T5 models' compute dtype is ``T5ArchConfig.dtype``);
    they are kept so TIGERConfig compares with the reference.
    ``bucket_interleave_chunks`` splits each length bucket's (or composite
    width group's) epoch into that many interleaved chunks, and
    ``composite_mix`` is the share of a composite group's rows drawn from
    shorter groups. ``profile_dir``
    traces one epoch, the second of a fit (``utils/profiling.py``).
    ``shard_dataset`` (None: on with more than one rank) splits the
    datasets' rows over the mesh's 'data' axis."""

    batch_size: int = 128
    eval_batch_size: int = 128
    epochs: int = 100
    lr: float = 1e-3
    adam_betas: Tuple[float, float] = (0.9, 0.98)
    weight_decay: float = 0.0
    optimizer: str = "adam"  # adam | adamw | sgd | adagrad | rmsprop
    lr_scheduler: str = "constant"  # constant | linear
    warmup_epochs: int = 0
    grad_clip_norm: Optional[float] = None
    early_stop_patience: int = 10
    seed: int = 42
    ckpt_dir: str = "./ckpt"
    log_path: Optional[str] = None
    loss_plot_path: Optional[str] = None
    results_csv_path: Optional[str] = None
    resume: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    keep_checkpoints: int = 5
    ckpt_every_epochs: int = 1
    bucket_interleave_chunks: int = 4
    profile_dir: Optional[str] = None
    shard_dataset: Optional[bool] = None
    composite_mix: float = 0.5


@dataclasses.dataclass(frozen=True)
class RQVAEConfig:
    """RQ-VAE residual-quantization tokenizer. Mirrors `RQ-VAE/main.py:6-36`."""

    data_path: str = "data/course_item_embs.h5"
    ckpt_dir: str = "./ckpt/course"
    semantic_id_file: str = "data/course/course_rqvae_codes.npy"
    in_dim: int = 768
    num_emb_list: Tuple[int, ...] = (8, 8, 8)
    e_dim: int = 32
    layers: Tuple[int, ...] = (256, 128)
    dropout: float = 0.1
    loss_type: str = "mse"  # mse | l1
    quant_loss_weight: float = 0.1
    beta: float = 0.25
    kmeans_init: bool = True
    kmeans_iters: int = 50
    sk_epsilons: Tuple[float, ...] = (0.01, 0.01, 0.01)
    sk_iters: int = 50
    collision_repair_iters: int = 30  # RQ-VAE/infer.py:108-130
    trainer: TrainerConfig = dataclasses.field(
        default_factory=lambda: TrainerConfig(
            batch_size=64, epochs=100, lr=1e-3, optimizer="adamw",
            weight_decay=1e-4, lr_scheduler="linear", warmup_epochs=5,
            grad_clip_norm=1.0, seed=2024,
        )
    )
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


@dataclasses.dataclass(frozen=True)
class T5ArchConfig:
    """Scratch T5 architecture (HF `T5Config` semantics): relative position
    biases, RMS layer norm, relu feed-forward, tied embeddings with
    d_model**-0.5 logit scaling, unscaled attention.

    ``dtype`` is the computation dtype, "float32" or "bfloat16" (any other
    name raises when a model is built); parameters stay f32 (see the
    ``models/t5.py`` docstring for where bf16 is placed). ``remat``
    checkpoints each block, ``ffn_remat_dropout`` each feed-forward, and
    ``attn_remat_dropout`` draws the attention's dropout mask again in the
    backward instead of keeping it; none of them changes the math."""

    vocab_size: int = 64
    num_layers: int = 2          # encoder layers
    num_decoder_layers: int = 2
    d_model: int = 64
    d_ff: int = 256
    num_heads: int = 4
    d_kv: int = 16
    dropout_rate: float = 0.1
    feed_forward_proj: str = "relu"
    layer_norm_epsilon: float = 1e-6
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    pad_token_id: int = 0
    eos_token_id: int = 31  # overlaps the level-3 code range; kept for parity
    decoder_start_token_id: int = 0  # = pad (RQVAE-T5/model.py:22)
    tie_word_embeddings: bool = True
    fused_attention: str = "auto"  # not read by the port (module docstring)
    dtype: str = "float32"  # computation dtype: float32 | bfloat16 (params stay f32)
    remat: bool = False
    attn_remat_dropout: bool = False
    ffn_remat_dropout: bool = False


@dataclasses.dataclass(frozen=True)
class TIGERConfig:
    """TIGER generative retriever. Mirrors `RQVAE-T5/main.py:4-35`."""

    task_id: str = "task1"
    code_path: str = "data/course/course_rqvae_codes.npy"
    train_dataset_path: str = "data/tiger/train_dataset.h5"
    test_dataset_path: str = "data/tiger/test_dataset.h5"
    arch: T5ArchConfig = dataclasses.field(default_factory=T5ArchConfig)
    codebook_size: int = 8
    code_dim: int = 4  # 3 RQ levels + 1 collision-disambiguation digit
    max_len: int = 20  # history length in items → 80 input tokens
    max_gen_len: int = 5  # decoder_start + 4 code tokens
    beam_size: int = 5
    topk_list: Tuple[int, ...] = (2, 5, 10, 20)
    target_len_buckets: int = 1
    constrained_decoding: str = "level"  # none | level | trie
    trainer: TrainerConfig = dataclasses.field(
        default_factory=lambda: TrainerConfig(batch_size=256, eval_batch_size=256,
                                              epochs=500, lr=1e-3)
    )
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    target_len_composite: int = 0


@dataclasses.dataclass(frozen=True)
class TIGERPrefixConfig:
    """Prefix-conditioned TIGER. Mirrors `RQVAE-T5-prefix/main.py:4-43`."""

    task_id: str = "task1"
    code_path: str = "data/course/course_rqvae_codes.npy"
    train_dataset_path: str = "data/tiger/train_dataset.h5"
    test_dataset_path: str = "data/tiger/test_dataset.h5"
    prof_lvl_paths: Tuple[str, str, str] = (
        "data/prof_lvl1.h5", "data/prof_lvl2.h5", "data/prof_lvl3.h5",
    )
    arch: T5ArchConfig = dataclasses.field(
        default_factory=lambda: T5ArchConfig(
            d_model=128, num_decoder_layers=4, num_heads=8, d_kv=16, d_ff=256,
        )
    )
    bert_dim: int = 768
    num_prof_vectors: int = 5  # top-5 majors per level (prof_lvl*.h5 contract)
    codebook_size: int = 8
    code_dim: int = 4
    max_len: int = 20
    max_gen_len: int = 5
    beam_size: int = 5
    topk_list: Tuple[int, ...] = (2, 5, 10, 20)
    constrained_decoding: str = "level"
    trainer: TrainerConfig = dataclasses.field(
        default_factory=lambda: TrainerConfig(batch_size=256, eval_batch_size=256,
                                              epochs=500, lr=1e-3)
    )
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


@dataclasses.dataclass(frozen=True)
class DenseT5Config:
    """Dense-retrieval T5 encoder. Mirrors `T5/main.py:5-38`.

    num_layers=6, NOT the param dict's 2: the reference's model builder
    (`T5/model.py:9-16`) constructs ``T5Config(d_model, d_ff, num_heads,
    d_kv, dropout_rate)`` and never forwards ``params['num_layers']``, so
    the HF default ``num_layers=6`` silently applies — the model the
    reference actually trains is 6-layer (its own log reports 19,603,328
    params = 16,449,536 dead default 32128-vocab embedding + 3,153,792
    non-embedding; 6 blocks at d512/d_ff256/H4/d_kv16 = 2.37M plus the
    768↔512 in/out projections 0.79M reproduces that exactly, while 2
    blocks would give ~1.58M + 0.79M). We default to the
    reference's *effective* architecture so head-to-heads are
    like-for-like; the param dict's stated intent (2 layers) is available
    by overriding ``arch``.
    """

    task_id: str = "task1"
    rec_path: str = "data/user_item_interact.h5"
    item_emb_h5_path: str = "data/course_item_embs.h5"
    user_emb_h5_path: str = "data/user_profile_embs.h5"
    arch: T5ArchConfig = dataclasses.field(
        default_factory=lambda: T5ArchConfig(
            d_model=512, num_layers=6, num_heads=4, d_kv=16, d_ff=256,
            dropout_rate=0.3,
        )
    )
    input_emb_dim: int = 768
    target_emb_dim: int = 768
    temperature: float = 0.07
    max_seq_len: int = 20
    topk_list: Tuple[int, ...] = (2, 5, 10, 20)
    trainer: TrainerConfig = dataclasses.field(
        default_factory=lambda: TrainerConfig(batch_size=256, eval_batch_size=256,
                                              epochs=100, lr=1e-3)
    )
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    """SASRec self-attentive ranker. Mirrors `SASRec/main.py:6-42`."""

    task_id: str = "task1"
    data_path: str = "data/user_item_interact.h5"
    max_len: int = 20
    d: int = 16
    num_blocks: int = 2
    num_heads: int = 1
    mlp_layer: int = 64
    dropout: float = 0.2
    layernorm_eps: float = 1e-8
    num_neg_samples: int = 10
    loss_eps: float = 1e-24
    min_seq_len: int = 3
    topk_list: Tuple[int, ...] = (2, 5, 10, 20)
    top_k: int = 10
    emb_init_stddev: Optional[float] = None  # None → 1/√d; 1.0 = torch nn.Embedding's N(0, 1)
    trainer: TrainerConfig = dataclasses.field(
        default_factory=lambda: TrainerConfig(batch_size=128, eval_batch_size=128,
                                              epochs=100, lr=1e-3)
    )
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


@dataclasses.dataclass(frozen=True)
class ShardedEmbeddingConfig:
    """The item table of ``SASRecLarge``: (vocab_size, dim) rows in
    ``dtype`` (float32 or bfloat16), row-sharded over the mesh's 'model'
    axis (``models/sasrec_large.py``, ``ops/embedding.py``)."""

    vocab_size: int = 10_000_000
    dim: int = 64
    ids_per_device_capacity: int = 8192
    dtype: str = "float32"

    def preferred_lookup(self, capacity_factor: float = 2.0) -> str:
        """The reference's byte-crossover rule between its two sharded
        lookups: all_to_all iff capacity_factor < 2·D/(D+1), else psum."""
        return ("alltoall"
                if capacity_factor < 2.0 * self.dim / (self.dim + 1.0)
                else "psum")


@dataclasses.dataclass(frozen=True)
class SASRecLargeConfig:
    """SASRec tower over a (V+1, dim) item table with sampled-BCE training
    (`genrec_tpu/models/sasrec_large.py`)."""

    max_len: int = 20
    num_blocks: int = 2
    num_heads: int = 2
    mlp_layer: int = 256
    dropout: float = 0.2
    layernorm_eps: float = 1e-8
    num_neg_samples: int = 64
    loss_eps: float = 1e-24
    topk_list: Tuple[int, ...] = (10, 100)
    context_parallel_axis: Optional[str] = None
    embedding: ShardedEmbeddingConfig = dataclasses.field(
        default_factory=ShardedEmbeddingConfig)
    trainer: TrainerConfig = dataclasses.field(
        default_factory=lambda: TrainerConfig(batch_size=4096, lr=1e-3))
    mesh: MeshConfig = dataclasses.field(
        default_factory=lambda: MeshConfig(data_axis=-1, model_axis=2))


def long_context_sasrec_config(max_len: int = 2048, dim: int = 64) -> SASRecLargeConfig:
    """The reference's long-context configuration: 2048-item histories,
    65,536 items at ``dim``, 2 blocks of 4 heads, batch 32, 64 negatives.
    On one device its attention runs through the flash kernels
    (``ops/attention.py``) once L ≥ 512 and no attention dropout is drawn."""
    return SASRecLargeConfig(
        max_len=max_len, num_blocks=2, num_heads=4, mlp_layer=4 * dim,
        dropout=0.2, num_neg_samples=64, context_parallel_axis="ctx",
        embedding=ShardedEmbeddingConfig(vocab_size=65536, dim=dim),
        trainer=TrainerConfig(batch_size=32, lr=1e-3))


def replace(cfg, **kw):
    """Functional config override: `replace(SASRecConfig(), d=64)`."""
    return dataclasses.replace(cfg, **kw)
