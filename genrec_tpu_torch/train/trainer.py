"""The port's Trainer.

Counterpart of ``genrec_tpu/train/trainer.py``'s ``Trainer`` on its
device-resident path, on one device or data-parallel over a mesh:

- the datasets are uploaded to the device once; each epoch's shuffled index
  matrix is built as the reference's ``_index_matrix`` builds it, seeded
  ``cfg.seed + epoch``, so the batch order equals the reference's; each step
  index-gathers its batch on the device, with -1 padding and a ``valid``
  mask;
- a step is forward, backward and one update of ``optim.make_optimizer``
  (clip, optimizer, schedule); dropout draws from one ``torch.Generator``
  on the device, seeded ``cfg.seed``;
- the loss sums stay on the device and are read once per epoch;
- per-epoch validation loss, early stop on ``early_stop_patience``, the best
  parameters snapshot (``best.pt``), latest-state checkpoints every
  ``ckpt_every_epochs`` with ``keep_checkpoints`` retention, resume, the
  abort on a non-finite loss, and an ``epoch_end_callback(epoch, trainer)``
  after each epoch's latest-state save.

Data-parallel (a ``mesh`` from ``parallel.auto.dp_shardings``), with the
reference's semantics:

- replicated datasets: every rank holds the full arrays, builds the same
  global index matrix and takes its data index's columns
  ``[d·B/D, (d+1)·B/D)``, JAX's ``P('data')`` rows;
- sharded datasets (``cfg.shard_dataset``, on by default with more than one
  rank): each rank uploads only its data index's block of rows, and the
  batches come from the reference's ``_index_matrix_sharded``, so N ranks
  step the batches of a JAX run on an N-device data axis;
- each step's loss is scaled by local valid · D / global valid before the
  backward, so that DDP's mean over the 'data' group is the gradient of the
  global batch's sum / valid, as JAX computes it (DDP alone would average
  per-rank means); ranks of one data row hold the same batch and tower, so
  gradients are reduced over the 'data' group only;
- dropout draws from a generator seeded from (``cfg.seed``, data index):
  ranks of one data row draw alike, and data index 0 draws the
  single-device stream;
- rank 0 alone writes checkpoints, ``best.pt`` and plots, then every rank
  meets at a barrier; resume reads on every rank, and checkpoints hold the
  bare model's names (no ``module.``);
- validation: each rank scores its columns and the sums are all-reduced.

Tensor-parallel (``param_specs`` from ``parallel.auto.param_shardings``, a
mesh whose 'model' axis is above 1), as the reference's ``device_put`` of
the initialised parameters under their shardings:

- every rank builds the whole model from the same seed; the Trainer cuts
  the parameters whose spec splits them over 'model' to this rank's block
  (``parallel.tensor.shard_model_``) before it makes the optimizer, and the
  modules run the collectives (``models/t5.py``, ``models/sasrec.py``);
  DDP over 'data' is unchanged, each data group holding one block;
- the global-norm clip sums the cut parameters' squares over 'model';
- checkpoints, ``best_params`` and ``final_params`` hold the whole tensors,
  parameters and optimizer state alike (``parallel.tensor.gather_state``),
  as the reference's store of global arrays does: a checkpoint resumes on
  the same mesh (cut again on load) and loads into a one-device model.

Length-bucketed training (``train_data_buckets``, the reference's
``:250-262`` and ``:618-668``): each bucket is a dataset of its own width,
uploaded once (padded and row-sharded per bucket in sharded-dataset mode).
Each epoch, bucket ``bi``'s index matrix is seeded ``cfg.seed + epoch + bi ·
1000003`` and split into ``min(cfg.bucket_interleave_chunks, steps)`` chunks
of consecutive steps (``np.array_split``); with more than one bucket the
chunks run in the order of a shuffle seeded ``cfg.seed · 7919 + epoch``. One
bucket is the flat path. The schedule counts Σ ceil(n_b / B) steps an epoch.

Composite widths (``composite_widths``, ``row_widths``; the reference's
``:330-367``, ``:472-516`` and ``:593-616``): one flat dataset; each epoch
:meth:`Trainer._composite_plan` (seeded ``cfg.seed + epoch``) assigns every
row to one group of a static width at least its own, its chunks interleaved
as above, and each group's batches have their ``width_slice_keys`` sliced
to the group's width before the loss (no slice at full width);
``widths_run`` records the widths that ran. Not with buckets, nor with
sharded datasets (``ValueError``, where the reference asserts).

``cfg.profile_dir`` traces one epoch, ``min(first epoch of this fit + 1,
cfg.epochs)``, as the reference does: the first one is warm-up (kernel
builds, allocator growth). The trace (``utils/profiling.trace``) spans the
epoch's steps and the read of its loss sums; each epoch's steps lie in a
"train epoch <n>" range.

Streaming (neither ``train_data`` nor ``train_data_buckets``; the
reference's ``:413-430``, ``:529-551`` and ``:664-672``): ``fit`` takes
``BatchIterFactory``s and each epoch trains on ``train_batches(epoch)``,
numpy batches that :meth:`Trainer._put` sends to the device; the schedule
counts the caller's ``steps_per_epoch``. On the card a batch is copied into
reused pinned buffers and sent with ``non_blocking`` copies on a side stream
(:class:`_PinnedUploads`), as ``jax.device_put`` sends asynchronously, and
``fit`` puts batch k + 1 after step k is enqueued, so that the copy runs
beside step k's kernels. Under DDP each rank's factories yield its own rows
of every global batch (``parallel.mesh.process_rows``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from genrec_tpu_torch.configs import TrainerConfig
from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.parallel.mesh import Mesh, all_reduce_sum, is_main_process, write_once
from genrec_tpu_torch.parallel.sharding import Spec, shard_tensor
from genrec_tpu_torch.parallel.tensor import gather_state, gather_tensor, shard_model_
from genrec_tpu_torch.train.checkpoint import CheckpointStore
from genrec_tpu_torch.train.optim import make_optimizer
from genrec_tpu_torch.utils.misc import get_logger
from genrec_tpu_torch.utils.plotting import plot_loss_curves
from genrec_tpu_torch.utils.profiling import annotate, span, trace

Batch = Dict[str, torch.Tensor]
# loss_fn(model, batch, generator) -> (loss, aux); aux holds "sum_loss" and
# "valid", whose sums give the per-valid-normalized epoch means. The
# validation loss runs in eval mode (no dropout) with the same generator, from
# which a loss may draw what else it samples (SASRec's negatives).
LossFn = Callable[[nn.Module, Batch, Optional[torch.Generator]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
# train_batches(epoch) / val_batches(epoch) of the streaming fit: numpy
# batches, each this rank's rows of a global batch
BatchIterFactory = Callable[[int], Iterator[Dict[str, np.ndarray]]]


@dataclasses.dataclass
class TrainLoopResult:
    best_params: Dict[str, torch.Tensor]
    final_params: Dict[str, torch.Tensor]
    train_losses: List[float]
    val_losses: List[float]
    best_val_loss: float
    epochs_run: int
    examples_per_sec: float
    # excludes the first epoch run (warm-up: kernel builds, allocator growth)
    steady_examples_per_sec: float = 0.0
    # wall-clock breakdown: train / val / ckpt seconds, wall, the first epoch
    phase_seconds: Optional[Dict[str, float]] = None
    steps_run: int = 0  # optimizer steps taken by this fit()


class _LossModule(nn.Module):
    """The model and its loss as one module, so that DDP's forward runs the
    whole loss (which may call any of the model's methods)."""

    def __init__(self, model: nn.Module, loss_fn: LossFn):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, batch: Batch, generator: Optional[torch.Generator]):
        return self.loss_fn(self.model, batch, generator)


class _PinnedUploads:
    """Host-to-device copies of numpy batches on the card, asynchronous as
    ``jax.device_put``'s: each array is copied into a pinned staging buffer
    kept for its (name, shape, dtype), then sent with ``non_blocking=True``
    on a side stream. Two sets of buffers take turns, and a set is refilled
    only after the event of its last copy has completed. The caller's stream
    waits on the copy's event before it uses the batch, and each tensor is
    ``record_stream``-ed on it, so that the caching allocator gives its
    memory to no other tensor before that stream has used it."""

    SLOTS = 2

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._buffers: List[Dict[tuple, torch.Tensor]] = [{} for _ in range(self.SLOTS)]
        self._done: List[Optional[torch.cuda.Event]] = [None] * self.SLOTS
        self._turn = 0

    def put(self, batch: Dict[str, np.ndarray]) -> Batch:
        """The batch on the device, ready to use on the current stream. Spans
        (``utils.profiling.span``): ``train.upload.wait``, the wait on the
        slot's last copy, and ``train.upload.stage``, each array's pinned
        fill."""
        slot, self._turn = self._turn, (self._turn + 1) % self.SLOTS
        if self._done[slot] is not None:
            with span("train.upload.wait"):
                self._done[slot].synchronize()
        buffers = self._buffers[slot]
        compute = torch.cuda.current_stream(self.device)
        out = {}
        with torch.cuda.stream(self.stream):
            for k, v in batch.items():
                v = np.asarray(v)
                key = (k, v.shape, v.dtype.str)
                if key not in buffers:
                    buf = torch.empty(v.shape, dtype=torch.from_numpy(np.empty(0, v.dtype)).dtype,
                                      pin_memory=True)
                    if not buf.is_pinned():
                        raise RuntimeError(f"could not pin a staging buffer for {k!r}")
                    buffers[key] = buf
                with span("train.upload.stage"):
                    np.copyto(buffers[key].numpy(), v)
                out[k] = buffers[key].to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        self._done[slot] = done
        compute.wait_event(done)
        for t in out.values():
            t.record_stream(compute)
        return out


class Trainer:
    def __init__(self, cfg: TrainerConfig, *, model: nn.Module, loss_fn: LossFn,
                 train_data: Optional[Dict[str, np.ndarray]] = None,
                 val_data: Optional[Dict[str, np.ndarray]] = None,
                 logger_name: str = "genrec", device=None,
                 eval_loss_fn: Optional[LossFn] = None, mesh: Optional[Mesh] = None,
                 param_specs: Optional[Dict[str, Spec]] = None,
                 train_data_buckets: Optional[List[Dict[str, np.ndarray]]] = None,
                 composite_widths: Optional[Sequence[int]] = None,
                 row_widths: Optional[np.ndarray] = None,
                 width_slice_keys: Tuple[str, ...] = ("labels",),
                 steps_per_epoch: int = 1):
        """``train_data`` / ``val_data``: numpy arrays with one row per
        sample, uploaded to ``device`` once (the card unless ``device="cpu"``)
        and kept there as ``self.train_data`` / ``self.val_data`` (in
        sharded-dataset mode, this rank's rows only). ``train_data_buckets``
        in place of ``train_data``: one such dataset per target-length
        bucket, kept as ``self.train_buckets`` (``self.train_data`` is then
        None). With neither, the trainer streams: ``fit`` takes batch
        factories, and ``steps_per_epoch`` (the optimizer steps an epoch of
        ``train_batches`` runs) feeds the schedule; the resident routes count
        their own. ``composite_widths`` with ``row_widths`` (one per row of
        ``train_data``) trains in composite width mode, slicing
        ``width_slice_keys`` to each group's width. ``model`` is moved
        there; the trainer updates it in place. ``loss_fn`` serves training
        (model in ``.train()``) and, unless ``eval_loss_fn`` is given,
        validation (``.eval()``). ``mesh`` (``dp_shardings``) makes the run
        data-parallel over its 'data' axis; every rank passes the same
        arrays. ``param_specs`` (``param_shardings``) makes it
        tensor-parallel over the mesh's 'model' axis: every rank passes the
        same whole ``model``, which is cut to this rank's shards here."""
        if train_data is not None and train_data_buckets is not None:
            raise ValueError("pass train_data or train_data_buckets, not both")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        if param_specs is not None and mesh is None:
            raise ValueError("tensor-parallel parameter specs need a mesh (dp_shardings)")
        self._specs = param_specs or {}
        self._cut = shard_model_(self.model, mesh, self._specs) if param_specs else set()
        self.loss_fn = loss_fn
        self.eval_loss_fn = eval_loss_fn or loss_fn
        world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        self._shard_data = cfg.shard_dataset if cfg.shard_dataset is not None else world > 1
        if mesh is None and (world > 1 or self._shard_data):
            raise ValueError("multi-process training and sharded datasets need a mesh "
                             "(parallel.auto.dp_shardings)")
        self.mesh = mesh
        self._data_axis = mesh.size("data") if mesh is not None else 1
        self._data_index = mesh.index("data") if mesh is not None else 0
        self._group = mesh.group("data") if mesh is not None else None
        d = self._data_axis
        if cfg.batch_size % d or cfg.eval_batch_size % d:
            raise ValueError(f"batch sizes ({cfg.batch_size}/{cfg.eval_batch_size}) must "
                             f"divide the data axis ({d}): padded batches shard evenly")
        self._composite = None  # composite mode: (ascending widths, each row's width)
        self._slice_keys = tuple(width_slice_keys)
        self.widths_run: Set[int] = set()  # composite mode: the group widths that ran
        if composite_widths is not None:
            # the reference asserts on both (trainer.py:340-343)
            if train_data is None:
                raise ValueError("composite widths need flat train_data")
            if self._shard_data:
                raise ValueError("composite widths and sharded datasets do not compose "
                                 "(as in the reference)")
            if row_widths is None:
                raise ValueError("composite widths need row_widths")
            for k in width_slice_keys:
                if k not in train_data:
                    raise ValueError(f"width_slice_keys: {k!r} is not in train_data")
            self._composite = (sorted(composite_widths), np.asarray(row_widths))
            self._full_width = np.asarray(train_data[width_slice_keys[-1]]).shape[1]
        if train_data_buckets is not None:
            # a bucketed epoch runs sum(ceil(n_b / B)) steps: each bucket pads its tail batch
            steps_per_epoch = sum(-(-len(next(iter(d.values()))) // cfg.batch_size)
                                  for d in train_data_buckets)
        elif train_data is not None:  # composite mode keeps the flat count, as the reference does
            steps_per_epoch = -(-len(next(iter(train_data.values()))) // cfg.batch_size)
        self.opt = make_optimizer(self.model.parameters(), cfg, steps_per_epoch,
                                  [p for k, p in self.model.named_parameters() if k in self._cut],
                                  mesh.group("model") if self._cut else None)
        self.step = 0
        self.start_epoch = 1
        self.best_val = float("inf")
        self.logger = get_logger(logger_name, cfg.log_path)
        self.store = CheckpointStore(cfg.ckpt_dir, keep=cfg.keep_checkpoints)
        resident = train_data_buckets or ([train_data] if train_data is not None else [])
        placed = [self._upload(d) for d in resident]
        self.train_buckets = [p[0] for p in placed]  # empty: the trainer streams
        self._bucket_meta = [p[1] for p in placed]
        self.train_data = self.train_buckets[0] if train_data is not None else None
        self.val_data, self._val_meta = (self._upload(val_data) if val_data is not None
                                         else (None, None))
        self._uploads: Optional[_PinnedUploads] = None  # made at the first put on the card
        if cfg.resume:
            self._try_resume()
        # DDP over the 'data' group; None without a process group
        self._ddp = None if self._group is None else nn.parallel.DistributedDataParallel(
            _LossModule(self.model, self.loss_fn), process_group=self._group)

    def _upload(self, data: Dict[str, np.ndarray]):
        """The arrays on the device, and the dataset's (real rows, rows per
        data shard), None when replicated. Sharded: the rows are padded with
        zeros to a multiple of the data axis and this rank keeps its block."""
        if not self._shard_data:
            return {k: torch.as_tensor(np.asarray(v)).to(self.device)
                    for k, v in data.items()}, None
        n_real = len(next(iter(data.values())))
        n_loc = -(-n_real // self._data_axis)
        lo = self._data_index * n_loc
        out = {}
        for k, v in data.items():
            v = np.asarray(v)
            block = np.zeros((n_loc,) + v.shape[1:], v.dtype)
            part = v[lo:lo + n_loc]
            block[:len(part)] = part
            out[k] = torch.as_tensor(block).to(self.device)
        return out, (n_real, n_loc)

    def _put(self, batch: Dict[str, np.ndarray]) -> Batch:
        """A streamed batch (this rank's rows) on the device, each array in
        the dtype :meth:`_upload` gives it: ``torch.as_tensor`` on the CPU,
        pinned asynchronous copies on the card (:class:`_PinnedUploads`),
        ready to use on the current stream. All of it is the span
        ``train.upload``."""
        with span("train.upload"):
            if self.device.type == "cpu":
                return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
            if self._uploads is None:
                self._uploads = _PinnedUploads(self.device)
            return self._uploads.put(batch)

    def snapshot_params(self) -> Dict[str, torch.Tensor]:
        """A copy of the model's state_dict that later steps leave as it is,
        the whole tensors under tensor parallelism (collective: every rank
        calls it)."""
        return {k: v.detach().clone() for k, v in self._whole(self.model.state_dict()).items()}

    def _whole(self, state):
        return gather_state(state, self.mesh, self._specs) if self._cut else state

    def _optimizer_specs(self) -> List[Spec]:
        """The spec of each of the optimizer's parameters, in its order."""
        return [self._specs.get(k, ()) for k, p in self.model.named_parameters()
                if p.requires_grad]

    def _map_optimizer_state(self, sd, fn):
        """The optimizer state_dict with ``fn(tensor, spec)`` applied to each
        per-parameter state tensor of one or more dimensions (moments,
        accumulators: the parameter's shape), the 0-d step counts left as
        they are."""
        specs = self._optimizer_specs()
        state = {i: {k: fn(v, specs[i]) if torch.is_tensor(v) and v.dim() else v
                     for k, v in st.items()} for i, st in sd["state"].items()}
        return dict(sd, state=state)

    # ------------------------------------------------------------------
    def _state_dict(self):
        """The train state with whole tensors (collective under tensor
        parallelism: every rank calls it)."""
        opt = self.opt.optimizer.state_dict()
        if self._cut:
            opt = self._map_optimizer_state(
                opt, lambda t, spec: gather_tensor(t, spec, self.mesh))
        return {"model": self._whole(self.model.state_dict()),
                "optimizer": opt,
                "scheduler": self.opt.scheduler.state_dict(),
                "step": self.step, "epoch": self.start_epoch, "best_val": self.best_val}

    def _try_resume(self):
        restored = self.store.restore_latest()
        if restored is None:
            return
        model, opt = restored["model"], restored["optimizer"]
        if self._cut:  # whole tensors on disk: this rank's blocks
            model = {k: shard_tensor(v, self._specs.get(k, ()), self.mesh)
                     for k, v in model.items()}
            opt = self._map_optimizer_state(
                opt, lambda t, spec: shard_tensor(t, spec, self.mesh).contiguous())
        self.model.load_state_dict(model)
        self.opt.optimizer.load_state_dict(opt)
        self.opt.scheduler.load_state_dict(restored["scheduler"])
        self.step = int(restored["step"])
        self.start_epoch = int(restored["epoch"]) + 1
        self.best_val = float(restored["best_val"])
        self.logger.info(f"Resumed from step {self.step} (epoch {self.start_epoch - 1}), "
                         f"best_val={self.best_val:.4f}")

    # ------------------------------------------------------------------
    @staticmethod
    def _index_matrix(n: int, batch_size: int, *, shuffle: bool, seed: int) -> np.ndarray:
        """(steps, batch_size) int32 index matrix; -1 pads the final batch."""
        idx = np.arange(n, dtype=np.int32)
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        steps = -(-n // batch_size)
        out = np.full((steps * batch_size,), -1, np.int32)
        out[:n] = idx
        return out.reshape(steps, batch_size)

    @staticmethod
    def _index_matrix_sharded(n_real: int, n_loc: int, d_axis: int, batch_size: int, *,
                              shuffle: bool, seed: int) -> np.ndarray:
        """The reference's index matrix for the row-sharded layout, to the
        letter: batch columns [d·B/D, (d+1)·B/D) carry only row ids resident
        on data shard d (rows [d·n_loc, (d+1)·n_loc)); each shard shuffles
        its rows with its own seed. It depends only on (n_real, n_loc, D, B,
        seed)."""
        bloc = batch_size // d_axis
        # shard d's real rows: the pad-to-multiple-of-D tail lies in the last shards
        reals = [min(max(n_real - d * n_loc, 0), n_loc) for d in range(d_axis)]
        steps = max(1, -(-max(reals) // bloc))
        out = np.full((steps, batch_size), -1, np.int32)
        for d in range(d_axis):
            ids = np.arange(reals[d], dtype=np.int32)
            if shuffle:
                np.random.default_rng(seed * 9973 + d).shuffle(ids)
            stream = np.full((steps * bloc,), -1, np.int32)
            stream[:reals[d]] = ids + d * n_loc
            out[:, d * bloc:(d + 1) * bloc] = stream.reshape(steps, bloc)
        return out

    @staticmethod
    def gather(data: Batch, idx: torch.Tensor) -> Batch:
        """The batch of rows ``idx`` (a device index vector; -1 pads): every
        array's rows, and ``valid`` = idx ≥ 0."""
        safe = idx.clamp(min=0)
        batch = {k: v.index_select(0, safe) for k, v in data.items()}
        batch["valid"] = idx >= 0
        return batch

    @staticmethod
    def _composite_plan(row_widths: np.ndarray, widths: List[int],
                        batch_size: int, mix: float, seed: int):
        """The reference's per-epoch width assignment for composite mode, to
        the letter: [(width, index matrix)] covering every row exactly once.
        Rows native to width group k (their length fits w_k but not w_{k-1})
        anchor group k; a ``mix`` fraction of each group's slots is filled by
        random rows drawn from the smaller groups' pools (largest width
        first, so every filler row still fits). Leftover short rows train in
        their own (smaller) groups."""
        rng = np.random.default_rng(seed)
        pools: List[List[int]] = []
        lower = -1
        for w in widths:
            ids = np.where((row_widths > lower) & (row_widths <= w))[0]
            ids = ids.astype(np.int32)
            rng.shuffle(ids)
            pools.append(list(ids))
            lower = w
        items = []
        for k in range(len(widths) - 1, -1, -1):
            nat = pools[k]
            pools[k] = []
            if mix > 0.0 and k > 0 and nat:
                want = int(round(len(nat) * mix / max(1.0 - mix, 1e-9)))
                donors = [i for i in range(k) if pools[i]]
                fill: List[int] = []
                while want > 0 and donors:
                    for i in list(donors):  # round-robin across donors
                        if want <= 0:
                            break
                        fill.append(pools[i].pop())
                        want -= 1
                        if not pools[i]:
                            donors.remove(i)
                nat = nat + fill
            if not nat:
                continue
            ids = np.asarray(nat, np.int32)
            rng.shuffle(ids)
            steps = -(-len(ids) // batch_size)
            mat = np.full((steps * batch_size,), -1, np.int32)
            mat[:len(ids)] = ids
            items.append((widths[k], mat.reshape(steps, batch_size)))
        return items

    def _mine(self, mat: np.ndarray, meta) -> torch.Tensor:
        """This rank's columns of a global index matrix on the device, as
        indices into its own rows (-1 pads)."""
        bloc, d = mat.shape[1] // self._data_axis, self._data_index
        mine = mat[:, d * bloc:(d + 1) * bloc]
        if meta is not None:
            mine = np.where(mine >= 0, mine - d * meta[1], -1)
        return torch.from_numpy(np.ascontiguousarray(mine)).to(self.device, torch.int64)

    def _indices(self, data: Batch, meta, batch_size: int, *, shuffle: bool, seed: int):
        """The global index matrix on the host, and this rank's columns of it
        on the device (:meth:`_mine`)."""
        if meta is None:
            mat = self._index_matrix(len(next(iter(data.values()))), batch_size,
                                     shuffle=shuffle, seed=seed)
        else:
            mat = self._index_matrix_sharded(*meta, self._data_axis, batch_size,
                                             shuffle=shuffle, seed=seed)
        return mat, self._mine(mat, meta)

    def _epoch_work(self, epoch: int):
        """The epoch's chunks in the order they run, as the reference orders
        them: [(dataset, width to slice to or None, global index chunk, this
        rank's device chunk)]."""
        cfg = self.cfg
        work = []
        if self._composite is not None:
            widths, row_w = self._composite
            for w, mat in self._composite_plan(row_w, widths, cfg.batch_size,
                                               cfg.composite_mix, cfg.seed + epoch):
                k = max(1, min(cfg.bucket_interleave_chunks, mat.shape[0]))
                work.extend((self.train_data, None if w == self._full_width else w, chunk,
                             self._mine(chunk, None))
                            for chunk in np.array_split(mat, k) if len(chunk))
            np.random.default_rng(cfg.seed * 7919 + epoch).shuffle(work)
            return work
        n_buckets = len(self.train_buckets)
        for bi, (data, meta) in enumerate(zip(self.train_buckets, self._bucket_meta)):
            # bucket 0's seed is the flat path's
            mat, idx = self._indices(data, meta, cfg.batch_size, shuffle=True,
                                     seed=cfg.seed + epoch + bi * 1000003)
            k = 1 if n_buckets == 1 else max(1, min(cfg.bucket_interleave_chunks, mat.shape[0]))
            rows = np.array_split(np.arange(mat.shape[0]), k)
            work.extend((data, None, mat[r], idx[r[0]:r[-1] + 1]) for r in rows if len(r))
        if n_buckets > 1:
            np.random.default_rng(cfg.seed * 7919 + epoch).shuffle(work)
        return work

    def _sliced(self, batch: Batch, width: Optional[int]) -> Batch:
        """The batch with its ``width_slice_keys`` cut to ``width`` (composite)."""
        if width is None:
            return batch
        return {k: v[:, :width] if k in self._slice_keys else v for k, v in batch.items()}

    def train_step(self, batch: Batch, generator: Optional[torch.Generator]):
        """One update on ``batch`` (this rank's rows of it); returns its
        (sum_loss, valid) on the device. Spans: ``train.forward``,
        ``train.backward`` (``zero_grad``, then the backward) and
        ``train.optimizer`` (the update)."""
        with span("train.forward"):
            self.model.train()
            if self._ddp is None:
                loss, aux = self.loss_fn(self.model, batch, generator)
            else:
                loss, aux = self._ddp(batch, generator)
                total = all_reduce_sum(aux["valid"], self._group)
                local = aux["valid"].detach() * self._data_axis
                loss = loss * torch.where(total > 0, local / total, torch.zeros_like(total))
        with span("train.backward"):
            self.opt.zero_grad()
            loss.backward()
        with span("train.optimizer"):
            self.opt.step()
        self.step += 1
        return aux["sum_loss"].detach(), aux["valid"]

    def _epoch_batches(self, epoch: int, train_batches: Optional[BatchIterFactory]
                       ) -> Iterator[Tuple[Batch, int]]:
        """The epoch's batches on the device in the order they run, each with
        the examples it holds (counted on the host: no device read). A
        streamed batch is put when the caller asks for it, after it has
        enqueued the step before. Spans: ``train.fetch``, the factory's next
        batch and the count of its examples, then ``train.upload``
        (:meth:`_put`)."""
        if not self.train_buckets:
            if train_batches is None:
                raise ValueError("a streaming Trainer (no train_data) needs train_batches")
            batches = iter(train_batches(epoch))
            while True:
                with span("train.fetch"):
                    batch = next(batches, None)
                    if batch is not None:
                        n = (int(np.asarray(batch["valid"]).sum()) if "valid" in batch
                             else len(next(iter(batch.values()))))
                if batch is None:
                    return
                yield self._put(batch), n
        for data, width, chunk, idx_chunk in self._epoch_work(epoch):
            if self._composite is not None:
                self.widths_run.add(width or self._full_width)
            for row, idx in zip(chunk, idx_chunk):
                yield self._sliced(self.gather(data, idx), width), int((row >= 0).sum())

    @torch.no_grad()
    def evaluate_loss(self, batches: Optional[Iterable[Dict[str, np.ndarray]]] = None,
                      generator: Optional[torch.Generator] = None) -> float:
        """Per-valid-sample mean validation loss (SASRec/train.py:59-81 style)
        over ``val_data`` when the trainer holds it, else over ``batches``
        (numpy, this rank's rows), summed on the device and read once;
        ``generator`` goes to the loss."""
        self.model.eval()
        if self.val_data is not None:
            _, idx_mat = self._indices(self.val_data, self._val_meta,
                                       self.cfg.eval_batch_size, shuffle=False, seed=0)
            device_batches = (self.gather(self.val_data, idx) for idx in idx_mat)
        elif batches is not None:
            device_batches = (self._put(batch) for batch in batches)
        else:
            raise ValueError("evaluate_loss needs val_data or batches")
        total = torch.zeros((), device=self.device)
        valid = torch.zeros((), device=self.device)
        for batch in device_batches:
            _, aux = self.eval_loss_fn(self.model, batch, generator)
            total += aux["sum_loss"]
            valid += aux["valid"]
        total, valid = all_reduce_sum(torch.stack([total, valid]), self._group).tolist()
        return total / valid if valid > 0 else 0.0

    # ------------------------------------------------------------------
    def fit(self, train_batches: Optional[BatchIterFactory] = None,
            val_batches: Optional[BatchIterFactory] = None, *,
            examples_per_epoch: Optional[int] = None,
            epoch_end_callback: Optional[Callable[[int, "Trainer"], None]] = None
            ) -> TrainLoopResult:
        """Train to ``cfg.epochs`` (or an early stop), calling
        ``epoch_end_callback(epoch, self)`` after each epoch's latest-state
        save. A streaming trainer trains each epoch on ``train_batches(epoch)``;
        validation runs over ``val_data`` when the trainer holds it, else over
        ``val_batches(epoch)`` when given, else the train mean stands in.
        ``examples_per_epoch`` is accepted and read nowhere, as in the
        reference."""
        cfg = self.cfg
        # ranks of one data row draw alike; data index 0 draws the one-device stream
        generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + (self._data_index << 32))
        train_losses: List[float] = []
        val_losses: List[float] = []
        best_params = self.snapshot_params()
        no_improve = 0
        total_examples = 0
        total_time = 0.0
        epochs_run = 0
        steps_run = 0
        phase = {"train": 0.0, "val": 0.0, "ckpt": 0.0}
        first_epoch_s = 0.0  # warm-up epoch, excluded from steady ex/s
        first_epoch_examples = 0

        initial_epoch = self.start_epoch
        for epoch in range(self.start_epoch, cfg.epochs + 1):
            epochs_run = epoch
            # the epoch after the first of this fit: the first is warm-up
            profiling = (cfg.profile_dir is not None
                         and epoch == min(initial_epoch + 1, cfg.epochs))
            if profiling:
                self.logger.info(f"Profiling epoch {epoch} -> {cfg.profile_dir}")
            t0 = time.perf_counter()
            with (trace(cfg.profile_dir) if profiling else contextlib.nullcontext()), \
                    annotate(f"train epoch {epoch}"):
                sum_loss = torch.zeros((), device=self.device)
                sum_valid = torch.zeros((), device=self.device)
                n_examples = 0
                for batch, n in self._epoch_batches(epoch, train_batches):
                    sl, vl = self.train_step(batch, generator)
                    sum_loss += sl
                    sum_valid += vl
                    n_examples += n
                    steps_run += 1
                # the reads synchronize: once per epoch
                sum_loss, sum_valid = all_reduce_sum(torch.stack([sum_loss, sum_valid]),
                                                     self._group).tolist()
            dt = time.perf_counter() - t0
            phase["train"] += dt
            total_time += dt
            total_examples += n_examples
            if epoch == self.start_epoch:
                first_epoch_s = dt
                first_epoch_examples = n_examples

            avg_loss = sum_loss / sum_valid if sum_valid > 0 else 0.0
            if not np.isfinite(avg_loss):
                # reference aborts on NaN loss (`RQ-VAE/train.py:92-94`)
                self.logger.error(f"Epoch {epoch}: non-finite train loss ({avg_loss}); aborting")
                raise ValueError(f"training diverged: loss={avg_loss} at epoch {epoch}")
            train_losses.append(avg_loss)

            if self.val_data is not None or val_batches is not None:
                tv = time.perf_counter()
                val_loss = self.evaluate_loss(
                    None if self.val_data is not None else val_batches(epoch),
                    generator=generator)
                phase["val"] += time.perf_counter() - tv
            else:
                val_loss = avg_loss
            val_losses.append(val_loss)

            self.logger.info(
                f"Epoch {epoch} | Train Loss: {avg_loss:.4f} | Val Loss: {val_loss:.4f} | "
                f"{dt:.2f}s | {n_examples / max(dt, 1e-9):.0f} ex/s")

            self.start_epoch = epoch
            tc = time.perf_counter()
            if (epoch % cfg.ckpt_every_epochs == 0) or epoch == cfg.epochs:
                state = self._state_dict()
                write_once(lambda: self.store.save_latest(self.step, state))
            phase["ckpt"] += time.perf_counter() - tc

            if epoch_end_callback is not None:
                epoch_end_callback(epoch, self)

            if val_loss < self.best_val:
                self.best_val = val_loss
                no_improve = 0
                best_params = self.snapshot_params()
                tc = time.perf_counter()
                write_once(lambda: self.store.save_best(best_params))
                phase["ckpt"] += time.perf_counter() - tc
                self.logger.info(f"Best model saved (val_loss={val_loss:.4f})")
            else:
                no_improve += 1
                if no_improve >= cfg.early_stop_patience:
                    self.logger.info(f"Early stopping at epoch {epoch}.")
                    if cfg.ckpt_every_epochs > 1 and epoch % cfg.ckpt_every_epochs != 0:
                        # the cadence skipped this epoch's latest-state save;
                        # persist it so resume starts from the stopping point
                        state = self._state_dict()
                        write_once(lambda: self.store.save_latest(self.step, state))
                    break

        if is_main_process():
            plot_loss_curves(train_losses, val_losses, cfg.loss_plot_path)
        steady_examples = total_examples - first_epoch_examples
        steady_time = phase["train"] - first_epoch_s
        steady_eps = (steady_examples / steady_time if steady_time > 0
                      else total_examples / max(total_time, 1e-9))
        wall = total_time + phase["val"] + phase["ckpt"]
        self.logger.info(
            "Phase breakdown: train %.1fs (first epoch %.1fs) | val %.1fs | ckpt %.1fs "
            "| steady %.0f ex/s" % (phase["train"], first_epoch_s, phase["val"],
                                    phase["ckpt"], steady_eps))
        return TrainLoopResult(
            best_params=best_params,
            final_params=self.snapshot_params(),
            train_losses=train_losses,
            val_losses=val_losses,
            best_val_loss=self.best_val,
            epochs_run=epochs_run,
            examples_per_sec=total_examples / max(total_time, 1e-9),
            steady_examples_per_sec=steady_eps,
            phase_seconds=dict(phase, wall=wall, first_epoch=first_epoch_s),
            steps_run=steps_run,
        )
