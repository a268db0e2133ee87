"""Optimizer and learning-rate schedule factory of the port.

Counterpart of ``genrec_tpu/train/optim.py`` (the reference's optimizer
factory + HF scheduler wiring, `RQ-VAE/train.py:40-95`): adam, adamw, sgd,
adagrad or rmsprop, a linear or constant schedule with warmup, and an
optional global-norm gradient clip, each computing what optax computes:

- ``torch.optim.Adam``, ``AdamW`` and ``SGD`` compute optax's ``adam``,
  ``adamw`` (decay applied to every parameter) and ``sgd``;
- adagrad and rmsprop are written here to optax's formulas, which differ
  from torch's: adagrad's accumulator starts at 0.1, takes eps 1e-7 inside
  the square root and gives 0 where it is 0; rmsprop decays by 0.9 and
  scales by g·rsqrt(ν + eps);
- the clip scales by max_norm / norm when the norm is not below max_norm,
  with no +1e-6 (``optax.clip_by_global_norm``); under tensor parallelism
  the norm is the whole model's, as JAX's over global arrays: the squares
  of the parameters cut over 'model' are summed over its group, those of
  the replicated ones counted once.

The schedule is a function of the number of updates made so far, as
optax's: the first update uses ``schedule(0)``.
"""

from __future__ import annotations

from typing import Callable, Collection, Iterable, Optional

import torch
import torch.distributed as dist

from genrec_tpu_torch.configs import TrainerConfig

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: init → end over ``steps`` updates, then end."""
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps) / steps) + end


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    """optax.join_schedules of two schedules at ``boundary``."""
    return lambda count: first(count) if count < boundary else second(count - boundary)


def make_schedule(cfg: TrainerConfig, steps_per_epoch: int) -> Schedule:
    total_steps = max(cfg.epochs * steps_per_epoch, 1)
    warmup_steps = cfg.warmup_epochs * steps_per_epoch
    if cfg.lr_scheduler == "linear":
        # HF get_linear_schedule_with_warmup: 0→lr over warmup, lr→0 over the rest
        if warmup_steps > 0:
            return _join(_linear(0.0, cfg.lr, max(warmup_steps, 1)),
                         _linear(cfg.lr, 0.0, max(total_steps - warmup_steps, 1)),
                         max(warmup_steps, 1))
        return _linear(cfg.lr, 0.0, total_steps)
    if cfg.lr_scheduler == "constant":
        if warmup_steps > 0:
            return _join(_linear(0.0, cfg.lr, warmup_steps), lambda count: cfg.lr,
                         warmup_steps)
        return lambda count: cfg.lr
    raise ValueError(cfg.lr_scheduler)


class OptaxAdagrad(torch.optim.Optimizer):
    """optax.adagrad at its defaults: acc += g²; p -= lr · g · rsqrt(acc + 1e-7)
    where acc > 0, else 0; acc starts at 0.1."""

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["sum"] = torch.full_like(p, 0.1)
                acc = state["sum"]
                acc.add_(p.grad.square())
                scale = torch.where(acc > 0, torch.rsqrt(acc + 1e-7), 0.0)
                p.add_(scale * p.grad, alpha=-group["lr"])


class OptaxRMSprop(torch.optim.Optimizer):
    """optax.rmsprop at its defaults: ν = 0.9·ν + 0.1·g²;
    p -= lr · g · rsqrt(ν + 1e-8); ν starts at 0."""

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(0.9).add_(0.1 * p.grad.square())
                p.add_(p.grad * torch.rsqrt(nu + 1e-8), alpha=-group["lr"])


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[torch.Tensor], max_norm: float,
                         sharded: Collection[torch.Tensor] = (),
                         group=None) -> torch.Tensor:
    """optax.clip_by_global_norm on the ``.grad`` of ``params``, in place:
    unchanged when the global norm is below ``max_norm``, else scaled by
    max_norm / norm. Returns the norm (a device scalar; no host sync unless
    ``group`` is given). ``sharded`` are those of ``params`` that hold one
    block of a tensor cut over ``group`` (the mesh's 'model' group): their
    squares are summed over the group, so the norm is the whole model's."""
    params = [p for p in params if p.grad is not None]
    cut = {id(p) for p in sharded}
    zero = torch.zeros((), device=params[0].grad.device)
    cut_sq = sum((p.grad.square().sum() for p in params if id(p) in cut), zero)
    whole_sq = sum((p.grad.square().sum() for p in params if id(p) not in cut), zero)
    if group is not None and cut:
        dist.all_reduce(cut_sq, group=group)
    norm = torch.sqrt(cut_sq + whole_sq)
    grads = [p.grad for p in params]
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


class TrainOptimizer:
    """One update of the reference's optax chain: the optional clip, the
    optimizer at the schedule's rate, the schedule's count + 1. ``optimizer``
    and ``scheduler`` are plain torch objects (their ``state_dict``s go into
    the checkpoint)."""

    def __init__(self, params, cfg: TrainerConfig, steps_per_epoch: int = 1,
                 sharded: Collection[torch.Tensor] = (), model_group=None):
        """``sharded`` (those of ``params`` cut over the 'model' group
        ``model_group``) enter the clip's norm summed over the group."""
        self.params = [p for p in params if p.requires_grad]
        self.sharded, self.model_group = list(sharded), model_group
        name = cfg.optimizer.lower()
        b1, b2 = cfg.adam_betas
        # the schedule gives the rate itself: the group's base rate is 1
        if name == "adam":
            opt = torch.optim.Adam(self.params, lr=1.0, betas=(b1, b2), eps=1e-8)
        elif name == "adamw":
            opt = torch.optim.AdamW(self.params, lr=1.0, betas=(b1, b2), eps=1e-8,
                                    weight_decay=cfg.weight_decay)
        elif name == "sgd":
            opt = torch.optim.SGD(self.params, lr=1.0)
        elif name == "adagrad":
            opt = OptaxAdagrad(self.params, lr=1.0)
        elif name == "rmsprop":
            opt = OptaxRMSprop(self.params, lr=1.0)
        else:
            raise ValueError(f"unknown optimizer {cfg.optimizer}")
        self.optimizer = opt
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            opt, make_schedule(cfg, steps_per_epoch))
        self.clip_norm: Optional[float] = cfg.grad_clip_norm

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    def step(self):
        if self.clip_norm is not None:
            clip_by_global_norm_(self.params, self.clip_norm, self.sharded, self.model_group)
        self.optimizer.step()
        self.scheduler.step()


def make_optimizer(params, cfg: TrainerConfig, steps_per_epoch: int = 1,
                   sharded: Collection[torch.Tensor] = (), model_group=None) -> TrainOptimizer:
    return TrainOptimizer(params, cfg, steps_per_epoch, sharded, model_group)
