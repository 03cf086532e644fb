"""Base trainer: AdamW with optax's arithmetic, gradient accumulation, the
non-finite-step skip, checkpoints with top-k retention and full resume (port
of :mod:`kirag_tpu.training.trainer`).

The optimizer is the reference's optax chain written out, not
``torch.optim.AdamW``, so both packages take the same steps:

    apply_if_finite(MultiSteps(chain(clip_by_global_norm(max_grad_norm),
                                     adamw(warmup_then_constant, weight_decay)),
                               every_k=accumulation_steps))

- AdamW: b1 0.9, b2 0.999, eps 1e-8 outside the square root, weight decay
  on every parameter, added to the Adam direction before the learning rate;
- the learning rate rises linearly from 0 at the first update to its value
  at ``warmup_steps = max(1, int(total // accumulation * warmup_ratio))``
  updates and stays there;
- clipping by the global norm as optax writes it: ``g / norm * max_norm``
  when ``norm >= max_norm``;
- accumulation: a running mean of the micro-batch gradients, applied every
  ``accumulation_steps`` micro steps (the schedule counts updates);
- a micro step with a non-finite gradient changes nothing (no accumulation,
  no update) and is counted.

The optimizer state (Adam's moments, the accumulator) is held as flat f32
vectors over all parameters. Checkpoints are ``torch.save`` files in the
reference's layout: ``<save_dir>/latest/<step>/`` (the newest) and
``<save_dir>/best/<step>/`` (the top ``keep_top_k`` by eval metric), each
holding the model, the optimizer, the step and the epoch, so a resumed run
repeats an uninterrupted one.

Over a mesh (``mesh=``, one process a rank, the port's SPMD model): every
rank iterates the same global loader. ``batch_sharding`` names the axis a
batch's rows shard over (``"data"``): each rank keeps its rows of every leaf
and the parameter gradients are summed over that axis, since each rank's are
partial sums of the global loss's gradient; with None the batch is
replicated and the gradients are whole already. A model sharded over the
model axis (a ``tp`` attribute, as :func:`~kirag_tpu_torch.models.bert.
shard_bert_model` makes) trains its shards; the optimizer's statistics (the
clipping norm, min, max, mean, the non-finite flag) are the whole model's,
agreed over the axis. Checkpoints do not depend on the mesh: the mesh's
first rank writes the unsharded trainer's format (whole tensors, the flat
optimizer state in the whole model's parameter order) and every rank cuts
its shard on resume. Only the first rank writes files.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from kirag_tpu_torch.parallel.mesh import all_gather_list, all_reduce_sum, shard_rows

logger = logging.getLogger(__name__)

MAX_CONSECUTIVE_ERRORS = 10_000  # the reference's apply_if_finite bound


@dataclasses.dataclass
class TrainerConfig:
    learning_rate: float = 2e-5
    weight_decay: float = 0.01
    warmup_ratio: float = 0.1
    num_train_epochs: int = 10
    accumulation_steps: int = 1
    max_grad_norm: float = 1.0
    eval_steps: int = 200
    log_steps: int = 50
    keep_top_k: int = 2
    save_dir: str = "checkpoint/run"
    seed: int = 42
    metric_mode: str = "max"  # higher is better
    max_steps: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class GradSync:
    """Where a trainer's gradients and parameters lie over a mesh:
    ``data_axis``, the axis the gradients are summed over (None: whole
    already); ``tp``, the model axis that the parameters flagged in
    ``sharded`` are cut over (None: every parameter whole)."""

    mesh: Any
    data_axis: Optional[str] = None
    tp: Any = None
    sharded: Sequence[bool] = ()


class AdamW:
    """The optax chain above over ``params``, updating them in place.

    :meth:`update` takes one micro batch's gradients (one per parameter, in
    order) and returns their statistics: ``grad_norm``, ``grad_min``,
    ``grad_max``, ``grad_mean``. f32 arithmetic in optax's order. With
    ``sync`` the gradients are summed over its data axis first, and the
    statistics, the clipping norm and the non-finite skip are the whole
    model's over its model axis (a collective of the mesh).
    """

    def __init__(self, params: Sequence[nn.Parameter], learning_rate: float,
                 weight_decay: float, max_grad_norm: float, warmup_steps: int,
                 accumulation_steps: int = 1, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, sync: Optional[GradSync] = None):
        self.params = list(params)
        self.sync = sync
        self.learning_rate, self.weight_decay = learning_rate, weight_decay
        self.max_grad_norm, self.warmup_steps = max_grad_norm, warmup_steps
        self.accumulation_steps = accumulation_steps
        self.b1, self.b2, self.eps = b1, b2, eps
        n = sum(p.numel() for p in self.params)
        device = self.params[0].device
        self.mu = torch.zeros(n, device=device)
        self.nu = torch.zeros(n, device=device)
        self.acc = torch.zeros(n, device=device) if accumulation_steps > 1 else None
        if sync is not None and sync.tp is not None:
            self._sizes = torch.tensor([p.numel() for p in self.params], device=device)
            self._shard_mask = torch.tensor([bool(x) for x in sync.sharded], device=device)
            self._whole_numel = sum(p.numel() * (sync.tp.size if x else 1)
                                    for p, x in zip(self.params, sync.sharded))
        self.count = 0            # updates applied (Adam's and the schedule's count)
        self.mini_step = 0        # micro steps accumulated toward the next update
        self.notfinite_count = 0  # consecutive non-finite micro steps
        self.total_notfinite = 0

    def lr_at(self, count: int) -> float:
        """The schedule at update ``count`` (from 0), in f32 as optax computes
        it: linear from 0 to the learning rate over ``warmup_steps``."""
        f32 = np.float32
        if count >= self.warmup_steps:
            return float(f32(self.learning_rate))
        frac = f32(1) - f32(count) / f32(self.warmup_steps)
        return float(f32(0 - self.learning_rate) * frac + f32(self.learning_rate))

    def _flat(self, tensors) -> torch.Tensor:
        return torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])

    def _sharded_sums(self, x: torch.Tensor) -> torch.Tensor:
        """[sum over the sharded parameters' elements, over the replicated
        ones] of ``x`` (one value an element, in parameter order)."""
        per = torch.segment_reduce(x, "sum", lengths=self._sizes)
        return torch.stack([per[self._shard_mask].sum(), per[~self._shard_mask].sum()])

    def _model_sumsq(self, g: torch.Tensor) -> torch.Tensor:
        """The whole model's sum of squares: the sharded parameters' summed
        over the model axis, the replicated ones counted once."""
        tp = self.sync.tp
        sums = self._sharded_sums(g * g)
        return all_reduce_sum(sums[:1], tp.mesh, tp.axis)[0] + sums[1]

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> Dict[str, float]:
        g = self._flat(grads)
        sync = self.sync
        if sync is not None and sync.data_axis is not None:
            g = all_reduce_sum(g, sync.mesh, sync.data_axis)
        if sync is None or sync.tp is None:
            stats = torch.stack([torch.sqrt(torch.sum(g * g)), g.min(), g.max(),
                                 g.sum() / g.numel(),
                                 torch.isfinite(g).all().float()]).tolist()
        else:  # the whole model's: every rank's local statistics, combined
            # [sharded, replicated] sums of squares and of values, min, max,
            # finite; the replicated elements counted once (this rank's)
            local = torch.cat([self._sharded_sums(g * g), self._sharded_sums(g),
                               torch.stack([g.min(), g.max(), torch.isfinite(g).all().float()])])
            ranks = torch.stack(all_gather_list(local, sync.tp.mesh, sync.tp.axis))
            sumsq = ranks[:, 0].sum() + local[1]
            total = ranks[:, 2].sum() + local[3]
            stats = torch.stack([torch.sqrt(sumsq), ranks[:, 4].min(), ranks[:, 5].max(),
                                 total / self._whole_numel, ranks[:, 6].min()]).tolist()
        finite = stats.pop() == 1.0
        self.notfinite_count = 0 if finite else self.notfinite_count + 1
        self.total_notfinite += 0 if finite else 1
        if finite or self.notfinite_count > MAX_CONSECUTIVE_ERRORS:
            if self.acc is None:
                self._apply(g)
            else:
                self.acc += (g - self.acc) / (self.mini_step + 1)
                if self.mini_step == self.accumulation_steps - 1:
                    self._apply(self.acc)
                    self.acc.zero_()
                self.mini_step = (self.mini_step + 1) % self.accumulation_steps
        return dict(zip(("grad_norm", "grad_min", "grad_max", "grad_mean"), stats))

    def _apply(self, g: torch.Tensor) -> None:
        f32 = np.float32
        if self.sync is None or self.sync.tp is None:
            norm = torch.sqrt(torch.sum(g * g))
        else:
            norm = torch.sqrt(self._model_sumsq(g))
        g = torch.where(norm < self.max_grad_norm, g, g / norm * self.max_grad_norm)
        self.mu.mul_(self.b1).add_((1 - self.b1) * g)
        self.nu.mul_(self.b2).add_((1 - self.b2) * (g * g))
        self.count += 1
        mu_hat = self.mu / float(f32(1) - f32(self.b1) ** f32(self.count))
        nu_hat = self.nu / float(f32(1) - f32(self.b2) ** f32(self.count))
        u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        u += self.weight_decay * self._flat(self.params)
        u *= float(-f32(self.lr_at(self.count - 1)))
        for p, du in zip(self.params, u.split([p.numel() for p in self.params])):
            p.add_(du.view_as(p).to(p.dtype))

    def state_dict(self) -> Dict[str, Any]:
        return {"mu": self.mu, "nu": self.nu, "acc": self.acc, "count": self.count,
                "mini_step": self.mini_step, "notfinite_count": self.notfinite_count,
                "total_notfinite": self.total_notfinite}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for name in ("mu", "nu", "acc"):
            if state[name] is not None:
                getattr(self, name).copy_(state[name])
        for name in ("count", "mini_step", "notfinite_count", "total_notfinite"):
            setattr(self, name, int(state[name]))


def make_optimizer(config: TrainerConfig, total_steps: int,
                   params: Sequence[nn.Parameter], sync: Optional[GradSync] = None) -> AdamW:
    """AdamW with linear warmup then a constant rate, clipping, accumulation
    and the non-finite skip, over ``params`` (``sync``: see :class:`AdamW`).
    ``total_steps`` counts MICRO batches; warmup is sized in optimizer
    updates."""
    num_updates = max(1, total_steps // max(1, config.accumulation_steps))
    warmup_steps = max(1, int(num_updates * config.warmup_ratio))
    return AdamW(params, config.learning_rate, config.weight_decay, config.max_grad_norm,
                 warmup_steps, accumulation_steps=max(1, config.accumulation_steps),
                 sync=sync)


def _hard_link(src: str, dst: str) -> bool:
    try:
        os.link(src, dst)
    except OSError:
        return False
    return True


class CheckpointDir:
    """``<root>/<step>/state.pt`` checkpoints, at most ``max_to_keep``: the
    newest, or with ``best_mode`` ("max" or "min") the best by the metric
    saved with each."""

    def __init__(self, root: str, max_to_keep: int, best_mode: Optional[str] = None):
        self.root, self.max_to_keep, self.best_mode = root, max_to_keep, best_mode

    def all_steps(self) -> List[int]:
        if not os.path.isdir(self.root):
            return []
        return sorted(int(d) for d in os.listdir(self.root)
                      if d.isdigit() and os.path.exists(os.path.join(self.root, d, "state.pt")))

    def _metric(self, step: int) -> float:
        with open(os.path.join(self.root, str(step), "metric.json")) as f:
            return json.load(f)["metric"]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        ranked = self._ranked()
        return ranked[0] if ranked else None

    def _ranked(self) -> List[int]:
        """Steps, the one to keep longest first."""
        steps = self.all_steps()[::-1]
        if self.best_mode is None:
            return steps
        return sorted(steps, key=self._metric, reverse=self.best_mode == "max")

    def save(self, step: int, state: Dict[str, Any], metric: Optional[float] = None,
             like: Optional["CheckpointDir"] = None) -> bool:
        """Write ``state`` as step ``step`` unless that step exists; then drop
        the checkpoints beyond ``max_to_keep``. ``like``: another directory
        that holds this same state as step ``step``; its file is hard-linked
        (a checkpoint is gigabytes at E5-large) where the file system lets
        it, else written again."""
        final = os.path.join(self.root, str(step))
        if os.path.exists(final):
            return False
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        path = os.path.join(tmp, "state.pt")
        if like is None or not _hard_link(os.path.join(like.root, str(step), "state.pt"), path):
            torch.save(state, path)
        if metric is not None:
            with open(os.path.join(tmp, "metric.json"), "w") as f:
                json.dump({"metric": float(metric)}, f)
        os.replace(tmp, final)  # a reader never sees half a checkpoint
        for old in self._ranked()[self.max_to_keep:]:
            shutil.rmtree(os.path.join(self.root, str(old)))
        return True

    def load(self, step: int) -> Dict[str, Any]:
        return torch.load(os.path.join(self.root, str(step), "state.pt"), map_location="cpu",
                          weights_only=True)


class BaseTrainer:
    """Training loop around a user-supplied loss function.

    Subclasses implement :meth:`loss_fn` ((model, batch) -> scalar tensor, or
    (scalar, aux dict)) and :meth:`evaluate` ((model, eval_loader) -> metric).
    ``model`` holds the f32 parameters; every one of them is trained.
    ``mesh`` and ``batch_sharding`` (an axis name, or None for a replicated
    batch): see the module docstring. A model sharded over the mesh's model
    axis carries ``tp`` and the methods ``shard_dims``, ``cut_shard`` and
    ``join_shards`` (:class:`~kirag_tpu_torch.models.bert.BertModel`'s).
    """

    def __init__(self, model: nn.Module, config: TrainerConfig, train_loader,
                 eval_loader=None, trackers=(), mesh=None, batch_sharding: Optional[str] = None):
        if batch_sharding is not None and mesh is None:
            raise ValueError(f"batch_sharding={batch_sharding!r} needs a mesh")
        self.model = model
        self.config = config
        self.train_loader = train_loader
        self.eval_loader = eval_loader
        self.mesh = mesh
        self.batch_sharding = batch_sharding
        self.writer = mesh is None or mesh.rank == 0  # the rank that writes files
        # experiment trackers: each callable receives every log record after
        # the built-in history and metrics.jsonl sinks
        self.trackers = list(trackers)
        self.device = next(model.parameters()).device

        steps_per_epoch = max(1, len(train_loader))
        self.total_steps = config.max_steps or steps_per_epoch * config.num_train_epochs
        self.names, self.params = (list(x) for x in zip(*model.named_parameters()))
        tp = getattr(model, "tp", None)
        self.tp = tp if tp is not None and tp.size > 1 else None
        sync = None
        if mesh is not None:
            dims = model.shard_dims() if self.tp is not None else {}
            sync = GradSync(mesh, batch_sharding, self.tp,
                            [dims.get(n) is not None for n in self.names])
        self.optimizer = make_optimizer(config, self.total_steps, self.params, sync)
        self.step = 0
        self.epoch = 0
        self.history: list = []

        os.makedirs(config.save_dir, exist_ok=True)
        if self.writer:
            with open(os.path.join(config.save_dir, "configs.json"), "w") as f:
                json.dump(dataclasses.asdict(config), f, indent=2, default=str)
        root = os.path.abspath(config.save_dir)
        self.best = CheckpointDir(os.path.join(root, "best"), config.keep_top_k,
                                  best_mode=config.metric_mode)
        self.latest = CheckpointDir(os.path.join(root, "latest"), 1)

    # -- to be provided by subclasses ----------------------------------------

    def loss_fn(self, model, batch):
        raise NotImplementedError

    def evaluate(self, model, eval_loader) -> float:
        raise NotImplementedError

    # -- core update ----------------------------------------------------------

    def _loss_with_aux(self, model, batch):
        out = self.loss_fn(model, batch)
        if isinstance(out, tuple):
            return out
        return out, {}

    def device_put_batch(self, batch):
        """numpy arrays (and nested dicts of them) -> tensors on the model's
        device; integer arrays as int64. With ``batch_sharding`` this rank's
        rows of each leaf; a leading dim that does not divide the axis
        raises ValueError."""
        if isinstance(batch, dict):
            return {k: self.device_put_batch(v) for k, v in batch.items()}
        x = torch.as_tensor(np.asarray(batch))
        if not x.is_floating_point():
            x = x.long()
        if self.batch_sharding is not None:
            x = shard_rows(x, self.mesh, self.batch_sharding)
        return x.to(self.device)

    def training_step(self, batch) -> Dict[str, float]:
        batch = self.device_put_batch(batch)
        loss, aux = self._loss_with_aux(self.model, batch)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        gstats = self.optimizer.update(grads)
        self.step += 1
        stats = {"loss": float(loss.detach())}
        stats.update(gstats)
        for k, v in (aux or {}).items():
            stats[k] = float(v.detach())
        return stats

    # -- checkpointing ----------------------------------------------------------

    def barrier(self) -> None:
        """Wait for every rank of the mesh (nothing in one process)."""
        if self.mesh is not None and dist.is_initialized():
            dist.barrier()

    def _whole(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole model's tensor ``name`` from this rank's ``local``
        shard (a collective of the model axis for a sharded one)."""
        if self.tp is None or self.model.shard_dims()[name] is None:
            return local
        return self.model.join_shards(name, all_gather_list(local, self.tp.mesh, self.tp.axis))

    def _whole_flat(self, flat: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """An optimizer vector (one value per local parameter element) as
        the whole model's, in its parameter order."""
        if flat is None or self.tp is None:
            return flat
        pieces = flat.split([p.numel() for p in self.params])
        return torch.cat([self._whole(n, x.view_as(p)).reshape(-1)
                          for n, x, p in zip(self.names, pieces, self.params)])

    def _local_flat(self, whole: Optional[torch.Tensor],
                    shapes: Dict[str, torch.Size]) -> Optional[torch.Tensor]:
        """The inverse of :meth:`_whole_flat`: this rank's elements of a
        whole-model vector laid out by ``shapes``."""
        if whole is None or self.tp is None:
            return whole
        pieces = whole.split([shapes[n].numel() for n in self.names])
        return torch.cat([self.model.cut_shard(n, x.view(shapes[n])).reshape(-1)
                          for n, x in zip(self.names, pieces)])

    def _state(self) -> Dict[str, Any]:
        """The checkpoint: the unsharded trainer's, whatever the mesh."""
        optimizer = dict(self.optimizer.state_dict())
        for name in ("mu", "nu", "acc"):
            optimizer[name] = self._whole_flat(optimizer[name])
        model = {k: self._whole(k, v.detach()) for k, v in self.model.state_dict().items()}
        return {"model": model, "optimizer": optimizer, "step": self.step, "epoch": self.epoch}

    def save_checkpoint(self, metric: Optional[float] = None) -> None:
        state = self._state()
        if self.writer:
            self.latest.save(self.step, state)
            if metric is not None:
                self.best.save(self.step, state, metric=metric, like=self.latest)
        self.barrier()  # the checkpoint is on disk for every rank

    def resume_training(self) -> bool:
        """Restore the latest checkpoint if present; True when resumed. Any
        mesh's checkpoint loads under any other: each rank cuts its shard."""
        step = self.latest.latest_step()
        if step is None:
            return False
        state = self.latest.load(step)
        shapes = {k: v.shape for k, v in state["model"].items()}
        self.model.load_state_dict({k: self.model.cut_shard(k, v) if self.tp else v
                                    for k, v in state["model"].items()})
        optimizer = dict(state["optimizer"])
        for name in ("mu", "nu", "acc"):
            optimizer[name] = self._local_flat(optimizer[name], shapes)
        self.optimizer.load_state_dict(optimizer)
        self.step = int(state["step"])
        self.epoch = int(state["epoch"])
        logger.info(f"Resumed from step {self.step} (epoch {self.epoch})")
        return True

    def best_checkpoint_step(self) -> Optional[int]:
        return self.best.best_step()

    # -- loop -------------------------------------------------------------------

    def log(self, record: Dict[str, Any]) -> None:
        record = {"step": self.step, "epoch": self.epoch, **record}
        self.history.append(record)
        logger.info(" ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                             for k, v in record.items()))
        if not self.writer:
            return
        # per-step metrics, so an operator can tail or plot a run
        with open(os.path.join(self.config.save_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps({"time": time.time(), **record}) + "\n")
        for tracker in self.trackers:
            tracker(record)

    def train(self, resume: bool = False) -> Dict[str, Any]:
        if resume:
            self.resume_training()
        steps_per_epoch = max(1, len(self.train_loader))
        start_time = time.time()
        session_start_step = self.step  # steps_per_sec counts this session's steps
        last_metric = None

        while self.epoch < self.config.num_train_epochs and self.step < self.total_steps:
            done_in_epoch = self.step - self.epoch * steps_per_epoch
            if done_in_epoch >= steps_per_epoch:  # resumed at an epoch boundary
                self.epoch += 1
                continue
            self.train_loader.set_epoch(self.epoch)
            iterator = (self.train_loader.iter_from(done_in_epoch)
                        if 0 < done_in_epoch else iter(self.train_loader))
            epoch_completed = True
            for batch in iterator:
                stats = self.training_step(batch)
                if self.step % self.config.log_steps == 0:
                    stats["steps_per_sec"] = ((self.step - session_start_step)
                                              / max(time.time() - start_time, 1e-9))
                    self.log(stats)
                if self.eval_loader is not None and self.step % self.config.eval_steps == 0:
                    last_metric = float(self.evaluate(self.model, self.eval_loader))
                    self.log({"eval_metric": last_metric})
                    self.save_checkpoint(metric=last_metric)
                if self.step >= self.total_steps:
                    # max_steps hit mid-epoch: the epoch did not finish, so its
                    # counter stays (a resume with a higher max_steps continues
                    # from the right batch)
                    epoch_completed = self.step - self.epoch * steps_per_epoch >= steps_per_epoch
                    break
            if epoch_completed:
                self.epoch += 1

        if self.eval_loader is not None:
            last_metric = float(self.evaluate(self.model, self.eval_loader))
            self.log({"eval_metric": last_metric})
        self.save_checkpoint(metric=last_metric)
        return {"final_metric": last_metric, "steps": self.step}
