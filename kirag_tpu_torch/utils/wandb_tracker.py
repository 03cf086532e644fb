"""A wandb-shaped experiment tracker for the BaseTrainer tracker seam (port
of :mod:`kirag_tpu.utils.wandb_tracker`).

The reference logs every training/eval record to Weights & Biases
(`trainer/base_trainer.py:550-589`: `wandb.init(project, name, config)` +
`wandb.log({...}, step=...)`). The port's trainer keeps its built-in
history/file/stream sinks and takes remote sinks through ``trackers=[...]``
(:class:`kirag_tpu_torch.training.trainer.BaseTrainer`); this module is the
wandb implementation of that seam.

Import-guarded: constructing :class:`WandbTracker` raises a clear error when
the ``wandb`` package is absent; everything else in the library works
without it. ``wandb_module=`` injects a stand-in (tests use a fake module).

Usage::

    from kirag_tpu_torch.utils.wandb_tracker import WandbTracker
    trainer = AlignerTrainer(..., trackers=[WandbTracker(
        project="kirag-tpu", name="aligner-e5-large",
        config=vars(args))])
    trainer.train()
    # optional: trainer-independent lifecycle
    tracker.finish()
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class WandbTracker:
    """Forward trainer log records to ``wandb.log``.

    Mirrors the reference's usage: one ``wandb.init`` per run with the
    hyperparameter config, then per-record ``wandb.log(metrics, step=step)``
    where ``step`` is the trainer's global step (`base_trainer.py:554-565`).
    Non-numeric record fields are dropped (wandb accepts them, but the
    reference logs scalars only); the ``step``/``epoch`` keys route to
    wandb's step axis and a plain metric respectively.
    """

    def __init__(self, project: str, name: Optional[str] = None,
                 config: Optional[Dict[str, Any]] = None, wandb_module=None,
                 **init_kwargs):
        if wandb_module is None:  # injection point for tests / fakes
            try:
                import wandb as wandb_module  # type: ignore
            except ImportError as e:
                raise ImportError(
                    "WandbTracker requires the `wandb` package, which is not "
                    "installed in this environment. Install wandb (needs "
                    "network egress) or drop the tracker — BaseTrainer's "
                    "built-in history/metrics.jsonl sinks are always on."
                ) from e
        self._wandb = wandb_module
        self._run = wandb_module.init(project=project, name=name,
                                      config=dict(config or {}), **init_kwargs)
        self._finished = False

    def __call__(self, record: Dict[str, Any]) -> None:
        if self._finished:
            return
        step = record.get("step")
        metrics = {k: v for k, v in record.items()
                   if k != "step" and isinstance(v, (int, float))}
        self._wandb.log(metrics, step=step)

    def finish(self) -> None:
        if not self._finished:
            self._finished = True
            self._wandb.finish()
