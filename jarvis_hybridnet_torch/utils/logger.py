"""Training metrics logging (a copy of ``jarvis_hybridnet_tpu/utils/logger.py``).

Equivalent of the reference NetLogger / AverageMeter
(jarvis/utils/logger.py:10-140): TensorBoard scalars (train/val loss &
accuracy, learning rate) under ``projects/<p>/logs/<module>/<run>``, with a
CSV fallback when TensorBoard's writer is unavailable.
"""

from __future__ import annotations

import csv
import os


class NetLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir, flush_secs=10)
        except Exception:
            self._csv = open(os.path.join(log_dir, "metrics.csv"), "w",
                             newline="")
            self._csv_writer = csv.writer(self._csv)
            self._csv_writer.writerow(["tag", "step", "value"])
        self._steps: dict[str, int] = {}

    def _log(self, tag: str, value: float) -> None:
        step = self._steps.get(tag, 0)
        self._steps[tag] = step + 1
        if self._writer is not None:
            self._writer.add_scalar(tag, value, step)
        else:
            self._csv_writer.writerow([tag, step, value])
            self._csv.flush()

    def update_train_loss(self, v): self._log("Train Loss", float(v))
    def update_train_accuracy(self, v): self._log("Train Accuracy", float(v))
    def update_val_loss(self, v): self._log("Val Loss", float(v))
    def update_val_accuracy(self, v): self._log("Val Accuracy", float(v))
    def update_learning_rate(self, v): self._log("Learning Rate", float(v))

    def close(self):
        if self._writer is not None:
            self._writer.close()


class AverageMeter:
    """Running average (reference: jarvis/utils/logger.py:101-140)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value, n: int = 1):
        self.sum += float(value) * n
        self.count += n

    def read(self) -> float:
        if self.count == 0:
            return float("nan")
        return self.sum / self.count


class NullLogger:
    """``NetLogger``'s interface, writing nothing: the logger of a rank that
    is not the primary one (``utils/preemption.is_primary_host``)."""

    def _log(self, *args) -> None:
        pass

    update_train_loss = update_train_accuracy = update_val_loss = _log
    update_val_accuracy = update_learning_rate = _log

    def close(self):
        pass
