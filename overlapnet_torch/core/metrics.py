"""Structured metric logging.

The reference hand-writes TensorBoard scalars via tf.summary.FileWriter
(reference: training.py:356-417) plus a per-run ``training.log``. Here:
newline-delimited JSON (one record per step/epoch) plus mirrored console
logging — trivially greppable and diffable, with the same metric names so
results stay comparable — plus an optional TensorBoard event-file mirror
(``tensorboard=True`` or env OVERLAPNET_TENSORBOARD=1) so the reference's
TB-based workflow keeps working.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Mapping


class MetricWriter:
    """Append metric records to a .jsonl file and the module logger."""

    def __init__(self, out_dir: str, name: str = "metrics",
                 tensorboard: bool | None = None):
        os.makedirs(out_dir, exist_ok=True)
        self._path = os.path.join(out_dir, f"{name}.jsonl")
        self._file = open(self._path, "a")
        self._log = logging.getLogger("overlapnet_torch")
        self._tb = None
        if tensorboard is None:
            tensorboard = os.environ.get("OVERLAPNET_TENSORBOARD", "") not in ("", "0")
        if tensorboard:
            try:
                # Lazy, optional: writes standard tfevents files readable by
                # `tensorboard --logdir` (reference training.py:356-417).
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(out_dir, "tb", name))
            except Exception as e:  # pragma: no cover - env-dependent
                self._log.warning("TensorBoard writer unavailable: %s", e)

    @property
    def path(self) -> str:
        return self._path

    def write(self, step: int, values: Mapping[str, Any], **extra: Any) -> None:
        record = {"step": int(step), "time": time.time(), **values, **extra}
        self._file.write(json.dumps(record, default=_jsonable) + "\n")
        self._file.flush()
        if self._tb is not None:
            prefix = str(extra.get("phase", "")) or "metrics"
            for k, v in values.items():
                try:
                    self._tb.add_scalar(f"{prefix}/{k}", float(v), int(step))
                except (TypeError, ValueError):
                    pass  # non-scalar values stay jsonl-only
            self._tb.flush()
        pretty = ", ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in values.items()
        )
        self._log.info("step %d: %s", step, pretty)

    def close(self) -> None:
        self._file.close()
        if self._tb is not None:
            self._tb.close()


def _jsonable(value):
    try:
        return float(value)
    except (TypeError, ValueError):
        return str(value)


def setup_logging(out_dir: str | None = None, filename: str = "training.log") -> logging.Logger:
    """Console + optional per-experiment file logging (reference:
    training.py:98-100, 203-208)."""
    logger = logging.getLogger("overlapnet_torch")
    logger.setLevel(logging.INFO)
    if not any(isinstance(h, logging.StreamHandler) for h in logger.handlers):
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(handler)
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, filename)
        if not any(
            isinstance(h, logging.FileHandler) and h.baseFilename == os.path.abspath(path)
            for h in logger.handlers
        ):
            fh = logging.FileHandler(path, mode="w")
            fh.setFormatter(
                logging.Formatter(fmt="%(asctime)s %(message)s", datefmt="%H:%M:%S")
            )
            logger.addHandler(fh)
    return logger
