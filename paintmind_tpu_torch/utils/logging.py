"""Metric logging (the port's own copy of ``paintmind_tpu/utils/logging.py``):
the reference's in-memory Log accumulator (paintmind/utils/trainer.py:39-58)
plus a tensorboard-or-JSONL writer in place of ``accelerator.log``
(trainer.py:246-256, 416)."""

from __future__ import annotations

import json
import os
import time


class Log:
    """(reference trainer.py:39-58)."""

    def __init__(self):
        self.data = {}

    def add(self, name_value):
        for name, value in name_value.items():
            if name not in self.data:
                self.data[name] = value
            else:
                self.data[name] += value

    def update(self, name_value):
        self.data.update(name_value)

    def reset(self):
        self.data = {}

    def __getitem__(self, name):
        return self.data[name]

    def __contains__(self, name):
        return name in self.data


class MetricWriter:
    """Tensorboard writer (``torch.utils.tensorboard``) where the
    ``tensorboard`` package is importable, else a JSONL file, which always
    works.  Set ``PAINTMIND_JSONL_LOG=1`` to take the JSONL sink even when
    tensorboard is there: the curve files stay greppable and plottable
    without an event reader."""

    def __init__(self, log_dir, name='run'):
        self.log_dir = os.path.join(log_dir, name)
        os.makedirs(self.log_dir, exist_ok=True)
        self._tb = None
        if os.environ.get('PAINTMIND_JSONL_LOG') != '1':
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(self.log_dir)
            except ImportError:
                pass
        if self._tb is None:
            self._jsonl = open(os.path.join(self.log_dir, 'metrics.jsonl'), 'a')

    def log(self, metrics, step):
        metrics = {k: float(v) for k, v in metrics.items()}
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, step)
        else:
            self._jsonl.write(json.dumps({'step': int(step),
                                          'time': time.time(), **metrics}) + '\n')
            self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()
        else:
            self._jsonl.close()
