"""Training metrics and the eval loop's recall records (host).

The port's copy of ``virconv_tpu/utils/metrics.py``: ``MetricsLogger``
writes scalars to a JSONL event log and, when ``torch.utils.tensorboard``
imports, to TensorBoard, and times host phases; ``compute_recall`` counts
the gt boxes a frame's predictions hit. Device traces come from
``torch.profiler`` (``profile_train.py``), not from this module.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

from ..ops import boxes_np


class MetricsLogger:
    def __init__(self, log_dir, use_tensorboard=True):
        """``log_dir`` None: phases are timed and nothing is written (the
        ranks of a data-parallel run but rank 0)."""
        self.log_dir = None if log_dir is None else Path(log_dir)
        self._jsonl = None
        self._tb = None
        self._phase_totals = {}
        if self.log_dir is None:
            return
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / 'events.jsonl', 'a')
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(str(self.log_dir))
            except Exception:           # tensorboard is not installed
                self._tb = None

    def scalar(self, tag: str, value: float, step: int):
        if self._jsonl is None:
            return
        self._jsonl.write(json.dumps(
            {'tag': tag, 'value': float(value), 'step': int(step),
             'time': time.time()}) + '\n')
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def scalars(self, prefix: str, values: dict, step: int):
        """Every value that converts to a float, as ``<prefix>/<key>``."""
        for k, v in values.items():
            try:
                value = float(v)
            except (TypeError, ValueError):
                continue
            self.scalar(f'{prefix}/{k}', value, step)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Accumulating host phase timer."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            acc, cnt = self._phase_totals.get(name, (0.0, 0))
            self._phase_totals[name] = (acc + dt, cnt + 1)

    def phase_summary(self):
        return {name: {'total_s': acc, 'count': cnt,
                       'mean_ms': 1000 * acc / max(cnt, 1)}
                for name, (acc, cnt) in self._phase_totals.items()}

    def close(self):
        if self._jsonl is None:
            return
        if self._phase_totals:
            self._jsonl.write(json.dumps(
                {'phase_summary': self.phase_summary()}) + '\n')
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def compute_recall(pred_boxes, gt_boxes, thresh_list=(0.3, 0.5, 0.7)):
    """{'recall_<t>': (gt boxes hit at 3D IoU > t, gt boxes)} of one
    frame."""
    if len(gt_boxes) == 0:
        return {f'recall_{t}': (0, 0) for t in thresh_list}
    if len(pred_boxes) == 0:
        return {f'recall_{t}': (0, len(gt_boxes)) for t in thresh_list}
    best = boxes_np.boxes_iou3d(gt_boxes[:, :7],
                                pred_boxes[:, :7]).max(axis=1)
    return {f'recall_{t}': (int((best > t).sum()), len(gt_boxes))
            for t in thresh_list}
