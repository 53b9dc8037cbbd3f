"""Result of a training/tuning run. Parity: ``python/ray/air/result.py``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.train._checkpoint import Checkpoint


@dataclass
class Result:
    metrics: Dict[str, Any] = field(default_factory=dict)
    checkpoint: Optional[Checkpoint] = None
    path: str = ""
    error: Optional[Exception] = None
    metrics_dataframe: Optional[Any] = None
    best_checkpoints: List = field(default_factory=list)
    # elastic-training accounting: wall_s / useful_step_s / steps_redone /
    # goodput (useful-step-time over wall-time) for the whole fit() call,
    # across every in-run recovery and gang restart
    goodput: Optional[Dict[str, Any]] = None

    @property
    def config(self):
        return self.metrics.get("config")
