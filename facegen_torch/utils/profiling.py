"""Per-epoch metrics log (counterpart of facegen/utils/profiling.py's
MetricsLogger): one JSON line per epoch in ``<save>/metrics.jsonl``."""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, save_dir: str, name: str = "metrics.jsonl"):
        os.makedirs(save_dir, exist_ok=True)
        self.path = os.path.join(save_dir, name)

    def log(self, record: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({"time": time.time(), **record}) + "\n")
