"""Per-term loss history with JSONL persistence (port of
flowerdiff/train/metrics.py)."""
from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List


class LossHistory:
    def __init__(self):
        self.history: Dict[str, List[float]] = defaultdict(list)

    def append(self, metrics: Dict[str, float]) -> None:
        for key, value in metrics.items():
            self.history[key].append(float(value))

    def last(self, key: str) -> float:
        return self.history[key][-1]

    def save_jsonl(self, path: str) -> None:
        """One line an epoch: {"epoch": i, key: value, ...}, keys sorted."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        keys = sorted(self.history)
        n = max((len(v) for v in self.history.values()), default=0)
        with open(path, "w") as fh:
            for i in range(n):
                row = {k: self.history[k][i] for k in keys if i < len(self.history[k])}
                fh.write(json.dumps({"epoch": i, **row}) + "\n")

    @classmethod
    def load_jsonl(cls, path: str) -> "LossHistory":
        out = cls()
        with open(path) as fh:
            for line in fh:
                row = json.loads(line)
                row.pop("epoch", None)
                out.append(row)
        return out
