"""Append-only run logger (the port's own copy of
``eemflow_tpu/utils/logger.py``; reference ``utils/logger.py:6-77``): lines
to ``log.txt`` and one JSON record per log boundary to ``metrics.jsonl``."""

from __future__ import annotations

import json
import os
from typing import Any, Dict


class Logger:
    def __init__(self, save_path: str, filename: str = "log.txt"):
        os.makedirs(save_path, exist_ok=True)
        self.path = os.path.join(save_path, filename)
        self.jsonl_path = os.path.join(save_path, "metrics.jsonl")

    def write_line(self, line: str, verbose: bool = False) -> None:
        with open(self.path, "a") as f:
            f.write(line + "\n")
        if verbose:
            print(line, flush=True)

    def write_dict(self, d: Dict[str, Any], verbose: bool = False) -> None:
        for k, v in d.items():
            self.write_line(f"{k}: {v}", verbose)

    def write_jsonl(self, record: Dict[str, Any]) -> None:
        """Append one JSON record to ``metrics.jsonl`` (floats coerced)."""
        clean = {
            k: (float(v) if hasattr(v, "__float__") and not isinstance(v, (bool, int, str)) else v)
            for k, v in record.items()
        }
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(clean) + "\n")
