"""Structured JSONL event logging (the port's copy of
tpu_icp_slam/obs/metrics.py): one JSON object per event, static fields
stamped on every record."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, static_fields: Optional[dict] = None):
        self.path = path
        self.static = dict(static_fields or {})
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")

    def log(self, event: str, **fields: Any) -> dict:
        rec = {"t": time.time(), "event": event, **self.static, **fields}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
