"""Structured observability — JSON-lines event/timing log (port of
vdx/utils/logging.py; pure Python, the port keeps its own copy).

Per-step timing and metric events as JSON lines (greppable,
pandas-loadable), mirrored to stdout for the human; quality metrics keep
their own JSON/CSV files (vdx_torch.metrics, vdx_torch.analysis).
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Any, Dict, Optional


class EventLog:
    def __init__(self, path: Optional[str | Path] = None, echo: bool = True):
        self.path = Path(path) if path else None
        self.echo = echo
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
        self._t0 = time.time()

    def log(self, event: str, **fields: Any) -> Dict:
        rec = {"t": round(time.time() - self._t0, 4), "event": event, **fields}
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if self.echo:
            kv = " ".join(f"{k}={v}" for k, v in fields.items())
            print(f"[{rec['t']:9.3f}s] {event} {kv}")
        return rec

    @contextlib.contextmanager
    def span(self, name: str, **fields):
        t0 = time.time()
        try:
            yield
        finally:
            self.log(name, seconds=round(time.time() - t0, 4), **fields)


@contextlib.contextmanager
def timed(label: str, sink=print):
    t0 = time.time()
    try:
        yield
    finally:
        sink(f"{label}: {time.time() - t0:.3f}s")
