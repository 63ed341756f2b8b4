"""Logging / timing utilities (reference: Boost trivial log + the single
wall-clock readout, src/main.cpp:60-67,171-178 — here with per-stage
timers and a throughput reporter, SURVEY.md §5 tracing)."""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, Optional

__all__ = ["setup_logging", "StageTimers", "StreamTimer", "fmt_duration"]


def setup_logging(verbose: bool = False) -> None:
    logging.basicConfig(
        level=logging.DEBUG if verbose else logging.INFO,
        format="[%(asctime)s] [%(levelname)s] %(name)s: %(message)s",
        datefmt="%H:%M:%S",
    )


def fmt_duration(seconds: float) -> str:
    m, s = divmod(int(seconds), 60)
    return f"{m}m{s:02d}s" if m else f"{seconds:.2f}s"


class StageTimers:
    """Accumulating named wall-clock timers."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, log: Optional[logging.Logger] = None) -> str:
        lines = [
            f"{name}: {fmt_duration(t)} ({self.counts[name]} calls)"
            for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1])
        ]
        text = "; ".join(lines)
        if log:
            log.info("stage timings: %s", text)
        return text


class StreamTimer:
    """Host-side split of one block's chunk stream.

    ``staged()`` at the top of each loop pass adds the time the loop
    waited for the next staged chunk (read + decode + staging on the
    worker threads); ``stepped()`` after the step dispatch.  On the first
    chunk of a run (``first=True``) the step is synchronised and its time
    logged apart: the compile (or persistent-cache load) of the step plus
    one chunk's run.  ``report()`` logs the block's input wait against
    its stream time.  Cost: two clock reads per chunk.
    """

    def __init__(self, first: bool = False):
        self.first = first
        self.t0 = self._mark = time.perf_counter()
        self.wait = 0.0

    def staged(self) -> None:
        now = time.perf_counter()
        self.wait += now - self._mark
        self._mark = now

    def stepped(self, volume, log: logging.Logger) -> None:
        if self.first:
            import jax
            jax.block_until_ready(volume)
            now = time.perf_counter()
            log.info("first chunk: read + staged in %.2fs, first step "
                     "(compile/load + run) %.2fs", self.wait,
                     now - self._mark)
            self.first = False
        self._mark = time.perf_counter()

    def report(self, log: logging.Logger, index: int) -> None:
        log.info("block %d stream: %.2fs of %.2fs waiting for staged input",
                 index, self.wait, time.perf_counter() - self.t0)
