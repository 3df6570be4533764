"""Phase timing harness — the equivalent of the reference ``DebugTimer``
(``DebugTimer.cpp:6-31``): label -> accumulated wall time, mean ms and "fps"
printed every n-th ``end``.  For device work the timers bracket
``jax.block_until_ready`` so the numbers are honest (the reference brackets the
GL queue with ``glFinish``, ``main.cpp:377-408``), and an optional
``jax.profiler`` trace can be attached to a scope.
"""
from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field

import jax

__all__ = ["DebugTimer", "timed", "Metrics"]


@dataclass
class _Entry:
    report_every: int = 1
    count: int = 0
    total: float = 0.0
    start: float = 0.0


class DebugTimer:
    """Static label->timer map like the reference's ``DebugTimer::Begin/End``."""

    _timers: dict[str, _Entry] = {}
    verbose: bool = True

    @classmethod
    def begin(cls, report_every: int, label: str) -> None:
        e = cls._timers.setdefault(label, _Entry(report_every=report_every))
        e.report_every = report_every
        e.start = time.perf_counter()

    @classmethod
    def end(cls, label: str, sync: object = None) -> float:
        if sync is not None:
            jax.block_until_ready(sync)
        e = cls._timers[label]
        dt = time.perf_counter() - e.start
        e.total += dt
        e.count += 1
        if e.count % e.report_every == 0:
            mean_ms = e.total / e.count * 1000.0
            if cls.verbose:
                fps = 1000.0 / mean_ms if mean_ms > 0 else float("inf")
                print(f"[{label}] mean {mean_ms:.3f} ms over {e.count} calls ({fps:.1f}/s)")
        return dt

    @classmethod
    def mean_ms(cls, label: str) -> float:
        e = cls._timers[label]
        return e.total / max(e.count, 1) * 1000.0

    @classmethod
    def reset(cls) -> None:
        cls._timers.clear()


@contextlib.contextmanager
def timed(label: str, sync_value=None, report_every: int = 1,
          profile: bool = False, profile_dir: str | None = None):
    """Timed scope.  With ``profile=True`` the scope also runs under a
    ``jax.profiler.trace`` (written to ``profile_dir``, default
    ``<tempdir>/vr_trace/<label>``) with a ``TraceAnnotation`` carrying the
    label — the trace half of the reference ``DebugTimer`` equivalent
    (SURVEY.md §5: phase timers + ``jax.profiler`` integration)."""
    DebugTimer.begin(report_every, label)
    result = {}
    stack = contextlib.ExitStack()
    if profile:
        import os
        import tempfile

        tdir = profile_dir or os.path.join(tempfile.gettempdir(), "vr_trace",
                                           label)
        os.makedirs(tdir, exist_ok=True)
        stack.enter_context(jax.profiler.trace(tdir))
        stack.enter_context(jax.profiler.TraceAnnotation(label))
        result["trace_dir"] = tdir
    try:
        with stack:
            yield result
    finally:
        result["seconds"] = DebugTimer.end(label, sync=sync_value)


@dataclass
class Metrics:
    """Structured per-phase metrics (PSNR / max error / compression ratio /
    rays-per-second), emitted as JSON — replaces the reference's std::cout
    prints (``VolumeKdTree_recover.cpp:71-84,115-129,134-139``)."""

    values: dict = field(default_factory=dict)

    def record(self, **kwargs) -> None:
        self.values.update(kwargs)

    def json(self) -> str:
        return json.dumps(self.values, sort_keys=True)

    def print(self) -> None:
        print(self.json())
