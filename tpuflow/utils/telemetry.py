"""Structured telemetry — the reference's printf diagnostics, formalized.

The reference reports progress with ANSI progress bars (main.cpp:3-17),
IRLS energy traces printed every 64 iterations
(``SHOW_IRLS_OPTICALFLOW_PYRAMID_E``, OpticalFlow.cpp:261-265), and
parameter banners (Scratch_MeaningfulMotion.cpp:276-312). SURVEY.md §5.1/
§5.5 calls for the same signals as structured logs plus profiler hooks:

- :class:`Telemetry` — JSON-lines event sink (stderr or file) with
  ``event(name, **fields)`` and wall-clock ``trace_span`` context;
- :class:`EnergyTrace` — records (iteration, energy) pairs per solver
  level, exportable as a dict (the E(n) cadence of the reference);
- ``jax.profiler`` integration: ``trace_span(..., profile=True)`` wraps
  the block in a ``jax.profiler.TraceAnnotation`` so spans show up in
  device profiles.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from dataclasses import dataclass, field


class Telemetry:
    def __init__(self, stream=None, enabled: bool = True):
        self.stream = stream if stream is not None else sys.stderr
        self.enabled = enabled

    def event(self, name: str, **fields) -> None:
        if not self.enabled:
            return
        rec = {"ts": time.time(), "event": name, **fields}
        print(json.dumps(rec, default=float), file=self.stream, flush=True)


_GLOBAL = Telemetry(enabled=False)


def get_telemetry() -> Telemetry:
    return _GLOBAL


def set_telemetry(t: Telemetry) -> None:
    global _GLOBAL
    _GLOBAL = t


@contextlib.contextmanager
def trace_span(name: str, profile: bool = False, **fields):
    """Timed span: emits '<name>.done' with wall seconds; optionally
    annotates the device profile via jax.profiler."""
    t0 = time.perf_counter()
    ctx = contextlib.nullcontext()
    if profile:
        import jax.profiler

        ctx = jax.profiler.TraceAnnotation(name)
    with ctx:
        yield
    _GLOBAL.event(f"{name}.done", wall_s=time.perf_counter() - t0, **fields)


@dataclass
class EnergyTrace:
    """Per-level IRLS energy trace (the reference's E(n) prints)."""

    levels: dict = field(default_factory=dict)

    def record(self, level: int, iteration: int, energy: float) -> None:
        self.levels.setdefault(level, []).append((iteration, float(energy)))
        get_telemetry().event("irls.energy", level=level,
                              iteration=iteration, energy=float(energy))

    def as_dict(self) -> dict:
        return {str(k): v for k, v in self.levels.items()}
