"""Tracing / profiling — greenfield (SURVEY.md §5: the reference has none).

Three layers:

* :class:`PhaseTimer` — lightweight wall-clock phase accounting for the host
  loop (frontend / filter / eval / serialize), with correct device-sync
  boundaries (``block_until_ready`` before stamping, else JAX async dispatch
  makes every phase look free and the last one pay for everything);
* :func:`device_trace` — context manager around ``jax.profiler.trace`` for
  full XLA/GPU traces viewable in TensorBoard/Perfetto;
* :func:`annotate` — ``jax.profiler.TraceAnnotation`` wrapper so host phases
  show up inside the device timeline.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional


class PhaseTimer:
    """Accumulates per-phase wall time across loop iterations."""

    def __init__(self, sync: bool = True):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.sync = sync

    @contextlib.contextmanager
    def phase(self, name: str, *sync_args):
        """Time a phase; pass device arrays in ``sync_args`` to block on them
        before stamping the end time."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and sync_args:
                import jax

                jax.block_until_ready(sync_args)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        out = {}
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            out[name] = {
                "total_s": round(total, 4),
                "count": n,
                "mean_ms": round(total / max(n, 1) * 1e3, 3),
            }
        return out

    def report(self) -> str:
        lines = [f"{'phase':<20} {'total s':>10} {'count':>8} {'mean ms':>10}"]
        for name, row in self.summary().items():
            lines.append(
                f"{name:<20} {row['total_s']:>10.3f} {row['count']:>8d} "
                f"{row['mean_ms']:>10.3f}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture an XLA device trace (open with TensorBoard / Perfetto)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region visible in device traces."""
    import jax

    return jax.profiler.TraceAnnotation(name)
