"""Tracing and per-stage timing.

The reference scatters wall-clock prints through its hot paths
(mapping.py:1125, transform.py:335, astrometry.py:264 — SURVEY.md section
5). Here timing is structured: a :class:`StageTimer` collects named stage
durations, :func:`device_trace` wraps jax.profiler for TensorBoard-readable
device traces, and :func:`benchmark` measures jitted callables with proper
synchronisation.
"""

import contextlib
import time
from collections import defaultdict


class _StageHandle:
    def __init__(self, enabled):
        self.enabled = enabled

    def sync(self, out):
        """Wait for ``out`` to be computed (``jax.block_until_ready``)."""
        if not self.enabled:
            return out
        import jax

        return jax.block_until_ready(out)


class StageTimer:
    """Collects named wall-clock stage timings.

    Usage::

        timer = StageTimer()
        with timer("georef"):
            out = georeference(...)
        print(timer.report())
    """

    def __init__(self, sync=True):
        self.times = defaultdict(list)
        self.sync = sync

    @contextlib.contextmanager
    def __call__(self, name):
        """Time a stage. For async backends, pass the stage's OUTPUT to
        the yielded handle so the timer can synchronize on it::

            with timer("georef") as stage:
                out = georeference(...)
                stage.sync(out)

        Without a sync target the stage measures DISPATCH time on async
        backends; ``sync()`` waits with ``jax.block_until_ready``."""
        handle = _StageHandle(self.sync)
        t0 = time.perf_counter()
        try:
            yield handle
        finally:
            self.times[name].append(time.perf_counter() - t0)

    def total(self, name):
        return sum(self.times[name])

    def report(self):
        lines = []
        for name, ts in self.times.items():
            total = sum(ts)
            lines.append(
                f"{name}: {total*1e3:.2f} ms total, {len(ts)} calls, "
                f"{total/len(ts)*1e3:.2f} ms avg"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir):
    """Capture a device profile viewable in TensorBoard/XProf.

    Device equivalent of the reference's cProfile harness
    (auromat/test/profiling.py:16-73).
    """
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def benchmark(fn, *args, iters=10, warmup=2):
    """Median wall time of a (jitted) callable, each call waited for with
    ``jax.block_until_ready``.

    :returns: (median_seconds, all_times)
    """
    import numpy as np

    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), times


def annotate(name):
    """Named-scope annotation visible in device traces."""
    import jax

    return jax.profiler.TraceAnnotation(name)
