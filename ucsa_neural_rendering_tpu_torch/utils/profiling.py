"""Profiling (counterpart of the JAX package's utils/profiling.py, the
reference's opt-in Lightning AdvancedProfiler gated by
exp["trainer"]["profiler"]): a torch.profiler trace of a block, and a
wall-clock timer that appends one JSON line per phase to
`profile_steps.jsonl`.
"""

import contextlib
import json
import os
import time


@contextlib.contextmanager
def maybe_trace(enabled: bool, logdir: str):
    """torch.profiler over the block (CPU, and CUDA when a card is
    present), its Chrome trace written to logdir/trace.json; a no-op when
    not enabled."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Per-phase wall-clock logger (JSONL). Call tick(tag) after each
    phase: it records the seconds since the previous tick (or since the
    timer was made)."""

    def __init__(self, path: str | None):
        self._f = open(path, "a") if path else None
        self._t = time.perf_counter()

    def tick(self, tag: str, **extra):
        now = time.perf_counter()
        dt = now - self._t
        self._t = now
        if self._f is not None:
            rec = {"tag": tag, "seconds": dt}
            rec.update(extra)
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        return dt

    def close(self):
        if self._f is not None:
            self._f.close()
