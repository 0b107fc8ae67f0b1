"""The profiling hook of the CLI: ``maybe_profile``.

The counterpart of ``cfk_tpu/utils/metrics.py`` (whose hook is a lazy
``jax.profiler.trace``); the metrics registry itself lives in
``cfk_tpu_torch.telemetry.metrics``.
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def maybe_profile(profile_dir: str | None):
    """A torch.profiler session around the block when a directory is given
    (CPU activity, and CUDA activity when a card is present), its Chrome
    trace written to ``<profile_dir>/cfk_device_trace_<pid>.json`` at exit;
    otherwise a no-op.  Pass the same directory as ``--trace-dir`` to line
    the device timeline up with the host span trace
    (``cfk_tpu_torch.telemetry.trace``)."""
    if profile_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(profile_dir, f"cfk_device_trace_{os.getpid()}.json"))
