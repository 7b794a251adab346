"""Profiling and tracing helpers on ``torch.profiler`` (counterpart of
``prob_mbrl_tpu/utils/profiling.py``).

``trace`` captures a profile of the enclosed region (CPU, and CUDA where a
card is present) and writes it as a Chrome trace; ``annotate`` names a span
in it; ``section`` is a wall-clock timer that waits for the card's queued
work before it stops the clock.
"""
import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir):
    """Profile the enclosed region (the CPU, and the card where CUDA is
    available) and write ``logdir/trace.json`` (a Chrome trace, for
    Perfetto or chrome://tracing). Yields the profiler, whose
    ``key_averages()`` summarise it::

        with profiling.trace('runs/trace'):
            mc_pilco(...)
    """
    with_cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if with_cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if with_cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))


def annotate(name):
    """A named span in the profiler's timeline, as a context manager or a
    decorator: ``with annotate('rollout'): ...``."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def section(name, results=None, sync=True):
    """Wall-clock timer of the enclosed region. ``results`` (a dict)
    accumulates ``name -> seconds``. With ``sync`` the current CUDA
    device's queued work is waited for before the clock stops (where CUDA
    is available)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if results is not None:
            results[name] = results.get(name, 0.0) + dt


def device_memory_stats(device=None):
    """The allocator's statistics of a CUDA device
    (``torch.cuda.memory_stats``), or {} for the CPU, as JAX returns {}
    where the backend has none."""
    if device is None:
        device = 'cuda' if torch.cuda.is_available() else 'cpu'
    device = torch.device(device)
    if device.type != 'cuda':
        return {}
    return dict(torch.cuda.memory_stats(device))
