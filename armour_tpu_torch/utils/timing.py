"""Timing: CUDA events on the card, time.perf_counter on the CPU.

Device times come only from CUDA events (or a host clock around work that
ends in torch.cuda.synchronize); a CPU run measures the CPU and is never
reported as a device time.
"""

from __future__ import annotations

import statistics
import time

import torch


def sync(device) -> None:
    """Wait for all queued work on `device`."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_ms(fn, device, iters: int = 20, warmup: int = 2) -> list:
    """Per-call times of fn() in milliseconds, each taken on its own: CUDA
    events around the call on the card (recorded on `device`'s current
    stream, whatever the current device is), perf_counter on the CPU."""
    dev = torch.device(device)
    for _ in range(warmup):
        fn()
    sync(dev)
    times = []
    for _ in range(iters):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            stream = torch.cuda.current_stream(dev)
            start.record(stream)
            fn()
            end.record(stream)
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def median_ms(fn, device, iters: int = 20, warmup: int = 2) -> float:
    return statistics.median(device_ms(fn, device, iters, warmup))


def wall_s(fn, device):
    """(seconds, result) of one call of fn, host clock around work that ends
    in a device synchronisation."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return time.perf_counter() - t0, out


def _sync_cards() -> None:
    """Wait for all queued work on every visible card; nothing on the CPU."""
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(torch.device("cuda", i))


def bench(fn, *args, iters: int = 5, warmup: int = 1):
    """(best seconds, last output) of fn(*args) over iters calls after warmup
    calls, each timed by the host clock around work that ends with every
    visible card idle."""
    def call():
        out = fn(*args)
        _sync_cards()
        return out

    out = None
    for _ in range(warmup):
        out = call()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        out = call()
        best = min(best, time.perf_counter() - t0)
    return best, out
