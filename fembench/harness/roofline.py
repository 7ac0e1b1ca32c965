"""The card's peaks and a kernel's cold time, taken as `chip_smoke.py` takes
them: CUDA events around each call, the 50 MB L2 emptied before each by a
read of 256 MB, the median over the calls.
"""

from __future__ import annotations

import subprocess

import torch

# NVIDIA H100 SXM data sheet, at its 700 W limit: HBM3 at 3.35 TB/s; FP64
# 34 TFLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12}


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    """(ms, 'bytes' | 'operations'): the least time of the work on the
    card, the larger of its bytes over the memory rate and its operations
    over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cold_ms(fn, reps: int = 25) -> float:
    """Median CUDA-event time of fn() after a 256 MB read, over reps
    calls, after one warm-up call."""
    flush = torch.ones(32 * 2 ** 20, dtype=torch.float64, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    del flush
    times.sort()
    return times[len(times) // 2]


def power_limit_w():
    """The card's power limit in W as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
