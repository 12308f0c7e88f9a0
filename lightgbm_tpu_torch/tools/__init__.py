"""Measurement tools of the port, run on the card (python -m ...)."""
import torch


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms of fn() over reps back-to-back calls between two CUDA
    events, after warm-up calls."""
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps
