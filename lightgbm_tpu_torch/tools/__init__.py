"""Measurement tools of the port, run on the card (python -m ...)."""
import numpy as np
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


def tree_row_order(counts, rng, previous_leaves: int = 0) -> np.ndarray:
    """Row ids of leaf segments of `counts` rows, in leaf order, as a grown
    tree leaves them: the rows dealt to the leaves at random, each leaf's
    rows in the order of the block the tree grew on (a stable partition
    keeps it): row order at the pristine root, or, with previous_leaves,
    the carried block of an earlier tree of that many leaves (its leaves in
    turn, each in row order).  int32 [sum(counts)]."""
    n = int(np.sum(counts))
    block = np.arange(n)
    if previous_leaves:
        block = np.argsort(rng.randint(0, previous_leaves, n), kind="stable")
    leaf = rng.permutation(np.repeat(np.arange(len(counts)), counts))
    return block[np.argsort(leaf, kind="stable")].astype(np.int32)
