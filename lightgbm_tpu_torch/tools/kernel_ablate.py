"""K8: stage ablation of the partition kernel K3 on the card.

    python -m lightgbm_tpu_torch.tools.kernel_ablate [rows_millions]

Port of tools/kernel_ablate.py, with its defaults: 4M rows, F=28 feature
planes of random bins below B=255, the split of channel 0 at B // 2 with
stream A in place at the segment's start, 10 passes a stage.  For the f32
and the int8 arena it times K3 in decision mode compiled to each
cumulative stage of csrc/partition_ablate.cu (ops/partition_kernel.py
`ABLATE_STAGES`):

- read:     each tile's planes staged in shared memory, summed into a
  checksum a tile;
- decide:   + each row's decision and the block scan of the flags;
- lookback: + the status words and the decoupled look-back (each row's
  destination column summed);
- stage:    + the output permutation in shared memory and the gather of
  every output word from the staged tile;
- full:     + the coalesced stores of both streams: K3 itself.

The TPU tool's stages `pbuild` and `matmul` build and apply one-hot
permutation matrices, which a TPU needs because it has no scatter; on
Hopper their work is the stage and store stages.  Before it times, the
full stage is held exactly equal to K3's plain version on a copy of the
arena.  Prints the mean ms a pass of each stage (CUDA events around the
passes) and its increment over the stage before; needs a CUDA device.
"""
from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import torch

from ..ops import partition_kernel as pk
from . import cuda_ms

FEATURES = 28
MAX_BIN = 255
REPS = 10


def _arena(n: int, G: int, bins: torch.Tensor, quantized: bool, dev,
           rng: np.random.RandomState) -> pk.Arena:
    """A factor-3 arena (the JAX tool's `arena_geometry(n, F)`) holding the
    rows in its first n columns."""
    a = pk.Arena(n, G, 3, dev, quantized=quantized)
    pk.init_pristine(a, bins)
    if quantized:
        a.payload[:, :n] = torch.from_numpy(
            rng.randint(-127, 128, (2, n)).astype(np.int8)).to(dev)
    else:
        a.payload[:, :n] = torch.from_numpy(
            rng.randn(2, n).astype(np.float32)).to(dev)
    return a


def run(n: int, G: int = FEATURES, B: int = MAX_BIN, reps: int = REPS,
        device=None, seed: int = 0) -> Dict[str, dict]:
    """{"f32"|"int8": {"ms": {stage: ms a pass}, "rows": n, "cnt_a":
    stream A's rows, "plain_ms": K3's plain version, "library_ms": a stable
    sort of the side key, "bytes": K3's byte count}}; raises if the full
    stage differs from K3's plain version."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda":
        raise ValueError("K8 times kernels on a CUDA device, got %s" % dev)
    rng = np.random.RandomState(seed)
    bins = torch.from_numpy(rng.randint(0, B, (G, n)).astype(np.uint8)).to(dev)
    goleft = (torch.arange(256, device=dev) < B // 2).to(torch.uint8)
    dst_b = -(-n // pk.TILE) * pk.TILE + pk.TILE
    out = {}
    for quantized in (False, True):
        ak = _arena(n, G, bins, quantized, dev, rng)
        ap = pk.Arena(n, G, 3, dev, quantized=quantized)
        for mine, theirs in ((ap.bins, ak.bins), (ap.payload, ak.payload),
                             (ap.rid, ak.rid)):
            mine.copy_(theirs)

        def sc():
            return torch.tensor([0, n, 0, dst_b, 0, 0, 0, 0],
                                dtype=torch.int32, device=dev)
        sc_k, sc_p = sc(), sc()
        pk.partition_ablate(ak, sc_k, goleft, "full")
        pk.partition_segment_plain(ap, sc_p, goleft)
        n_a = int(sc_k[pk.SC_CNT_A])
        regions = ((0, n_a), (dst_b, n - n_a))
        same = torch.equal(sc_k, sc_p) and all(
            torch.equal(x[..., s:s + c], y[..., s:s + c])
            for x, y in ((ak.bins, ap.bins), (ak.payload, ap.payload),
                         (ak.rid, ap.rid)) for s, c in regions)
        if not same:
            raise RuntimeError("K8 full stage (%s arena) differs from K3's "
                               "plain version" % ("int8" if quantized
                                                  else "f32"))
        plain_ms = cuda_ms(
            lambda: pk.partition_segment_plain(ap, sc(), goleft), 3)
        del ap
        # the library yardstick of K3: a stable sort of the side key
        key = (goleft[ak.bins[0, :n].long()] != 0).to(torch.uint8)
        library_ms = cuda_ms(lambda: torch.sort(key, stable=True), 5)
        del key
        ms = {}
        for stage in pk.ABLATE_STAGES:
            s = sc()
            ms[stage] = cuda_ms(
                lambda: pk.partition_ablate(ak, s, goleft, stage), reps)
        out["int8" if quantized else "f32"] = dict(
            ms=ms, rows=n, cnt_a=n_a, plain_ms=plain_ms,
            library_ms=library_ms, bytes=pk.partition_bytes(n, G, quantized))
        del ak
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(float(argv[0]) * 1e6) if argv else 4_000_000
    if not torch.cuda.is_available():
        print("kernel_ablate: no CUDA device", file=sys.stderr)
        return 1
    print("%s: n=%d G=%d B=%d reps=%d" % (torch.cuda.get_device_name(0), n,
                                          FEATURES, MAX_BIN, REPS))
    for arena, r in run(n).items():
        print("%s arena (K3 full stage equal to its plain version; %d of %d "
              "rows in stream A; K3 plain %.4f ms, stable sort of the side "
              "key %.4f ms):" % (arena, r["cnt_a"], n, r["plain_ms"],
                                 r["library_ms"]))
        prev = 0.0
        for stage, ms in r["ms"].items():
            print("  %-8s %8.4f ms/pass (+%8.4f)" % (stage, ms, ms - prev))
            prev = ms
    return 0


if __name__ == "__main__":
    sys.exit(main())
