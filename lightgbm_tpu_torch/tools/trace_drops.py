"""How many device events a torch.profiler trace drops as the process ages,
and whether `chip_smoke.traced`'s spin kernels absorb the drops.

    python lightgbm_tpu_torch/tools/trace_drops.py [--seconds 240]
        [--every 20] [--rows 2000000]

On `chip_smoke.py`'s Higgs-shaped data, binned: every `--every` seconds
(the card kept busy by matrix products in between, no profiler on), 20
K2 root calls (a fill and a kernel each) are traced four ways: plain;
after 200 small kernels; followed by 200 small kernels; and through
`chip_smoke.traced` (TRACE_PAD spin kernels first).  Each line prints the
process's age and, for each way, the K2 events held of 20 and the device
events held of those launched.  A trace that drops its first events
keeps the K2 events only behind a pad.
"""
from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=240.0)
    ap.add_argument("--every", type=float, default=20.0)
    ap.add_argument("--rows", type=int, default=2_000_000)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(REPO))
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("trace_drops: no CUDA device", file=sys.stderr)
        return 1
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import partition_kernel as pk
    cs = _chip_smoke()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    X, y, _Xh, _yh = cs.higgs_like(args.rows)
    ds = lt.Dataset(X, y, params=cs.PARAMS, device=dev).construct()
    b = ds._binned
    a = pk.Arena(b.num_data, b.num_features, 4, dev)
    pk.init_pristine(a, b.device_bins(dev).t())
    seg = torch.tensor([0, b.num_data], dtype=torch.int32, device=dev)
    tiny = torch.zeros(1, device=dev)
    m = torch.randn(4096, 4096, device=dev)
    DEV = torch.autograd.DeviceType.CUDA

    def k2():
        for _ in range(20):
            pk.segment_histogram(a, seg, 255)

    def pad():
        for _ in range(200):
            tiny.add_(1)

    def plain(pre=False, post=False):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            if pre:
                pad()
            k2()
            if post:
                pad()
            torch.cuda.synchronize()
        device = [ev for ev in prof.events() if ev.device_type == DEV]
        held = sum(cs.kernel_label(ev.name) is not None for ev in device)
        return "%d, %d/%d" % (held, len(device), 40 + 200 * (pre + post))

    def spun():
        _, device, pad_held = cs.traced(k2, [ProfilerActivity.CUDA])
        held = sum(cs.kernel_label(ev.name) is not None for ev in device)
        return "%d, %d/%d" % (held, len(device) + pad_held,
                              40 + cs.TRACE_PAD)

    k2()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        age = time.perf_counter() - t0
        print("age %4.0f s: K2 events held of 20, device events held of "
              "launched: plain %s; 200 kernels before %s; 200 after %s; "
              "traced %s" % (age, plain(), plain(pre=True), plain(post=True),
                             spun()), flush=True)
        t = time.perf_counter()
        while time.perf_counter() - t < args.every:
            for _ in range(50):
                m @ m
            torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
