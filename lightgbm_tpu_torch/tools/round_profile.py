"""Device time by kernel in a profiled boosting round, for this checkout's
port or another checkout's, on the card.

    python lightgbm_tpu_torch/tools/round_profile.py [ROOT ...] [--rows N]

ROOT is the root of a checkout holding `lightgbm_tpu_torch` (a parent
commit unpacked with `git archive`, say); this checkout's by default.  For
each ROOT in turn, in a process of its own that imports that ROOT's
package: `chip_smoke.py`'s Higgs-shaped data (10.5M rows by default),
binned; then for the carried f32 and the quantized path, two rounds of
`train` with `chip_smoke.py`'s parameters and one more round under
torch.profiler (`chip_smoke.profile_round`): its wall time, device busy
time, idle share and the device ms and launches of each kernel of the
table (K1-K7), then one line of K1, K2, K5 and K6's.  The last line of
each ROOT is one JSON object.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
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


def one(root: str, rows: int, rounds: int) -> int:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch
    import lightgbm_tpu_torch as lt
    if not torch.cuda.is_available():
        print("round_profile: no CUDA device", file=sys.stderr)
        return 1
    cs = _chip_smoke()
    dev = torch.device("cuda", torch.cuda.current_device())
    print("%s: package %s" % (torch.cuda.get_device_name(0),
                              Path(lt.__file__).parent))
    t = time.perf_counter()
    X, y, _Xh, _yh = cs.higgs_like(rows)
    ds = lt.Dataset(X, y, params=cs.PARAMS, device=dev).construct()
    print("data: %d x %d binned in %.1f s" % (X.shape[0], X.shape[1],
                                              time.perf_counter() - t))
    out = {}
    for path in ("f32", "quantized"):
        booster = lt.train(cs.path_params(path), ds, num_boost_round=rounds,
                           device=dev)
        out[path] = prof = cs.profile_round(booster, path)
        by = prof.get("by_kernel") or {}
        print("%s round, device ms (launches): %s" % (path, ", ".join(
            "%s %.3f (%d)" % (k, by[k]["ms"], by[k]["launches"]) if k in by
            else "%s none" % k for k in ("K1", "K2", "K5", "K6"))))
        del booster
        torch.cuda.empty_cache()
    print(json.dumps({"root": root, "rows": rows, "profile": out}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*", default=[str(REPO)])
    ap.add_argument("--rows", type=int, default=10_500_000)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        return one(args.roots[0], args.rows, args.rounds)
    rc = 0
    for root in args.roots:
        sys.stdout.flush()
        rc |= subprocess.run([sys.executable, __file__, "--one", root,
                              "--rows", str(args.rows), "--rounds",
                              str(args.rounds)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
