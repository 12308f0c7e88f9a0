"""Where two first trees grown on the card from f32 histograms part, and
how close the split gains are there.

    python lightgbm_tpu_torch/tools/first_tree_ties.py [--rows 10500000]
        [--runs 2] [--device cuda]

On `chip_smoke.py`'s Higgs-shaped data (PARAMS: 255 leaves, binned once),
one-round runs on both engines (the partition engine with the holdout as
a validation set, as the smoke's valid_f32 run; the label engine): a
built-in binary run as the reference, then `--runs` more built-in runs
and `--runs` runs of the smoke's numpy logloss as a custom objective.
Each line prints, against the reference, `chip_smoke.first_divergence`
(the first split in growth order that differs, the two gains there and
their relative difference, and the largest relative difference of the
equal splits' gains before it) and `chip_smoke.partition_share` (the
share of the training rows in leaves both trees hold).  `chip_smoke`'s
TIE_RTOL is set from these readings.
"""
from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=10_500_000)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cpu runs the kernels' plain versions")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(REPO))
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("first_tree_ties: no CUDA device", file=sys.stderr)
        return 1
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.objective import create_objective
    cs = _chip_smoke()
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    dev = torch.device(args.device)
    X, y, Xh, yh = cs.higgs_like(args.rows)
    ds = lt.Dataset(X, y, params=cs.PARAMS, device=dev).construct()
    valid = lt.Dataset(Xh, yh, reference=ds, device=dev).construct()
    obj = create_objective("binary", Config(cs.PARAMS))
    obj.init(ds._binned.metadata, len(X), "cpu")
    init = np.full(len(X), obj.boost_from_score(0))

    def run(custom: bool, engine: str):
        params = dict(cs.path_params("label_f32" if engine == "label"
                                     else "valid_f32"))
        kw = ({} if engine == "label" else
              dict(valid_sets=[valid], valid_names=["holdout"]))
        if custom:
            params["objective"] = "none"
            ds.set_init_score(init)
            kw["fobj"] = cs.logloss_fobj
        try:
            booster = lt.train(params, ds, 1, verbose_eval=False,
                               device=dev, **kw)
        finally:
            ds.set_init_score(None)
        booster._gbdt._sync_model()
        return booster

    for engine in ("partition", "label"):
        ref = run(False, engine)
        for custom in [False] * args.runs + [True] * args.runs:
            t = time.perf_counter()
            other = run(custom, engine)
            a, b = ref._gbdt.models[0], other._gbdt.models[0]
            d = cs.first_divergence(a, b)
            print("%s, %s against built-in: first difference at split %s, "
                  "gains %s and %s (%.3g apart); equal splits' gains within "
                  "%.3g; %.6f of the rows in shared leaves (%.1f s)"
                  % (engine, "custom objective" if custom else "built-in",
                     d["at"], d["gain_a"], d["gain_b"], d["rdiff"],
                     d["prefix_rdiff"], cs.partition_share(ref, a, b, dev),
                     time.perf_counter() - t), flush=True)
            del other
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
