#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (lightgbm_tpu_torch) on one GPU.

    python3 chip_smoke.py [--rows N] [--rounds R] [--predict-rounds P]

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's CUDA kernels from csrc/ (one nvcc per source, in
   parallel) and prints the build time;
3. kernel phase: each kernel of the training paths runs on the card at
   the main paths' shapes against its plain PyTorch version on the same
   inputs, with the tolerance stated per kernel, and is timed with CUDA
   events beside the plain version and, where one PyTorch call computes the
   same function, that call; K1, K2, K4, K5 and K6 also kernel-only
   (torch.profiler, without the wrapper's host work).  f32 arenas: K1
   split_scan, K2 segment_histogram, K3 partition_segment (decision mode
   at the root and in place on a 40k-row child, and pred mode with the
   bag's fused histogram at the bagged root and in place on a 40k-row
   child), K4 scatter_segments in set mode and in add mode (the fused
   paths' score update) and K6 compact_carry (255 even leaves in a
   shuffled order, and a skewed tree: one leaf of half the rows, the rest
   down to 20 rows; K4 also on a real carried tree's leaves, and beside
   the chain its add mode replaces); quantized arenas (int8 codes made on
   the CPU): K2 in int8 mode, K5 fused_refresh_histogram, K3 in both modes
   moving the codes, K6 moving the codes, each held exactly equal to its
   plain version; K7 leaf_histogram over the dataset's row-major bins,
   f32, int8 and f64 (tpu_double_precision), at the root (every row in
   leaf 0) and on a leaf of about 40k rows scattered over the rows, with
   one row-list workspace as the grower holds it; K8 partition_ablate, K3's stage ablation, at the dataset's row
   count on an f32 and an int8 arena, its full stage held exactly equal to
   K3's plain version;
4. parity phase: a 20k-row, 3-round, 31-leaf run on the card against the
   same run on the CPU (plain versions), with f32 and with quantized
   gradients, unweighted (the carried arena), weighted (the pristine one),
   bagged (0.8 of the rows each round) and with a validation set (the
   eager path), and on the label engine, unbagged and bagged, and the
   boosting modes (GOSS at learning_rate 0.5, two rounds of every row and
   a sampled one; RF; DART dropping a tree in round 3): equal bags,
   samples and drops, split features and leaves of every row in the
   tree's bag or sample; and the general grower (CEGB, forced splits, a
   pooled quantized run, f64 on the label engine, the label engine on the
   airline layout with 300 airports: uint16 bins), both runs grown from
   the CPU's gradients rounded to 1/256: the same splits and every row in
   the same leaf;
5. training phase: a Higgs-shaped binary GBDT (28 dense features,
   num_leaves=255, max_bin=255, min_data_in_leaf=20, learning_rate=0.1,
   10.5M rows by default) trains through lightgbm_tpu_torch.train on the
   card ten times: f32 and then with tpu_quantized_grad=True each, on the
   carried arena; with row weights, which keep the tree rooted at the
   pristine block; bagged (bagging_fraction=0.8, bagging_freq=1), whose
   root is K3 in pred mode; and with the 100k-row holdout as a validation
   set (metric auc, early stopping after 2 rounds without gain), whose last
   evaluated AUC must equal the host prediction's; and f32 on the label
   engine (tpu_tree_engine=label, tpu_histogram_impl=pallas), unbagged and
   bagged, whose every tree must reach 255 leaves; each run predicts the
   holdout through KP1 (predict_ensemble), bit for bit the host walk's
   sums; the launch counters, zeroed just before each train call and
   read just after, show that every kernel of that path ran and that no
   kernel of another path did (KP2 walk_binned: its masked add on the
   bagged runs, its add mode on the valid-set runs, on no other; KP1 on
   none); trees must reach more than one leaf, the
   holdout AUC must reach 0.75, each quantized run's must be within 0.02
   of its f32 run's and each label run's within 0.02 of the valid-set f32
   run's, and each run's within 0.002 of the last accepted run of this
   script (AUC_BEFORE); every round after a run's first must be one CUDA
   graph replay (one graph a run, two on the carried arena, one for each
   root slot), and every run but the valid-set ones must fetch its trees
   only at drains, the valid-set runs one a round; each run prints its
   graphs' node counts and capture-and-instantiate seconds, its drains and
   fetches, and the ms a round of three more replayed rounds; then one
   more replayed round, its drain included, runs under torch.profiler for
   the device time by kernel and the idle share;
   after the bagged f32 run, KP2 on its last round's 255-leaf device tree
   and bag at the full row count: leaf mode, masked add and add against
   the plain versions, bit for bit, timed beside the bytes each mode
   must move (in masked add only the rows out of the bag read bins);
6. boosting-modes phase, on the training phase's Higgs data and holdout:
   GOSS f32 and quantized (13 rounds: 10 of every row at learning_rate
   0.1, then 3 sampled: the top 0.2 of |g*h| and 0.1 of the rest, the
   sample drawn on the card in the gradients' graph and grown as a bag:
   K3's pred mode, K4's set mode, KP2's masked add), GOSS with the
   holdout as a validation set and GOSS on the label engine, RF (5
   rounds over the smoke's bag, a fetch a round, the running average) and
   DART (12 rounds at its defaults, drops walked by KP2's add mode), each
   through train_and_check with its kernels launched and no other: the
   holdout AUC at least 0.75, KP1's sums bit for bit the host walk's,
   GOSS's sampled rounds holding top_k + other_k rows or more (exactly,
   past ties at the threshold counted apart, in one more round), the
   valid-set run's last evals_result equal to the host prediction's
   within 1e-6, RF's and DART's training scores equal to their models'
   prediction on 100k training rows within 1e-5; each run's replayed
   round and a profiled one;
6b. general-grower phase, on the same data and holdout (general_phase):
   CEGB on the carried arena and on the label engine (cegb_tradeoff 1, a
   split penalty of 1e-6 a row, a coupled penalty of 1e4 on the odd
   features: their share of the splits below the training phase's f32
   run's), forced splits on both engines (a three-node plan whose root
   is not the unforced run's root feature: every tree's first splits the
   plan's), the quantized carried run with a pool of 64 of the 255
   leaves' histograms (the training phase's quantized trees: the same
   splits, counts and leaves, leaf values within 1e-5; K2 launched once
   more each split), f64 on the label engine with the holdout as a
   validation set (AUC within 0.02 of the f32 label run's, the score
   f64, KP2's f64 add over its last tree at 10.5M rows bit for bit its
   plain version); each through train_and_check with its kernels
   launched and no other, KP1's holdout sums bit for bit the host walk's;
7. prediction phase: the f32 carried configuration trained for
   --predict-rounds rounds (50: the reference's Higgs experiment takes
   500, cut to keep the whole smoke within its time) at the
   full row count, each drain timed; KP1 on the model over the holdout
   and 1M training rows, as f32 rows (as the data comes) and as f64 rows,
   bit for bit its plain version on the card and (the holdout) the host
   walk, its rows shared among 8 processes (host_walks),
   timed by CUDA events, kernel-only (torch.profiler), from numpy and by
   the host walk, with the bound (X at its own width), the node visits
   (the depths of the leaves reached) and ns a visit, and predict's host
   steps alone (the conversion to f64, the copy into pinned staging, the
   copy over PCIe, the output's fetch); leaf indices and early stop (freq
   10, margins 4 and 10) equal to the host walk's; the serving buckets
   (1, 7, 1000, 4097 rows) equal to predict and timed, and KP1's
   small-batch walk at 1024 rows against its plain version; the
   ensemble's device bytes equal to the estimate; KP1's launches counted
   over the holdout's predict (row tiles) and the buckets' (small-batch
   walk);
7b. serving phase (serving_phase), after the prediction phase, on its
   model (50 rounds, 255 leaves, 28 features): the port's Server on the
   card, port 0, batches of up to 256 rows after at most 2 ms, the
   device-work floor at one row-tree so that every batch rides KP1 (the
   default, the JAX package's 2^22 row-trees, sends every batch of this
   model under 83,886 rows to the host walk); its warmup launches each of
   the 9 buckets once; 8 client threads x 50 requests of 1, 2, 7, 16, 64
   or 200 holdout rows, half over HTTP (ServingClient), half in process,
   and one request of 100,000 rows alone (KP1's row tiles): every answer
   bit for bit booster.predict(rows, device=False), raw scores through
   the entry too, one KP1 launch a device batch, no build, no host batch,
   no host fallback, no breaker failure, p50 and p99 by path and size on
   the host clock; KP1 from numpy, the kernel alone and the host walk at
   each bucket; v2 (the training phase's f32 model) hot-swapped in under
   4 clients (every answer wholly v1's or v2's), rolled back (v1's answers
   bit for bit); a shadow mirror of v2 (its divergence equal to the host
   walks', the answers unchanged); /healthz, /models, /metrics (request
   counters, device gauges); then a fleet of the training phase's f32,
   quantized and weighted models under a budget of two and a half
   tenants: the byte ledger equal to the tables' device_bytes(), the
   third load spilling the least recently used, which answers at once on
   the host walk and is promoted, the allocator's bytes back within its
   rounding after the release;
8. lambdarank phase (bench.py's second headline workload,
   MSLR-WEB30K-shaped: 18,900 queries of 120 documents, 2,268,000 rows x
   137 f32 features from bench.py's generator, seed 11; num_leaves=63,
   learning_rate=0.1, min_data_in_leaf=20, max_bin=255, metric=ndcg):
   K2 f32 at G = 137 (the root and a 40k-row child) and K1 at G = 137,
   B = 255 against their plain versions and timed beside their bounds;
   (a) 5 rounds through lightgbm_tpu_torch.train with no validation set,
   the fused pristine path: one graph, replayed every round after the
   first, trees fetched only at drains, K2, K3, K1 and K4's add mode
   launched and no other kernel; the card's lambdarank gradients of the
   trained score within 1e-5 of the CPU's (of their largest magnitude);
   training NDCG@10 of predict at least 0.70, printed beside the
   constant-score value, KP1's sums bit for bit the host walk's; (b) the
   same with 1,000 more queries (seed 12, graded by the training draw's
   utility weights) as a validation set, eval_at
   10 and early stopping after 2: its last evals_result ndcg within 1e-6
   of the host prediction's NDCG@10, KP2's add mode launched; each run
   prints its replayed round, graphs x nodes, peak memory and a profiled
   round (wall, busy, idle), (a) also the gradients' share of the busy
   time; the parity phase adds a 20k-row lambdarank run (167 queries),
   an L1 run (a leaf refit a round) and a Poisson run, each on the card
   against the CPU: equal split features and every row in the same leaf;
9. objectives phase: regression_l1, huber, poisson and xentropy on the
   Higgs data cut to 1M rows, 255 leaves, 5 rounds each: trees of more
   than one leaf, a graph replay every round after the first, the fused
   runs' fetches deferred and L1's one a round, the training metric of
   the first 1..5 trees falling, KP1's sums bit for bit the host walk's;
9b. api phase (api_phase), the public training and model API on the
   Higgs data and holdout: a numpy binary-logloss fobj (objective=none)
   f32 with an AUC feval on the holdout, quantized, and on the label
   engine, each first tree putting 99% of the training rows in its
   built-in run's leaves, AUC within 0.002 of it, the feval within 1e-6
   of the built-in
   auc; a learning-rate schedule deferred on the carried arena, quantized
   (no graph beyond the unscheduled run's, its first tree that run's bit
   for bit), and eager with the holdout, every tree shrunk by its round's
   rate, each model predicting its training score;
   continued training from a 5-round model on 1M rows against a 10-round
   run, and rollback_one_iter; refit on the holdout against the CPU's;
   save_model, model_file and model_from_string, importance against a
   recount from the text; cv (3 folds, 3 rounds) over the first 1M rows;
   LGBMClassifier on 1M rows against train, bit for bit;
10. multiclass phase (the UCI Covertype dataset's shape: 581,012 rows x 54
   dense f32 features from a generator with Covertype's 7 class counts,
   a 58,101-row holdout; PARAMS with objective=multiclass, num_class=7):
   a 20k-row, 3-round, 31-leaf softmax parity run (21 trees, both runs
   grown from the CPU's gradients rounded to 1/256, every row in the same
   leaf of each, raw predictions within 5e-6 of their scale, and the
   card's own softmax gradients of the CPU's score within 2e-6 of the
   CPU's);
   K2 f32 at G = 54 (root and a 40k-row child) against its plain version,
   timed beside its bound and index_add_; 3 rounds (21 trees; MC_ROUNDS)
   through
   lightgbm_tpu_torch.train: softmax f32 and quantized on the fused
   pristine path (one graph a class, one for the gradients of every class
   from the round's starting score), softmax with the holdout as a
   validation set (multi_logloss and multi_error, early stopping after 2;
   the eager path, KP2's add mode) and one-vs-all f32, each with its
   kernels launched and K6 and K7 not, every class growing a tree in
   round 1, the holdout's multi_logloss below the constant prior's (the
   quantized run's within 0.01 of the f32 run's; the valid-set run's last
   evals_result equal to the host prediction's within 1e-6), its replayed
   round, graphs x nodes, drains and fetches, peak memory and a profiled
   round; on the f32 run's model KP1's sums over the holdout (small-batch
   walk) and 100k training rows (row tiles), its leaves and its early
   stop (every 14 trees, at the holdout's median top-two gap after 2
   iterations; holdout, tiles and the serving buckets of 1, 7 and 1000
   rows) bit for bit the host walk's, KP1's k = 7 early stop by both walks
   bit for bit its plain version on the card, softmax rows summing to 1
   within 1e-12; then EFB at Covertype's own layout (10 numbers, 4
   wilderness-area and 40 soil-type one-hot columns, `covertype_onehot`,
   seed 51, holdout seed 52, enable_bundle at its default: 12 groups): a
   20k-row softmax parity run, K2 f32 at G = 12 against its plain version,
   and softmax f32 on the partition engine (fused pristine, K1 after
   unbundling) and on the label engine, each through train_and_check,
   holdout multi_logloss below the prior's 1.2052;
11. categorical phase (the airline data of szilard's benchm-ml and
   GBM-perf benchmarks at train-10m's width: 10,000,000 rows x 8 columns,
   Month, DayofMonth, DayOfWeek, UniqueCarrier, Origin and Dest
   categorical with 12, 31, 7, 22, 255 and 255 categories for the
   partition engine's runs (the airports cut from train-10m's ~300 to
   what uint8 bins hold), airports Zipf-skewed to ATL's share of
   departures, `airline_like` seed 31, a 100k-row holdout of seed 32;
   PARAMS, the categorical knobs at their defaults): a 20k-row weighted
   parity run (trees that take a bin set's complement must put the rows
   in the same leaves, relabelled); K2 f32 at G = 8; four runs through
   train_and_check, f32 and quantized on the carried arena, f32 with the
   holdout as a validation set (KP2's add mode over categorical nodes),
   and an f32 twin given the six columns as numbers, K1 launched by the
   twin only; every holdout AUC at least 0.75, the
   categorical f32 run's above the twin's, the quantized within 0.02 of
   f32, the valid-set run's last evals_result equal to the host
   prediction's within 1e-6, KP1's holdout sums bit for bit the host
   walk's; KP2 over the valid-set run's categorical tree at 10M rows
   against its plain version, bit for bit, timed beside its bound; one
   split's categorical scan captured for its node count; then the label
   engine on the same layout with train-10m's 300 airports each way
   (uint16 bins, 292-293 categorical bins in Origin and Dest): K7's
   uint16 form against its plain version at the root and on a 40k leaf,
   a run with the 300-airport holdout as a validation set (KP2's add
   over uint16 bins and bin sets wider than 256 bits, AUC at least 0.75,
   the last evals_result the host prediction's), and KP2 over its last
   tree at 10M rows against its plain version (wide_label_run);
12. prints one JSON line of training and prediction results and one of
   per-kernel results, then the device line {"ok": true, "device": {...}}
   as the last line.

Exits non-zero, without the device line, when there is no CUDA device, when
the package is missing, or when any phase fails.
"""
from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np

# where the smoke's own time goes: seconds by (phase, kind of step), each
# step's time less that of the timed steps it makes (`timed`), printed as
# `steps, s:` before the phases' line
STEP_S = {}
PHASE = ["set-up"]
_OPEN_STEPS = []


def timed(kind: str):
    """Decorator: the call's seconds, less those of the timed calls it
    makes, added to STEP_S[(the current phase, kind)]."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            t = time.perf_counter()
            _OPEN_STEPS.append(0.0)
            try:
                return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t
                key = (PHASE[0], kind)
                STEP_S[key] = STEP_S.get(key, 0.0) + dt - _OPEN_STEPS.pop()
                if _OPEN_STEPS:
                    _OPEN_STEPS[-1] += dt
        return inner
    return wrap


ROWS = 10_500_000
FEATURES = 28
CHILD_ROWS = 40_000
LEAVES = 255
PARAMS = {"objective": "binary", "num_leaves": 255, "learning_rate": 0.1,
          "max_bin": 255, "min_data_in_leaf": 20, "verbose": -1}
QPARAMS = dict(PARAMS, tpu_quantized_grad=True)
AUC_FLOOR = 0.75
AUC_GAP = 0.02
# each run's holdout AUC in an earlier accepted run of this script (NVIDIA
# H100 80GB HBM3, 700 W; PERF.md section 5 keeps the runs): a kernel
# rewrite that keeps the partitions and histograms moves none by more
# than AUC_DRIFT
AUC_BEFORE = {"f32": 0.8534, "quantized": 0.8533, "weighted_f32": 0.8559,
              "weighted_quantized": 0.8563, "bagged_f32": 0.8558,
              "bagged_quantized": 0.8556, "valid_f32": 0.8559,
              "valid_quantized": 0.8558, "label_f32": 0.8559,
              "label_bagged_f32": 0.8557}
AUC_DRIFT = 0.002
# H100 SXM peaks (NVIDIA data sheet): HBM rate and f32 rate outside the
# tensor cores (the integer adds of the histogram kernels are counted at the
# same rate); bounds below are stated against these, beside the card's power
# limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the __global__ functions of lightgbm_tpu_torch/csrc/*.cu by the kernel
# table's label, as the profiler names them; with the first versions' names
# (K1's second select kernel; K2 and K5 sharing histogram_kernel; K6's two
# launches), so that an older checkout's rounds read alike
KERNEL_NAMES = (
    ("K1", ("split_scan_kernel", "select_best_kernel")),
    ("K2", ("seg_hist_kernel", "SegmentRows<float, false>",
            "SegmentRows<signed char, false>")),
    ("K5", ("fused_root_kernel", "SegmentRows<signed char>",
            "SegmentRows<signed char, true>")),
    ("K3", ("partition_kernel",)),
    ("K4", ("scatter_segments_kernel",)),
    ("K6", ("compact_carry_kernel", "carry_offsets_kernel",
            "carry_copy_kernel")),
    ("K7", ("leaf_select_kernel", "leaf_accumulate_kernel")),
    ("KP1", ("predict_ensemble_kernel", "predict_small_kernel",
             "predict_small_sum_kernel")),
    ("KP2", ("walk_binned_kernel",)))


def kernel_label(name: str):
    """The kernel table's label of a device kernel name, or None."""
    for label, parts in KERNEL_NAMES:
        if any(p in name for p in parts):
            return label
    return None
# the training paths.  Carried: no weights, no bag, no validation set (the
# JAX rule); weights keep the tree rooted at the pristine block; a bag or a
# validation set runs the eager path (pristine root, per-row leaf ids), the
# bag's root by K3 in pred mode with its fused histogram; the label engine
# grows every tree over the bag mask with K7 and K1 alone
PATHS = {
    "f32": dict(), "quantized": dict(quantized=True),
    "weighted_f32": dict(weighted=True),
    "weighted_quantized": dict(quantized=True, weighted=True),
    "bagged_f32": dict(bagged=True),
    "bagged_quantized": dict(quantized=True, bagged=True),
    "valid_f32": dict(valid=True),
    "valid_quantized": dict(quantized=True, valid=True),
    "label_f32": dict(label=True),
    "label_bagged_f32": dict(label=True, bagged=True),
}
PARITY_PATHS = ("f32", "quantized", "weighted_f32", "weighted_quantized",
                "bagged_f32", "bagged_quantized", "valid_f32", "label_f32",
                "label_bagged_f32")
# objectives of the parity runs on the f32 path's settings: lambdarank, a
# leaf refit a round (L1), a log link (Poisson)
PARITY_OBJECTIVES = ("lambdarank", "regression_l1", "poisson")
# the boosting modes' parity runs: the settings over their path's, the
# path, and the driver class each trains.  GOSS at learning_rate 0.5: two
# rounds of every row, then a sampled one; DART dropping a tree in round 3
BOOSTING_PARITY = {"goss": dict(boosting="goss", learning_rate=0.5),
                   "rf": dict(boosting="rf"),
                   "dart": dict(boosting="dart", drop_rate=0.5,
                                skip_drop=0.0)}
BOOSTING_PARITY_PATHS = {"goss": "f32", "rf": "bagged_f32", "dart": "f32"}
BOOSTING_CLASS = {"goss": "GOSS", "rf": "RF", "dart": "DART"}
# the kernels of the partition engine (K2-K6), none of which the label
# engine may launch
PARTITION_KERNELS = ("segment_histogram", "segment_histogram_i8",
                     "partition_segment", "partition_segment_i8",
                     "partition_segment_pred", "partition_segment_pred_i8",
                     "scatter_segments", "scatter_segments_add",
                     "fused_root_histogram",
                     "compact_carry", "compact_carry_i8")
# KP1's counters: its row tiles and its small-batch walk
PREDICT_KERNELS = ("predict_ensemble", "predict_ensemble_small")
# KP2's counters by mode (ops/predict_kernel.walk_binned): its masked add
# is the bagged rounds' score update, its add mode the valid-set rounds'
# validation score; its leaf mode has no training path
WALK_MASKED, WALK_ADD = "walk_binned_masked_add", "walk_binned_add"
WALKS = ("walk_binned", WALK_MASKED, WALK_ADD)
# kernels of the line with no training path, and why
NO_PATH = {
    "leaf_histogram_i8": "the JAX package has no training path for "
                         "leaf_histogram_quantized: its label engine clears "
                         "tpu_quantized_grad (lightgbm_tpu/models/gbdt.py:"
                         "1340-1345)",
    "partition_ablate": "K8 is a measurement tool (tools/kernel_ablate.py), "
                        "on no training path",
}
# the repo's own bagging setting (tests/test_quantized.py:289)
BAGGING = {"bagging_fraction": 0.8, "bagging_freq": 1}
EARLY_STOPPING_ROUNDS = 2


def flag(path: str, name: str) -> bool:
    return bool(PATHS[path].get(name, False))


def carried(path: str) -> bool:
    return not any(flag(path, k)
                   for k in ("weighted", "bagged", "valid", "label"))


def path_params(path: str, **extra) -> dict:
    params = dict(QPARAMS if flag(path, "quantized") else PARAMS, **extra)
    if flag(path, "bagged"):
        params.update(BAGGING)
    if flag(path, "valid"):
        params["metric"] = "auc"
    if flag(path, "label"):
        params.update(tpu_tree_engine="label", tpu_histogram_impl="pallas")
    return params


def path_kernels(path: str) -> tuple:
    """(kernels the path must launch, kernels it must not): the launch
    counter names.  KP1 (prediction) runs in no training path; KP2 runs in
    the bagged ones (masked add, the score update of a round's out-of-bag
    rows) and the valid-set ones (add, the validation score), never in the
    fused ones."""
    walks = [w for w in WALKS
             if not (w == WALK_MASKED and flag(path, "bagged"))
             and not (w == WALK_ADD and flag(path, "valid"))]
    walk_must = tuple(w for w in WALKS if w not in walks)
    if flag(path, "label"):
        return (("leaf_histogram", "split_scan") + walk_must,
                PARTITION_KERNELS + PREDICT_KERNELS + tuple(walks))
    q = flag(path, "quantized")
    sfx = "_i8" if q else ""
    # K4: set mode on the bagged paths (leaf ids for the walk), add mode
    # elsewhere (the score update: in the fused paths' grower, after the
    # fetch on the valid-set path)
    set_mode = flag(path, "bagged")
    k4 = ("scatter_segments", "scatter_segments_add")
    must = ["split_scan", "segment_histogram" + sfx, "partition_segment" + sfx,
            k4[not set_mode]]
    never = [k4[set_mode]]
    if flag(path, "bagged"):
        must.append("partition_segment_pred" + sfx)
        never += ["fused_root_histogram", "compact_carry" + sfx]
    else:
        if q:
            must.append("fused_root_histogram")
        (must if carried(path) else never).append("compact_carry" + sfx)
        never.append("partition_segment_pred" + sfx)
    return (tuple(must) + walk_must,
            tuple(never) + PREDICT_KERNELS + tuple(walks))


SRC = "lightgbm_tpu_torch/csrc/%s.cu"
REPLACES = {
    "split_scan": "lightgbm_tpu/ops/split_pallas.py:242",
    "segment_histogram": "lightgbm_tpu/ops/partition_pallas.py:1019",
    "partition_segment": "lightgbm_tpu/ops/partition_pallas.py:528",
    "scatter_segments": "lightgbm_tpu/ops/partition_pallas.py:820",
    "fused_root_histogram": "lightgbm_tpu/ops/partition_pallas.py:1168",
    "compact_carry": "lightgbm_tpu/ops/partition_pallas.py:691",
    "leaf_histogram": "lightgbm_tpu/ops/histogram_pallas.py:156",
    "leaf_histogram_i8": "lightgbm_tpu/ops/histogram_pallas.py:211",
    "partition_ablate": "tools/kernel_ablate.py:199",
    # port-only kernels: the JAX functions they replace reach no
    # pl.pallas_call
    "predict_ensemble": "lightgbm_tpu/ops/predict.py:323",
    "walk_binned": "lightgbm_tpu/ops/grow.py:856",
}


def row_weights(n: int, seed: int = 3) -> np.ndarray:
    """Positive row weights in [0.5, 1.5)."""
    return np.random.RandomState(seed).rand(n).astype(np.float32) + 0.5


@timed("data")
def higgs_like(n: int, seed: int = 7):
    """bench.py's Higgs-shaped generator: X [n, 28] f32, labels from a
    random linear score plus one interaction; a held-out draw of the same
    distribution."""
    rng = np.random.RandomState(seed)
    n_hold = min(100_000, n // 4)
    X = rng.randn(n, FEATURES).astype(np.float32)
    w = rng.randn(FEATURES)

    def label_of(Xg):
        logits = Xg @ w * 0.5 + 0.8 * np.sin(Xg[:, 0] * 2) * Xg[:, 1]
        return (logits + rng.randn(len(Xg)) > 0).astype(np.float32)

    y = label_of(X)
    Xh = rng.randn(n_hold, FEATURES).astype(np.float32)
    yh = label_of(Xh)
    return X, y, Xh, yh


@timed("kernel timing")
def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms of fn() over a run of reps back-to-back calls between two
    CUDA events, after warm-up calls."""
    import torch
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


def cuda_call_ms(fn):
    """(fn(), its one call's ms between two CUDA events): a slow plain
    version timed on the very call that checks the kernel against it."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


# spin kernels launched ahead of a traced run (torch.cuda._sleep): the
# profiler's trace drops the first device events of a session, the more
# the older the process (on an H100 with torch 2.11, about one for every
# 12-13 s of its age, whatever pause comes first; tools/trace_drops.py),
# so these absorb the loss
TRACE_PAD = 1024
PAD_KERNEL = "spin_kernel"


class DeviceEvent(NamedTuple):
    """A device operation of a trace (kernel, copy or memset): its name
    and its ms."""
    name: str
    ms: float


def traced(work, activities, record_shapes: bool = False):
    """(profile, work's device events, spin kernels held): work() under
    torch.profiler after TRACE_PAD spin kernels, the card synchronized at
    its end; the events leave the spin kernels out.  A trace whose drops
    reached past the spin kernels into work's events is told by a count
    its caller knows (kernel_only_ms, profile_round).  The device events
    come from the profiler's raw results: `prof.events()` builds a tree of
    every event on the host, which took most of the multiclass phase's
    time (a 7-class round is 250k device operations)."""
    import torch
    from torch.profiler import profile
    with profile(activities=activities, record_shapes=record_shapes) as prof:
        for _ in range(TRACE_PAD):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        work()
        torch.cuda.synchronize()
    device = [DeviceEvent(ev.name(), ev.duration_ns() / 1e6)
              for ev in prof.profiler.kineto_results.events()
              if ev.device_type() == torch.autograd.DeviceType.CUDA]
    return (prof, [ev for ev in device if PAD_KERNEL not in ev.name],
            sum(PAD_KERNEL in ev.name for ev in device))


@timed("kernel timing")
def kernel_only_ms(fn, reps: int, any_kernel: bool = False):
    """Device ms a call of fn spends in the port's kernels (torch.profiler
    over reps calls after a warm-up, `traced`): the time without the
    wrapper's host work and without the memsets of its allocations; with
    any_kernel, in every device operation (the busy time of plain PyTorch
    work).  None where the trace holds fewer such events than the calls
    launched: one a call of a port kernel, and with any_kernel the device
    operations of a capture of one call (a trace cut short read 1/20 of a
    K2 root's time, below its bound); what it held is printed: a time the
    profiler did not record is never a number."""
    import torch
    from torch.profiler import ProfilerActivity
    per_call = launches_per_call(fn) if any_kernel else 1
    fn()
    torch.cuda.synchronize()

    def work():
        for _ in range(reps):
            fn()
    _, device, pad_held = traced(work, [ProfilerActivity.CUDA])
    ours = [ev for ev in device
            if any_kernel or kernel_label(ev.name) is not None]
    if len(ours) < reps * per_call:
        names = sorted({ev.name[:60] for ev in device})
        print("kernel-only: the profiler's trace of %d calls of %d device "
              "operations held %d device events, %d of those timed, and %d "
              "of %d spin kernels%s" % (
                  reps, per_call, len(device), len(ours), pad_held,
                  TRACE_PAD, (": " + "; ".join(names[:4])) if names else ""))
        return None
    return sum(ev.ms for ev in ours) / reps


def launches_per_call(fn) -> int:
    """Device operations one call of fn launches: the nodes of a capture
    of one call into a CUDA graph (after a call on the capture's side
    stream, as torch.cuda.graph asks), each a kernel, copy or memset."""
    import torch
    from lightgbm_tpu_torch.ops.graphs import graph_nodes
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    n = graph_nodes(graph)
    del graph
    torch.cuda.synchronize()
    return n


def bound(nbytes: float, ops: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ensemble_bytes(n: int, F: int, itemsize: int, table_bytes: int) -> int:
    """Bytes KP1 must move for a sum over n rows of F features: X read
    once at its own width (every feature of the prediction run's model is
    split on), the f64 sums written once, the walk tables read once."""
    return itemsize * n * F + 8 * n + table_bytes


def walk_binned_bytes(walked, G: int, nodes: int, leaves: int,
                      mode: str) -> int:
    """Bytes KP2 must move over the n rows of walked (bool [n], the rows
    that walk the tree: all of them in leaf and add mode, the rows out of
    the bag in masked add): the 32-byte sectors that hold a walking row's
    G bins (a row in the bag reads none), the tree's tables and leaf
    values once, and per row the leaf written (leaf), or the score read
    and written (add; masked add also reads every row's id)."""
    import torch
    n = walked.shape[0]
    rows = walked.nonzero()[:, 0].long() * G
    sectors = torch.zeros(-(-n * G // 32), dtype=torch.bool,
                          device=walked.device)
    for off in list(range(0, G, 32)) + [G - 1]:
        sectors[(rows + off) // 32] = True
    per_row = {"leaf": 4, "add": 8, "masked_add": 12}[mode]
    return 32 * int(sectors.sum()) + n * per_row + nodes * 21 + leaves * 4


class Failure(Exception):
    pass


def expect(cond: bool, msg: str) -> None:
    if not cond:
        raise Failure(msg)


def index_add_ms(a, s: int, c: int, B: int) -> float:
    """One index_add_ of every (feature, row) of the arena's rows [s, s+c)
    into the [G*B, 3] histogram: the library yardstick of K2 and K5."""
    import torch
    G = a.num_groups
    flat = (torch.arange(G, device=a.device)[:, None] * B
            + a.bins[:, s:s + c].long()).reshape(-1)
    p = a.payload[:, s:s + c]
    vdt = torch.int32 if a.quantized else torch.float32
    vals = torch.stack([p[0].expand(G, c).reshape(-1).to(vdt),
                        p[1].expand(G, c).reshape(-1).to(vdt),
                        torch.ones(G * c, device=a.device, dtype=vdt)], dim=1)
    hist0 = torch.zeros((G * B, 3), device=a.device, dtype=vdt)
    ms = cuda_ms(lambda: hist0.index_add_(0, flat, vals), 5)
    del flat, vals
    return ms


def kernel_phase(ds, dev, results, quantized: bool):
    """The kernels of one training path against their plain versions at the
    main path's shapes: K1, K2, K3, K4 and K6 on f32 arenas; K2, K5, K3 and
    K6 on quantized arenas."""
    import torch
    from lightgbm_tpu_torch.ops import partition_kernel as pk
    from lightgbm_tpu_torch.ops import split_kernel as sk
    from lightgbm_tpu_torch.ops.split import SplitParams

    n, G = ds.num_data, ds.num_features
    B = int(ds.feature_num_bins().max())
    sfx = "_i8" if quantized else ""
    mode = "int8" if quantized else "f32"
    gen = torch.Generator(device=dev).manual_seed(7)
    bins_t = ds.device_bins(dev).t()
    arenas = []
    for _ in range(2):          # kernel arena, plain arena
        a = pk.Arena(n, G, 6, dev, quantized=quantized)
        pk.init_pristine(a, bins_t)
        arenas.append(a)
    if quantized:
        # the same codes for every version, made on the CPU
        rng = np.random.RandomState(11)
        codes = torch.from_numpy(np.stack([
            rng.randint(-127, 128, n), rng.randint(0, 128, n)]
        ).astype(np.int8)).to(dev)
        for a in arenas:
            a.payload[:, :n] = codes
    else:
        g = torch.randn(n, generator=gen, device=dev)
        h = torch.rand(n, generator=gen, device=dev) * 0.25 + 0.01
        for a in arenas:
            a.payload[0, :n] = g
            a.payload[1, :n] = h
    ak, ap = arenas
    work0 = pk.pristine_work0(n)
    n_al = -(-n // pk.TILE) * pk.TILE
    cursor = work0 + n_al

    def entry(name, kernel, r, err, tol, **extra):
        b_ms, b_by = bound(r["bytes"], r.get("ops", 0))
        results[name] = dict(
            name=name, route="cuda", source=SRC % kernel,
            replaces=REPLACES[kernel], mode=mode, launches=0,
            max_abs_err=err, tolerance=tol, ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=b_ms, bound_by=b_by, library_ms=r.get("library_ms"),
            rows=r.get("rows"), **extra)
        if "kernel_ms" in r:
            results[name]["kernel_ms"] = r["kernel_ms"]

    def child(r):
        return dict({k: r[k] for k in ("ms", "plain_ms", "library_ms",
                                       "rows", "kernel_ms") if k in r},
                    bound_ms=bound(r["bytes"], r.get("ops", 0))[0])

    # ---- K5 (quantized root) --------------------------------------------
    if quantized:
        seg = torch.tensor([0, n], dtype=torch.int32, device=dev)
        fresh = torch.flip(codes, dims=[1]).contiguous()
        got = pk.fused_refresh_histogram(ak, fresh, seg, B)
        want = pk.fused_refresh_histogram_plain(ap, fresh, seg, B)
        expect(torch.equal(got, want), "K5: histograms differ")
        expect(torch.equal(ak.payload, ap.payload), "K5: code planes differ")
        expect(torch.equal(ak.payload[:, :n], fresh), "K5: codes not written")
        expect(torch.equal(ak.bins, ap.bins) and torch.equal(ak.rid, ap.rid),
               "K5: bins or row ids changed")
        k5 = dict(
            ms=cuda_ms(lambda: pk.fused_refresh_histogram(ak, fresh, seg, B),
                       20),
            kernel_ms=kernel_only_ms(
                lambda: pk.fused_refresh_histogram(ak, fresh, seg, B), 20),
            plain_ms=cuda_ms(lambda: pk.fused_refresh_histogram_plain(
                ap, fresh, seg, B), 3),
            library_ms=index_add_ms(ak, 0, n, B),
            bytes=pk.fused_refresh_bytes(n, G, B), ops=3 * G * n, rows=n)
        print("K5 fused_refresh_histogram: root %d rows %.4f ms, kernel-only "
              "%s (plain %.4f, index_add_ %.4f); exact"
              % (n, k5["ms"], profiled(k5["kernel_ms"]), k5["plain_ms"],
                 k5["library_ms"]))
        entry("fused_root_histogram", "fused_root_histogram", k5, 0.0,
              "exact")

    # ---- K2 -----------------------------------------------------------
    child_start = 123_456 % max(n - CHILD_ROWS, 1)
    segs = {"root": (0, n), "child": (child_start, min(CHILD_ROWS, n))}
    k2 = {}
    for name, (s, c) in segs.items():
        seg = torch.tensor([s, c], dtype=torch.int32, device=dev)
        got = pk.segment_histogram(ak, seg, B)
        want = pk.segment_histogram_plain(ak, seg, B)
        if quantized:
            expect(torch.equal(got, want), "K2 int8 %s: histograms differ"
                   % name)
            err, rel = 0.0, 0.0
        else:
            # scale for the f32 reassociation tolerance: sums of |g|, h, 1
            absg = ak.payload[:, s:s + c].clone()
            ak.payload[0, s:s + c] = absg[0].abs()
            scale = pk.segment_histogram_plain(ak, seg, B)
            ak.payload[:, s:s + c] = absg
            err_t = (got - want).abs()
            err = float(err_t.max())
            rel = float((err_t / scale.clamp_min(1e-30)).max())
            expect(torch.equal(got[..., 2], want[..., 2]),
                   "K2 %s: counts differ" % name)
            expect(rel <= 1e-5, "K2 %s: error %.3g of the |value| sums "
                   "exceeds rtol 1e-5" % (name, rel))
        k2[name] = dict(
            max_abs_err=err, rel_err=rel,
            ms=cuda_ms(lambda: pk.segment_histogram(ak, seg, B), 20),
            kernel_ms=kernel_only_ms(lambda: pk.segment_histogram(ak, seg, B),
                                     20),
            plain_ms=cuda_ms(lambda: pk.segment_histogram_plain(ak, seg, B),
                             5),
            library_ms=index_add_ms(ak, s, c, B),
            bytes=pk.segment_histogram_bytes(c, G, B, quantized),
            ops=3 * G * c, rows=c, hist=got)
    print("K2 segment_histogram (%s): root %d rows %.4f ms, kernel-only "
          "%s (plain %.4f, index_add_ %.4f); child %d rows %.4f ms, "
          "kernel-only %s; rel err %.3g"
          % (mode, n, k2["root"]["ms"], profiled(k2["root"]["kernel_ms"]),
             k2["root"]["plain_ms"], k2["root"]["library_ms"],
             segs["child"][1], k2["child"]["ms"],
             profiled(k2["child"]["kernel_ms"]),
             max(k2["root"]["rel_err"], k2["child"]["rel_err"])))
    entry("segment_histogram" + sfx, "segment_histogram", k2["root"],
          max(k2["root"]["max_abs_err"], k2["child"]["max_abs_err"]),
          "exact" if quantized else
          "counts equal; g/h within 1e-5 of the bin's |value| sum",
          child=child(k2["child"]))

    # ---- K1 (scans the f32 histograms) ----------------------------------
    if not quantized:
        hist2 = torch.stack([k2["root"]["hist"], k2["child"]["hist"]])
        params = SplitParams(min_data_in_leaf=20)
        nb = torch.as_tensor(ds.feature_num_bins(), device=dev)
        db = torch.as_tensor(np.array([m.default_bin for m in ds.bin_mappers],
                                      np.int32), device=dev)
        mt = torch.as_tensor(np.array([m.missing_type
                                       for m in ds.bin_mappers], np.int32),
                             device=dev)
        fvec = sk.build_feature_statics(nb, db, mt, children=2)
        svec = sk.child_vector(hist2[:, 0, :, 0].sum(1),
                               hist2[:, 0, :, 1].sum(1),
                               hist2[:, 0, :, 2].sum(1))
        pvec = sk.params_vector(params, dev)
        rows_k, best_k = sk.split_scan(hist2, fvec, svec, pvec)
        rows_p, best_p = sk.split_scan_plain(hist2, fvec, svec, pvec)
        lanes = [sk._OF, sk._OT, sk._ODL]
        expect(torch.equal(rows_k[:, lanes], rows_p[:, lanes]),
               "K1: feature, threshold or default_left differ")
        expect(torch.equal(best_k[:, lanes], best_p[:, lanes]),
               "K1: selected feature or threshold differ")
        valid = rows_p[:, sk._OG] > sk.NEG_GATE
        k1_err = (float((rows_k - rows_p)[valid].abs().max())
                  if valid.any() else 0.0)
        gain_rel = (float(((rows_k[:, sk._OG] - rows_p[:, sk._OG]).abs()
                           / rows_p[:, sk._OG].abs())[valid].max())
                    if valid.any() else 0.0)
        expect(gain_rel <= 1e-5, "K1: gain rel err %.3g exceeds 1e-5"
               % gain_rel)
        k1_bytes, k1_ops = sk.scan_bytes_and_ops(2, G, B)
        k1 = dict(ms=cuda_ms(lambda: sk.split_scan(hist2, fvec, svec, pvec),
                             50),
                  kernel_ms=kernel_only_ms(
                      lambda: sk.split_scan(hist2, fvec, svec, pvec), 50),
                  plain_ms=cuda_ms(lambda: sk.split_scan_plain(
                      hist2, fvec, svec, pvec), 5),
                  bytes=k1_bytes, ops=k1_ops, library_ms=None)
        print("K1 split_scan: CH=2 F=%d B=%d %.4f ms, kernel-only %s "
              "(plain %.4f); gain rel err %.3g, %d valid features"
              % (G, B, k1["ms"], profiled(k1["kernel_ms"]), k1["plain_ms"],
                 gain_rel,
                 int(valid.sum())))
        entry("split_scan", "split_scan", k1, k1_err,
              "feature, threshold, default_left equal; gain rtol 1e-5",
              shape="CH=2 F=%d B=%d" % (G, B))
    del k2

    # ---- K3 in pred mode with the fused histogram (the bagged root) -------
    # an 0.8 bag from a fixed seed; in-bag rows to work0, the others past
    # them, the bag's histogram in the same pass (hist_stream=0)
    bag = torch.from_numpy(
        (np.random.RandomState(13).rand(n) < 0.8).astype(np.uint8)).to(dev)
    oob = work0 + n_al
    sc_k = torch.tensor([0, n, work0, oob, 0, 0, 0, 0], dtype=torch.int32,
                        device=dev)
    sc_p = sc_k.clone()
    got = pk.partition_segment_pred(ak, sc_k, bag, hist_stream=0, max_bin=B)
    want = pk.partition_segment_pred_plain(ap, sc_p, bag, 0, B)
    expect(torch.equal(sc_k, sc_p), "K3 pred: counts differ")
    n_in = int(sc_k[pk.SC_CNT_A])
    expect(n_in == int(bag.sum()), "K3 pred: %d rows in the bag, %d counted"
           % (int(bag.sum()), n_in))
    for s, c in ((work0, n_in), (oob, n - n_in)):
        for pk_, pp_ in ((ak.bins, ap.bins), (ak.payload, ap.payload),
                         (ak.rid[None], ap.rid[None])):
            expect(torch.equal(pk_[:, s:s + c], pp_[:, s:s + c]),
                   "K3 pred: planes differ")
    if quantized:
        expect(torch.equal(got, want), "K3 pred: int8 histograms differ")
        err = 0.0
    else:
        expect(torch.equal(got[..., 2], want[..., 2]),
               "K3 pred: histogram counts differ")
        rows = ap.payload[:, work0:work0 + n_in].clone()
        ap.payload[0, work0:work0 + n_in] = rows[0].abs()
        scale = pk.segment_histogram_plain(
            ap, torch.tensor([work0, n_in], dtype=torch.int32, device=dev), B)
        ap.payload[:, work0:work0 + n_in] = rows
        err_t = (got - want).abs()
        err = float(err_t.max())
        rel = float((err_t / scale.clamp_min(1e-30)).max())
        expect(rel <= 1e-5, "K3 pred: histogram error %.3g of the |value| "
               "sums exceeds rtol 1e-5" % rel)
    # library yardsticks, one call each: the stable sort of the predicate
    # (as K3's row has) and index_add_ of the bag's histogram
    bag_key = 1 - bag
    sort_ms = cuda_ms(lambda: torch.sort(bag_key, stable=True), 5)
    k3p = dict(
        ms=cuda_ms(lambda: pk.partition_segment_pred(ak, sc_k, bag, 0, B),
                   10),
        plain_ms=cuda_ms(lambda: pk.partition_segment_pred_plain(
            ap, sc_p, bag, 0, B), 3),
        library_ms=sort_ms, index_add_ms=index_add_ms(ak, work0, n_in, B),
        bytes=pk.partition_pred_bytes(n, G, B, quantized),
        ops=3 * G * n_in, rows=n)
    print("K3 partition_segment_pred (%s payload, hist_stream=0): root %d "
          "rows, %d in the bag, %.4f ms (plain %.4f, stable sort %.4f, "
          "index_add_ %.4f); planes and counts exact, histogram %s"
          % (mode, n, n_in, k3p["ms"], k3p["plain_ms"], sort_ms,
             k3p["index_add_ms"], "exact" if quantized
             else "max abs err %.3g" % err))
    # the same pass in place on a ~40k-row child of the bag (its first
    # columns at work0): stream A over the segment itself, by a predicate
    # over those columns
    c_rows = min(CHILD_ROWS, n_in)
    dst_c = oob + n_al
    bag_c = torch.zeros(work0 + c_rows, dtype=torch.uint8, device=dev)
    bag_c[work0:] = torch.from_numpy((np.random.RandomState(14).rand(c_rows)
                                      < 0.8).astype(np.uint8)).to(dev)
    sc_k = torch.tensor([work0, c_rows, work0, dst_c, 0, 0, 0, 0],
                        dtype=torch.int32, device=dev)
    sc_p = sc_k.clone()
    got = pk.partition_segment_pred(ak, sc_k, bag_c, hist_stream=0, max_bin=B)
    want = pk.partition_segment_pred_plain(ap, sc_p, bag_c, 0, B)
    expect(torch.equal(sc_k, sc_p), "K3 pred child: counts differ")
    c_in = int(sc_k[pk.SC_CNT_A])
    for s, c in ((work0, c_in), (dst_c, c_rows - c_in)):
        for pk_, pp_ in ((ak.bins, ap.bins), (ak.payload, ap.payload),
                         (ak.rid[None], ap.rid[None])):
            expect(torch.equal(pk_[:, s:s + c], pp_[:, s:s + c]),
                   "K3 pred child: planes differ")
    if quantized:
        expect(torch.equal(got, want), "K3 pred child: int8 histograms "
               "differ")
    else:
        expect(torch.equal(got[..., 2], want[..., 2]),
               "K3 pred child: histogram counts differ")
        rows = ap.payload[:, work0:work0 + c_in].clone()
        ap.payload[0, work0:work0 + c_in] = rows[0].abs()
        scale = pk.segment_histogram_plain(
            ap, torch.tensor([work0, c_in], dtype=torch.int32, device=dev), B)
        ap.payload[:, work0:work0 + c_in] = rows
        err_c = float((got - want).abs().max())
        rel = float(((got - want).abs() / scale.clamp_min(1e-30)).max())
        expect(rel <= 1e-5, "K3 pred child: histogram error %.3g of the "
               "|value| sums exceeds rtol 1e-5" % rel)
        err = max(err, err_c)
    # the child's pass keeps its segment in place, so it repeats on the
    # same rows
    bag_key_c = 1 - bag_c[work0:]
    k3pc = dict(
        ms=cuda_ms(lambda: pk.partition_segment_pred(ak, sc_k, bag_c, 0, B),
                   20),
        plain_ms=cuda_ms(lambda: pk.partition_segment_pred_plain(
            ap, sc_p, bag_c, 0, B), 5),
        library_ms=cuda_ms(lambda: torch.sort(bag_key_c, stable=True), 5),
        bytes=pk.partition_pred_bytes(c_rows, G, B, quantized),
        ops=3 * G * c_in, rows=c_rows)
    print("K3 partition_segment_pred (%s payload, hist_stream=0), in place "
          "on a child of %d rows: %.4f ms (plain %.4f, stable sort %.4f)"
          % (mode, c_rows, k3pc["ms"], k3pc["plain_ms"], k3pc["library_ms"]))
    entry("partition_segment_pred" + sfx, "partition_segment", k3p, err,
          "planes and counts exact; histogram " + (
              "exact" if quantized else
              "counts equal, g/h within 1e-5 of the bin's |value| sum"),
          library="torch.sort(stable) of the predicate; index_add_ of the "
                  "histogram timed apart (library_index_add_ms)",
          library_index_add_ms=k3p["index_add_ms"], in_bag=n_in,
          child=child(k3pc))
    del bag, bag_c, bag_key, bag_key_c, got, want

    # ---- K3 -----------------------------------------------------------
    chan = 0
    goleft = (torch.arange(256, device=dev) <= 127).to(torch.uint8)

    def make_sc(s, c, da, db_, xr):
        return torch.tensor([s, c, da, db_, 0, 0, chan, xr],
                            dtype=torch.int32, device=dev)

    def compare_regions(regions, what):
        for s, c in regions:
            for pk_, pp_ in ((ak.bins, ap.bins), (ak.payload, ap.payload)):
                expect(torch.equal(pk_[:, s:s + c], pp_[:, s:s + c]),
                       "K3 %s: planes differ" % what)
            expect(torch.equal(ak.rid[s:s + c], ap.rid[s:s + c]),
                   "K3 %s: row ids differ" % what)

    k3 = {}
    sc_k = make_sc(0, n, work0, cursor, 1)
    sc_p = sc_k.clone()
    pk.partition_segment(ak, sc_k, goleft)
    pk.partition_segment_plain(ap, sc_p, goleft)
    expect(torch.equal(sc_k, sc_p), "K3 root: counts differ")
    n_b, n_a = int(sc_k[pk.SC_CNT_B]), int(sc_k[pk.SC_CNT_A])
    root_regions = [(work0, n_a), (cursor, n_b)]
    compare_regions(root_regions, "root")
    lib_key = (goleft[ak.bins[chan, :n].long()] != 0).to(torch.uint8)
    k3["root"] = dict(
        ms=cuda_ms(lambda: pk.partition_segment(ak, sc_k, goleft), 10),
        plain_ms=cuda_ms(lambda: pk.partition_segment_plain(
            ap, sc_p, goleft), 3),
        library_ms=cuda_ms(lambda: torch.sort(lib_key, stable=True), 5),
        bytes=pk.partition_bytes(n, G, quantized), rows=n)
    # the main path's in-place case: a ~40k-row child of the root's A stream
    c_rows = min(CHILD_ROWS, n_a)
    dst_b2 = cursor + -(-n_b // pk.ALLOC) * pk.ALLOC
    sc_k = make_sc(work0, c_rows, work0, dst_b2, 0)
    sc_p = sc_k.clone()
    pk.partition_segment(ak, sc_k, goleft)
    pk.partition_segment_plain(ap, sc_p, goleft)
    expect(torch.equal(sc_k, sc_p), "K3 child: counts differ")
    compare_regions([(work0, int(sc_k[pk.SC_CNT_A])),
                     (dst_b2, int(sc_k[pk.SC_CNT_B]))], "child")
    lib_key_c = (goleft[ak.bins[chan, work0:work0 + c_rows].long()] != 0
                 ).to(torch.uint8)
    k3["child"] = dict(
        ms=cuda_ms(lambda: pk.partition_segment(ak, sc_k, goleft), 20),
        plain_ms=cuda_ms(lambda: pk.partition_segment_plain(
            ap, sc_p, goleft), 5),
        library_ms=cuda_ms(lambda: torch.sort(lib_key_c, stable=True), 5),
        bytes=pk.partition_bytes(c_rows, G, quantized), rows=c_rows)
    print("K3 partition_segment (%s payload): root %d rows %.4f ms (plain "
          "%.4f, stable sort %.4f); child %d rows %.4f ms; exact"
          % (mode, n, k3["root"]["ms"], k3["root"]["plain_ms"],
             k3["root"]["library_ms"], c_rows, k3["child"]["ms"]))
    entry("partition_segment" + sfx, "partition_segment", k3["root"], 0.0,
          "exact", child=child(k3["child"]))

    # 255 leaf segments over the root split's output regions (every row
    # once, row ids permuted by the partition); redo the root split so both
    # regions hold the permutation again
    pieces = []
    for s, c in root_regions:
        k = LEAVES // 2 + (1 if s == work0 else 0)
        cuts = np.linspace(0, c, k + 1).astype(np.int64)
        pieces += [(s + int(cuts[i]), int(cuts[i + 1] - cuts[i]))
                   for i in range(k)]
    for a in arenas:
        pk.partition_segment(a, make_sc(0, n, work0, cursor, 1), goleft)
    # two layouts of the root split's output regions: the 255 even leaves
    # in a shuffled order, so leaf-index order is not column order; and a
    # skewed tree's leaves (one of half the rows, the rest geometric down
    # to 20 rows, cut where they cross from one region to the other), as a
    # real tree's sizes spread
    order = np.random.RandomState(5).permutation(LEAVES)
    rest = np.maximum(20, (n / 4 * 0.96 ** np.arange(LEAVES - 1)).astype(int))
    rest = np.maximum(20, rest * (n - n // 2) // max(int(rest.sum()), 1))
    sizes = np.concatenate([[n // 2], rest])
    sizes[0] += n - int(sizes.sum())
    cuts = np.concatenate([[0], np.cumsum(sizes)])
    skewed, v0 = [], 0
    for s, c in root_regions:
        for a, b in zip(cuts[:-1], cuts[1:]):
            lo, hi = max(int(a), v0), min(int(b), v0 + c)
            if lo < hi:
                skewed.append((s + lo - v0, hi - lo))
        v0 += c
    layouts = {
        "even": [pieces[i] for i in order],
        "skewed": [skewed[i] for i in np.random.RandomState(6).permutation(
            len(skewed))]}

    # ---- K4 (payload-independent: measured with the f32 arenas) ----------
    if not quantized:
        k4_phase(ak, layouts, gen, results, entry)

    # ---- K6 -----------------------------------------------------------
    # the two layouts compacted past both regions
    dst0 = cursor + n_al + pk.TILE
    k6 = {}
    for what, lay in layouts.items():
        seg6 = torch.tensor(lay, dtype=torch.int32, device=dev)
        nl6 = torch.tensor([len(lay)], dtype=torch.int32, device=dev)
        used_k = pk.compact_carry(ak, seg6, nl6, dst0)
        used_p = pk.compact_carry_plain(ap, seg6, nl6, dst0)
        expect(int(used_k[0]) == int(used_p[0]) == n,
               "K6 %s: rows written differ" % what)
        for pk_, pp_ in ((ak.bins, ap.bins), (ak.payload, ap.payload),
                         (ak.rid[None], ap.rid[None])):
            expect(torch.equal(pk_[:, dst0:dst0 + n], pp_[:, dst0:dst0 + n]),
                   "K6 %s: compacted planes differ" % what)
        cols = torch.cat([torch.arange(s, s + c, device=dev)
                          for s, c in lay])
        k6[what] = dict(
            ms=cuda_ms(lambda: pk.compact_carry(ak, seg6, nl6, dst0), 20),
            kernel_ms=kernel_only_ms(
                lambda: pk.compact_carry(ak, seg6, nl6, dst0), 20),
            plain_ms=cuda_ms(lambda: pk.compact_carry_plain(
                ap, seg6, nl6, dst0), 3),
            library_ms=cuda_ms(lambda: torch.index_select(ak.bins, 1, cols),
                               5),
            bytes=pk.compact_carry_bytes(n, G, len(lay), quantized), rows=n,
            leaves=len(lay), largest=max(c for _s, c in lay),
            smallest=min(c for _s, c in lay))
    print("K6 compact_carry (%s payload): %d rows, %d even leaves %.4f ms, "
          "kernel-only %s (plain %.4f, index_select of the bins %.4f); "
          "%d skewed leaves (%d to %d rows) %.4f ms, kernel-only %s; exact"
          % (mode, n, LEAVES, k6["even"]["ms"],
             profiled(k6["even"]["kernel_ms"]),
             k6["even"]["plain_ms"], k6["even"]["library_ms"],
             k6["skewed"]["leaves"], k6["skewed"]["smallest"],
             k6["skewed"]["largest"], k6["skewed"]["ms"],
             profiled(k6["skewed"]["kernel_ms"])))
    entry("compact_carry" + sfx, "compact_carry", k6["even"], 0.0, "exact",
          library="torch.index_select of the bin planes over the "
                  "precomputed column list", skewed=dict(
              child(k6["skewed"]), leaves=k6["skewed"]["leaves"],
              smallest=k6["skewed"]["smallest"],
              largest=k6["skewed"]["largest"]))
    del arenas, ak, ap, cols
    torch.cuda.empty_cache()


def k4_phase(ak, layouts, gen, results, entry):
    """K4 in set mode (f32 leaf values) and in add mode (the fused paths'
    score update, shrinkage 0.1) on the even and skewed layouts of the root
    split's regions and, at the full row count, on a real carried tree's
    leaf segments (lightgbm_tpu_torch/tools/carried_leaf_seg.json, at its
    columns of the same 6-fold arena), each layout's row ids in the order
    a grown tree leaves them (`tools.tree_row_order`): each held bit for
    bit to its plain version, then timed by CUDA events and kernel-only
    beside the plain version, the library call over the expanded (row,
    value) pairs (index_put_; with accumulate=True in add mode) and, in add
    mode, the chain it replaces (a zeroed delta, K4 in set mode, a multiply
    and an add over n rows)."""
    import torch
    from pathlib import Path
    from lightgbm_tpu_torch.ops import partition_kernel as pk
    from lightgbm_tpu_torch.tools import tree_row_order

    n, dev = ak.num_data, ak.device
    lays = dict(layouts)
    path = (Path(pk.__file__).resolve().parent.parent / "tools"
            / "carried_leaf_seg.json")
    with open(path) as f:
        carried = json.load(f)
    if carried["rows"] == n and carried["cap"] == ak.cap:
        lays["carried"] = [tuple(sc)
                           for sc in carried["seg"][:carried["nl"]]]
    # each layout's row ids in the order a grown tree leaves them (the
    # pristine root's row order; a previous tree's carried order), written
    # over the arena's row ids, which K6's phase then gets back
    rid0 = ak.rid.clone()
    shrink = 0.1
    s_t = torch.tensor(shrink, dtype=torch.float32, device=dev)
    r = {"set": {}, "add": {}}
    for what, lay in lays.items():
        L = len(lay)
        order = torch.from_numpy(tree_row_order(
            [c for _s, c in lay], np.random.RandomState(L),
            LEAVES if what == "carried" else 0)).to(dev)
        pos = 0
        for s0, c in lay:
            ak.rid[s0:s0 + c] = order[pos:pos + c]
            pos += c
        seg = torch.tensor(lay, dtype=torch.int32, device=dev)
        nl = torch.tensor([L], dtype=torch.int32, device=dev)
        vals = torch.randn(L, generator=gen, device=dev)
        rid_all = torch.cat([ak.rid[s0:s0 + c].long() for s0, c in lay])
        val_all = torch.cat([vals[i].expand(c)
                             for i, (_s, c) in enumerate(lay)])
        score = torch.randn(n, generator=gen, device=dev)
        for mode in ("set", "add"):
            # the add mode's shrinkage a device scalar, as the fused
            # rounds give it
            sh = s_t if mode == "add" else None
            out_k = score.clone()
            out_p = score.clone()
            pk.scatter_segments(ak, seg, vals, nl, out_k, shrink=sh)
            pk.scatter_segments_plain(ak, seg, vals, nl, out_p, shrink=sh)
            expect(torch.equal(out_k.view(torch.int32),
                               out_p.view(torch.int32)),
                   "K4 %s %s: outputs differ" % (mode, what))
            if mode == "set":
                lib = lambda: out_p.index_put_((rid_all,), val_all)
            else:
                prod = val_all * s_t
                lib = lambda: out_p.index_put_((rid_all,), prod,
                                               accumulate=True)
            run = lambda: pk.scatter_segments(ak, seg, vals, nl, out_k,
                                              shrink=sh)
            r[mode][what] = dict(
                ms=cuda_ms(run, 20), kernel_ms=kernel_only_ms(run, 20),
                plain_ms=cuda_ms(lambda: pk.scatter_segments_plain(
                    ak, seg, vals, nl, out_p, shrink=sh), 3),
                library_ms=cuda_ms(lib, 5),
                bytes=pk.scatter_bytes(n, L, add=mode == "add"), rows=n,
                leaves=L, largest=max(c for _s, c in lay),
                smallest=min(c for _s, c in lay))
            if mode == "add":
                def chain():
                    delta = torch.zeros(n, device=dev)
                    pk.scatter_segments(ak, seg, vals, nl, delta)
                    out_p.add_(delta * s_t)
                r[mode][what]["chain_ms"] = cuda_ms(chain, 20)
                del prod
        del rid_all, val_all, score, out_k, out_p, order
    ak.rid.copy_(rid0)
    del rid0
    for mode, rm in r.items():
        print("K4 scatter_segments %s mode: %d rows; %s; exact" % (
            mode, n, "; ".join(
                "%s (%d leaves, %d to %d rows) %.4f ms, kernel-only %s "
                "(bound %.4f, plain %.4f, index_put_%s %.4f%s)" % (
                    what, v["leaves"], v["smallest"], v["largest"], v["ms"],
                    profiled(v["kernel_ms"]), bound(v["bytes"], 0)[0],
                    v["plain_ms"],
                    "(accumulate)" if mode == "add" else "",
                    v["library_ms"], ", the replaced chain %.4f"
                    % v["chain_ms"] if "chain_ms" in v else "")
                for what, v in rm.items())))
        name = "scatter_segments" + ("_add" if mode == "add" else "")
        entry(name, "scatter_segments", rm["even"], 0.0, "bit for bit",
              op=mode, library="index_put_%s of the expanded (row, value) "
              "pairs" % (", accumulate=True," if mode == "add" else ""),
              layouts={what: dict(
                  {k: v[k] for k in ("ms", "kernel_ms", "plain_ms",
                                     "library_ms", "leaves", "smallest",
                                     "largest", "chain_ms") if k in v},
                  bound_ms=bound(v["bytes"], 0)[0])
                  for what, v in rm.items()})


def leaf_kernel_phase(ds, dev, results):
    """K7 over the dataset's row-major device bins, f32 and int8, against
    its plain versions: the root (every row in leaf 0) and a leaf of about
    CHILD_ROWS rows spread over all rows, as a 255-leaf tree's leaves lie
    in the label engine's leaf ids."""
    import torch
    from lightgbm_tpu_torch.ops import histogram_kernel as hk

    n, F = ds.num_data, ds.num_features
    B = int(ds.feature_num_bins().max())
    bins = ds.device_bins(dev)
    rng = np.random.RandomState(17)
    g = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
    h = torch.from_numpy((rng.rand(n) * 0.25 + 0.01).astype(np.float32)
                         ).to(dev)
    gq = torch.from_numpy(rng.randint(-127, 128, n).astype(np.int8)).to(dev)
    hq = torch.from_numpy(rng.randint(0, 128, n).astype(np.int8)).to(dev)
    leaves = rng.randint(0, LEAVES, n)
    child = int(np.argmin(np.abs(np.bincount(leaves) - CHILD_ROWS)))
    ids = {"root": np.zeros(n, np.int64), "child": leaves}
    work = hk.row_list(n, dev)      # the row list, as a grower holds it
    leaf_forms(bins, {"leaf_histogram": (g, h),
                      "leaf_histogram_i8": (gq, hq)},
               ids, child, B, work, dev, results)
    # the f64 payload (tpu_double_precision), launched by the general
    # grower's f64 run
    leaf_forms(bins, {"leaf_histogram_f64": (g.double(), h.double())},
               ids, child, B, work, dev, results, shape_of="general")
    del g, h, gq, hq, work
    torch.cuda.empty_cache()


def leaf_forms(bins, forms, ids, child, B, work, dev, results,
               shape_of: str = None):
    """K7's forms of `forms` (name -> payload pair) over one matrix of
    device bins, at the root and on the leaf `child` of the ids, against
    the plain version: exact for int8 codes, counts equal and g/h within
    1e-5 of the bin's |value| sum in f32 (1e-12 in f64); timed beside the
    plain version, index_add_ and the bound."""
    import torch
    from lightgbm_tpu_torch.io.dataset import bin_values
    from lightgbm_tpu_torch.ops import histogram_kernel as hk
    n, F = bins.shape
    bin_bytes = bins.element_size()
    for name, (pg, ph) in forms.items():
        quantized = name.endswith("_i8")
        wide = pg.dtype == torch.float64
        fn = hk.leaf_histogram_quantized if quantized else hk.leaf_histogram
        plain = (hk.leaf_histogram_quantized_plain if quantized
                 else hk.leaf_histogram_plain)
        tol = 1e-12 if wide else 1e-5
        r = {}
        for what, lid in ids.items():
            leaf_ids = torch.from_numpy(lid.astype(
                np.uint8 if quantized else np.int32)).to(dev)
            leaf = torch.tensor([0 if what == "root" else child],
                                dtype=torch.int32, device=dev)
            got = fn(bins, pg, ph, leaf_ids, leaf, B, work)
            want = plain(bins, pg, ph, leaf_ids, leaf, B)
            m = int((lid == int(leaf[0])).sum())
            expect(int(want[0, :, 2].sum()) == m, "K7 %s: counts %d of %d"
                   % (what, int(want[0, :, 2].sum()), m))
            if quantized:
                expect(torch.equal(got, want), "K7 int8 %s: histograms "
                       "differ" % what)
                err = 0.0
            else:
                expect(torch.equal(got[..., 2], want[..., 2]),
                       "K7 %s: counts differ" % what)
                scale = plain(bins, pg.abs(), ph, leaf_ids, leaf, B)
                err_t = (got - want).abs()
                err = float(err_t.max())
                rel = float((err_t / scale.clamp_min(1e-30)).max())
                expect(rel <= tol, "K7 %s %s: error %.3g of the |value| sums"
                       " exceeds rtol %g" % (name, what, rel, tol))
            # the library yardstick: one index_add_ of the leaf's (feature,
            # row) pairs into the [F*B, 3] histogram
            rows = (leaf_ids.to(torch.int32) == leaf).nonzero()[:, 0]
            flat = (torch.arange(F, device=dev)[None, :] * B
                    + bin_values(bins.index_select(0, rows))).reshape(-1)
            vdt = (torch.int32 if quantized else torch.float64 if wide
                   else torch.float32)
            vals = torch.stack([pg[rows].to(vdt), ph[rows].to(vdt),
                                torch.ones(m, dtype=vdt, device=dev)], dim=1
                               ).repeat_interleave(F, dim=0)
            hist0 = torch.zeros((F * B, 3), dtype=vdt, device=dev)
            r[what] = dict(
                max_abs_err=err, rows=m,
                ms=cuda_ms(lambda: fn(bins, pg, ph, leaf_ids, leaf, B, work),
                           20),
                plain_ms=cuda_ms(lambda: plain(bins, pg, ph, leaf_ids, leaf,
                                               B), 3),
                library_ms=cuda_ms(lambda: hist0.index_add_(0, flat, vals),
                                   5),
                bytes=hk.leaf_histogram_bytes(n, m, F, B, quantized,
                                              bin_bytes,
                                              8 if wide else 4),
                ops=3 * F * m)
            del flat, vals, rows
        print("K7 %s: B = %d; root %d rows %.4f ms (plain %.4f, index_add_ "
              "%.4f); child leaf of %d rows %.4f ms (plain %.4f, index_add_ "
              "%.4f); %s"
              % (name, B, n, r["root"]["ms"], r["root"]["plain_ms"],
                 r["root"]["library_ms"], r["child"]["rows"],
                 r["child"]["ms"], r["child"]["plain_ms"],
                 r["child"]["library_ms"], "exact" if quantized else
                 "max abs err %.3g" % max(r["root"]["max_abs_err"],
                                          r["child"]["max_abs_err"])))
        b_ms, b_by = bound(r["root"]["bytes"], r["root"]["ops"])
        results[name] = dict(
            name=name, route="cuda", source=SRC % "leaf_histogram",
            replaces=REPLACES["leaf_histogram_i8" if quantized
                              else "leaf_histogram"],
            mode="int8" if quantized else "f64" if wide else "f32",
            bins="uint16" if bin_bytes == 2 else "uint8", B=B,
            launches=0,
            max_abs_err=max(r["root"]["max_abs_err"],
                            r["child"]["max_abs_err"]),
            tolerance="exact" if quantized else
            "counts equal; g/h within %g of the bin's |value| sum" % tol,
            ms=r["root"]["ms"], plain_ms=r["root"]["plain_ms"],
            bound_ms=b_ms, bound_by=b_by, library_ms=r["root"]["library_ms"],
            library="index_add_ of the leaf's (feature, row) pairs",
            rows=n, child=dict(
                {k: r["child"][k] for k in ("ms", "plain_ms", "library_ms",
                                            "rows")},
                bound_ms=bound(r["child"]["bytes"], r["child"]["ops"])[0]))
        if shape_of is not None:
            results[name]["shape_of"] = shape_of


def ablate_phase(n: int, dev, results):
    """K8: K3's stages timed at n rows on an f32 and an int8 arena
    (lightgbm_tpu_torch.tools.kernel_ablate), the full stage held exactly
    equal to K3's plain version inside run()."""
    import torch
    from lightgbm_tpu_torch.tools import kernel_ablate

    r = kernel_ablate.run(n, device=dev)
    for arena, a in r.items():
        prev = 0.0
        steps = []
        for stage, ms in a["ms"].items():
            steps.append("%s %.4f (+%.4f)" % (stage, ms, ms - prev))
            prev = ms
        print("K8 partition_ablate (%s arena, %d rows, F=%d): ms a pass by "
              "cumulative stage: %s; K3 plain %.4f, stable sort %.4f; full "
              "stage exact" % (arena, n, kernel_ablate.FEATURES,
                               ", ".join(steps), a["plain_ms"],
                               a["library_ms"]))
    f = r["f32"]
    b_ms, b_by = bound(f["bytes"], 0)
    results["partition_ablate"] = dict(
        name="partition_ablate", route="cuda", source=SRC % "partition_ablate",
        replaces=REPLACES["partition_ablate"], mode="f32", launches=0,
        max_abs_err=0.0, tolerance="full stage exact (K3's plain version)",
        ms=f["ms"]["full"], plain_ms=f["plain_ms"], bound_ms=b_ms,
        bound_by=b_by, library_ms=f["library_ms"],
        library="torch.sort(stable) of the side key, as K3's",
        rows=n, stages_ms={k: v["ms"] for k, v in r.items()},
        int8=dict(ms=r["int8"]["ms"]["full"], plain_ms=r["int8"]["plain_ms"],
                  library_ms=r["int8"]["library_ms"],
                  bound_ms=bound(r["int8"]["bytes"], 0)[0]))
    torch.cuda.empty_cache()


def parity_phase(dev, path: str, objective: str = None, data: str = None,
                 boosting: str = None):
    """A small run on the card against the same run on the CPU, stepped
    with update() so each tree's bag can be read: a path of the binary
    runs, or with `objective` that objective on the f32 path's settings
    (lambdarank on about 170 queries of the MSLR generator, multiclass on
    20k rows of the Covertype generator, its 7 classes a tree each a
    round, the others on the Higgs generator; none of them rides the
    carried arena).  Multiclass grows both runs' trees from the same
    gradients (`share_gradients`), and holds the card's own gradients to
    the CPU's apart.  data="airline": 20k rows of the airline generator
    with its six category columns categorical; data="onehot": the
    Covertype generator at its one-hot layout, EFB bundling it.  On
    categorical data a tree may take a bin set's complement where both
    walks of the sorted scan reach it with gains equal but for the f32
    sums' order (ROADMAP.md queue 3): it must then split the rows into
    the same leaves, its children swapped.  boosting: a boosting mode of
    BOOSTING_PARITY on the path's settings; GOSS's in-sample rows take
    the bag's place in the checks."""
    import lightgbm_tpu_torch as lt
    quantized = flag(path, "quantized")
    name = "_".join(x for x in (boosting or objective or path, data) if x)
    group = None
    cat_kw = {}
    if data == "airline":
        X, y, _ = airline_like(20_000, seed=41)
        cat_kw = dict(categorical_feature=list(AIRLINE_CATS))
    elif data == "onehot":
        X, y, _ = covertype_onehot(20_000, seed=43)
    elif objective == "lambdarank":
        X, y, group, _ = mslr_like(RANK_PARITY_QUERIES, seed=13)
    elif objective == "multiclass":
        X, y, _ = covertype_like(20_000, seed=23)
    else:
        X, y, Xh, yh = higgs_like(20_000, seed=11)
    w = row_weights(len(y)) if flag(path, "weighted") else None
    params = path_params(path, num_leaves=31)
    if objective is not None:
        params["objective"] = objective
    if boosting is not None:
        params.update(BOOSTING_PARITY[boosting])
    kc = COVTYPE_K if objective == "multiclass" else 1
    if kc > 1:
        params["num_class"] = kc
    out = {}
    for role, d in (("card", dev), ("cpu", "cpu")):
        ds = lt.Dataset(X, y, weight=w, group=group, device=d, **cat_kw)
        bst = lt.Booster(params, ds, device=d)
        if flag(path, "valid"):
            bst.add_valid(lt.Dataset(Xh, yh, reference=ds, device=d),
                          "holdout")
        out[role] = (bst, [], [])
    (bk, bags_k, evals_k), (bc, bags_c, evals_c) = out["card"], out["cpu"]
    shared = share_gradients(bk, bc) if kc > 1 else None
    drops = {}
    for _ in range(3):
        # the CPU first: a multiclass round's gradients feed the card's
        for role in ("cpu", "card"):
            bst, bags, evals = out[role]
            if shared is not None and role == "card":
                shared()
            bst.update()
            mask = bst._gbdt._bag_mask
            drops.setdefault(role, []).append(
                list(getattr(bst._gbdt, "_drop_index", ())))
            if boosting == "goss" and bst._gbdt._bag_pred is not None:
                mask = np.where(bst._gbdt._bag_pred.cpu().numpy() == 1, 0,
                                -1).astype(np.int32)
            bags.append(None if mask is None else mask.copy())
            evals.append(bst.eval_valid())
    for role in ("card", "cpu"):
        bst = out[role][0]
        bst.num_trees()                 # drains the fused paths' trees
        g = bst._gbdt
        expect(g._quantized is quantized
               and bool(g._carried_active) is (carried(path)
                                                and objective is None
                                                and boosting is None)
               and (boosting is None or type(g).__name__
                    == BOOSTING_CLASS[boosting]),
               "parity %s: the %s run took another path" % (name, role))
        expect((g.is_categorical is not None) is (data == "airline")
               and (g.bundle is not None) is (data == "onehot"),
               "parity %s: the %s run has categorical features %s, bundles "
               "%s" % (name, role, g.is_categorical is not None,
                       g.bundle is not None))
    grad_err = None
    if kc > 1:
        # the card's own gradients of the CPU's score against the CPU's
        sc = bc._gbdt.scores
        gk, hk = bk._gbdt.objective.__class__.get_gradients(
            bk._gbdt.objective, sc.to(dev))
        gc, hc = bc._gbdt.objective.__class__.get_gradients(
            bc._gbdt.objective, sc)
        grad_err = max(float((gk.cpu() - gc).abs().max()),
                       float((hk.cpu() - hc).abs().max()))
        expect(grad_err <= 2e-6, "parity %s: the card's gradients differ "
               "from the CPU's by %.3g" % (name, grad_err))
    gb, cb = bk._gbdt.models, bc._gbdt.models
    expect(len(gb) == len(cb) == 3 * kc, "parity %s: tree counts differ"
           % name)
    moved, oob_moved, leaf_err, mirrored = [], [], 0.0, 0
    for t, (a, b) in enumerate(zip(gb, cb)):
        bag = bags_k[t // kc]
        expect((bag is None) == (bags_c[t // kc] is None)
               and (bag is None or np.array_equal(bag, bags_c[t // kc])),
               "parity %s: the bags of tree %d differ" % (name, t))
        k = a.num_leaves - 1
        expect(a.num_leaves == b.num_leaves > 1
               and np.array_equal(a.split_feature[:k], b.split_feature[:k]),
               "parity %s: card and CPU trees split on different features"
               % name)
        # a threshold may move across bins that hold no row of the node's
        # bag: both thresholds then split its rows alike and their gains
        # tie up to the reassociation of the f32 sums (K2's atomics, the
        # root sum); rows out of the bag in those bins then take the other
        # way, in that tree only
        moved.append(int((a.threshold_in_bin[:k]
                          != b.threshold_in_bin[:k]).sum()))
        la, lb = a.predict_leaf_index(X), b.predict_leaf_index(X)
        if data == "airline" and not np.array_equal(la, lb) and len(
                set(zip(la, lb))) == len(set(la)) == len(set(lb)):
            # a bin set and its complement: the same leaves, relabelled
            mirrored += 1
            expect(np.allclose(a.leaf_value[la], b.leaf_value[lb],
                               rtol=1e-4, atol=1e-6),
                   "parity %s: tree %d's swapped leaves differ in value"
                   % (name, t))
            moved.append(0)
            oob_moved.append(0)
            continue
        differ = la != lb
        in_bag = np.ones(len(y), bool) if bag is None else bag == 0
        expect(not differ[in_bag].any(),
               "parity %s: rows of tree %d's bag land in different leaves"
               % (name, t))
        oob_moved.append(int(differ.sum()))
        expect(not differ.any() or moved[-1] > 0,
               "parity %s: out-of-bag rows of tree %d land in different "
               "leaves with no threshold moved" % (name, t))
        scale = float(np.abs(b.leaf_value[:k + 1]).max())
        err = np.abs(a.leaf_value[:k + 1] - b.leaf_value[:k + 1])
        leaf_err = max(leaf_err, float(err.max()) / max(scale, 1e-30))
        if not any(oob_moved[:-1]):
            # before any out-of-bag row took another way, the scores and
            # so the gradients of the next tree agree as without a bag:
            # binary's leaf values within rtol 1e-4, atol 1e-6; another
            # objective's, whose gradients have another scale, within 1e-4
            # of the tree's largest |value|
            rtol, atol = (1e-4, 1e-6) if objective is None else (
                0.0, 1e-4 * scale)
            expect(np.all(err <= atol + rtol * np.abs(b.leaf_value[:k + 1])),
                   "parity %s: leaf values differ by %.3g (largest %.3g)"
                   % (name, float(err.max()), scale))
    pg = bk.predict(X, raw_score=True)
    pc = bc.predict(X, raw_score=True)
    diff = float(np.abs(pg - pc).max())
    # multiclass, grown from the same gradients, and the categorical and
    # bundled runs: within 5e-6 of the scores' scale
    limit = (1e-4 if kc == 1 and data is None
             else 5e-6 * max(1.0, float(np.abs(pc).max())))
    expect(np.all(np.isfinite(pg)) and (diff <= limit or any(oob_moved)),
           "parity %s: raw training predictions differ by %.3g (limit %.3g)"
           % (name, diff, limit))
    msg = ("parity (%s): %d rows, 3 rounds%s, 31 leaves: card and CPU trees "
           "split on the same features with every %s in the same leaf "
           "(thresholds moved across empty bins, per tree: %s); leaf values "
           "within %.3g of the largest; raw training prediction max diff "
           "%.3g"
           % (name, len(y), "" if kc == 1 else " of %d trees" % kc,
              "row" if w is not None or not flag(path, "bagged")
              else "row of the bag", moved, leaf_err, diff))
    if data == "airline":
        msg += ("; %d of %d trees took a bin set's complement, the same "
                "leaves relabelled" % (mirrored, len(gb)))
    if grad_err is not None:
        msg += ("; both grown from the CPU's gradients rounded to 1/256; "
                "the card's own gradients of the CPU's score within %.3g "
                "of the CPU's" % grad_err)
    if flag(path, "bagged"):
        msg += ("; equal bags of %d rows each round; out-of-bag rows in "
                "another leaf per tree: %s" % (int((bags_k[0] == 0).sum()),
                                               oob_moved))
    if boosting == "goss":
        msg += ("; equal samples, rows in them per round %s; rows out of "
                "them in another leaf per tree: %s"
                % ([None if b is None else int((b == 0).sum())
                    for b in bags_k], oob_moved))
    if boosting == "dart":
        expect(drops["card"] == drops["cpu"] and any(drops["card"]),
               "parity %s: drops card %s, CPU %s" % (name, drops["card"],
                                                     drops["cpu"]))
        msg += "; equal drops per round %s" % drops["card"]
    if flag(path, "valid"):
        vk = [e[0][2] for e in evals_k]
        vc = [e[0][2] for e in evals_c]
        expect(np.all(np.isfinite(vk)), "parity %s: holdout AUC not finite"
               % name)
        msg += "; holdout AUC per round card %s, CPU %s" % (vk, vc)
    print(msg)
    return dict(rows=len(y), thresholds_moved=moved, oob_rows_moved=oob_moved,
                leaf_rel_err=leaf_err, max_raw_diff=diff,
                card_grad_err=grad_err, mirrored_trees=mirrored)


def share_gradients(card, cpu):
    """Grow a card booster's trees from a CPU twin's gradients: the CPU's
    objective rounds its gradients to multiples of 1/256 (hessians in
    [1/256, 2]), so that every histogram sum is exact on both devices
    whatever order the card's atomics add in, and keeps them; the card's
    objective returns two static device buffers (its round graphs capture
    them as inputs), which the returned hook fills from the CPU's last
    gradients before each card round.  Each device's own softmax
    gradients round exp() differently, and a near tie of two gains then
    takes another feature on one of them."""
    import torch
    cpu_obj, card_obj = cpu._gbdt.objective, card._gbdt.objective
    real = cpu_obj.get_gradients
    last = []
    bufs = []

    def cpu_gradients(score):
        grad, hess = real(score)
        last[:] = (torch.clamp(torch.round(grad * 256), -512, 512) / 256,
                   torch.clamp(torch.round(hess * 256), 1, 512) / 256)
        return tuple(last)

    def hook():
        if not bufs:
            bufs.extend(t.to(card._gbdt.device) for t in last)
        for buf, t in zip(bufs, last):
            buf.copy_(t)

    cpu_obj.get_gradients = cpu_gradients
    card_obj.get_gradients = lambda score: tuple(bufs)
    return hook


# each training path's trees and model text as trained (training_phase),
# which the general-grower phase compares with
TRAINED = {}
# the host walk of the prediction run's model over the holdout (raw sums)
HOLDOUT_HOST = {}


def training_phase(X, Xh, yh, ds_obj, valid_obj, rounds, dev, reduced, path):
    """A main path: lightgbm_tpu_torch.train on the card (train_and_check),
    then predict on the holdout."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.metric import auc

    quantized = flag(path, "quantized")
    ds_obj.set_weight(row_weights(len(X)) if flag(path, "weighted")
                      else None)
    kw = {}
    evals = {}
    if flag(path, "valid"):
        kw = dict(valid_sets=[valid_obj], valid_names=["holdout"],
                  early_stopping_rounds=EARLY_STOPPING_ROUNDS,
                  evals_result=evals, verbose_eval=False)
    # every round after a path's first is one graph replay; the rounds
    # that no validation set reads (fused, bagged, label engine) fetch
    # their trees only at drains, the valid-set ones one a round
    must, never = path_kernels(path)
    booster, rec = train_and_check(
        path, path_params(path), ds_obj, dev, rounds, must, never,
        deferred=not flag(path, "valid"), graphs=2 if carried(path) else 1,
        **kw)
    g = booster._gbdt
    expect(g._quantized is quantized
           and bool(g._carried_active) is carried(path),
           "%s training: quantized %s, carried %s" % (path, g._quantized,
                                                      g._carried_active))
    # the trained model, before the replayed and profiled rounds add to it
    TRAINED[path] = (list(g.models), booster.model_to_string())
    if flag(path, "bagged"):
        expect(g._bag_count == int(BAGGING["bagging_fraction"] * len(X)),
               "%s training: %s rows in the bag" % (path, g._bag_count))
    t = time.perf_counter()
    pred = booster.predict(Xh)
    predict_s = time.perf_counter() - t
    expect(pred.shape == (len(Xh),) and np.all(np.isfinite(pred)),
           "%s holdout predictions are not finite [n]" % path)
    # KP1's sums against the host walk of the same trees, bit for bit
    raw = booster.predict(Xh, raw_score=True)
    host = booster.predict(Xh, raw_score=True, device=False)
    expect(np.array_equal(raw, host), "%s: KP1's holdout sums differ from "
           "the host walk's by up to %.3g" % (path,
                                              float(np.abs(raw - host).max())))
    leaves = rec["leaves"]
    trained = len(leaves)
    if flag(path, "label"):
        # the label engine has no arena to run out of
        expect(not g._use_partition_engine and g.arena is None
               and min(leaves) == LEAVES,
               "%s: the label engine grew leaves %s" % (path, leaves))
    holdout_auc = auc(yh, pred)
    expect(holdout_auc >= AUC_FLOOR, "%s holdout AUC %.4f < %.2f"
           % (path, holdout_auc, AUC_FLOOR))
    extra = ""
    if flag(path, "valid"):
        # the validation score, kept on the card by the binned walk, against
        # the host walk of the same trees
        last = evals["holdout"]["auc"][-1]
        expect(len(evals["holdout"]["auc"]) == trained
               and abs(last - holdout_auc) <= 1e-6,
               "%s: last evals_result AUC %.8f, host predict AUC %.8f"
               % (path, last, holdout_auc))
        extra = ("; evals_result holdout AUC %s, best_iteration %d"
                 % (evals["holdout"]["auc"], booster.best_iteration))
    graphs = rec["graphs"]
    replays = sum(x["replays"] for x in graphs)
    replay_ms = replayed_round_ms(booster, REPLAYED_ROUNDS)
    rate = len(X) * trained / rec["train_s"]
    arena = "carried arena" if carried(path) else (
        "label engine, eager" if flag(path, "label") else
        "pristine arena, eager" if flag(path, "bagged") or flag(path, "valid")
        else "pristine arena")
    print("training (%s, %s): %d rows%s x %d features, "
          "%d rounds, leaves %s; train %.3f s (%.1f ms a round, %.4g "
          "rows*rounds/s, set-up included); peak device memory %.3f GB; "
          "holdout AUC %.4f on %d rows (predict %.3f s)%s"
          % (path, arena, len(X), " (cut by --rows)" if reduced else "",
             X.shape[1], trained, leaves, rec["train_s"], rec["round_ms"],
             rate, rec["peak_bytes"] / 1e9, holdout_auc, len(Xh), predict_s,
             extra))
    print("  graphs (%s): %d captured, %d replays in training; nodes %s; "
          "capture and instantiate %s s; %d drains, %d tree fetches; "
          "%.1f ms a replayed round (%d more rounds, host clock, ending in "
          "a drain and a synchronize)"
          % (path, len(graphs), replays, [x["nodes"] for x in graphs],
             ["%.3f" % x["capture_s"] for x in graphs], rec["drains"],
             rec["tree_fetches"], replay_ms, REPLAYED_ROUNDS))
    rec.update(rows_rounds_per_s=rate, holdout_auc=holdout_auc,
               predict_s=predict_s, rows=len(X), evals_result=evals or None,
               best_iteration=booster.best_iteration,
               replay_round_ms=replay_ms)
    return booster, rec["launches"], rec


REPLAYED_ROUNDS = 3


def graphs_a_round(g) -> int:
    """The graphs a round of the booster's replays: one, or k > 1 classes'
    and the gradients' (GOSS: the gradients' with the sample, and the
    tree's; RF, whose gradients are taken once: one a class)."""
    k = g.num_tree_per_iteration
    if type(g).__name__ == "RF":
        return k
    return k + 1 if getattr(g, "_held", k > 1) else 1


@timed("replay")
def replayed_round_ms(booster, rounds: int) -> float:
    """Host ms a round over `rounds` more rounds of a trained booster, every
    one graph replays, from a synchronized card to the drain and
    synchronize after the last."""
    import torch
    g = booster._gbdt
    g._sync_model()
    torch.cuda.synchronize()
    before = sum(x["replays"] for x in g._graphs.stats())
    t = time.perf_counter()
    for _ in range(rounds):
        booster.update()
    g._sync_model()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / rounds
    expect(sum(x["replays"] for x in g._graphs.stats())
           == before + rounds * graphs_a_round(g),
           "a timed round did not replay its graphs")
    return ms


# aten operations that launch nothing: views, aliases, no-op conversions
NO_WORK_OPS = frozenset((
    "view", "as_strided", "_reshape_alias", "reshape", "expand", "slice",
    "select", "unsqueeze", "squeeze", "t", "transpose", "permute", "detach",
    "alias", "to", "contiguous", "unbind", "narrow", "flatten", "view_as",
    "lift_fresh", "empty", "empty_like", "empty_strided", "resize_"))


@timed("profile")
def profile_round(booster, what: str, rows: int = None,
                  held: int = None) -> dict:
    """One more boosting round under torch.profiler, a graph replay with the
    drain of its tree at its end: its wall time, the device time of every
    kernel by name, and the device's idle share.  With rows, also the
    PyTorch operations of a round over `rows` elements (the innermost aten
    operations with an input of that many elements, views and no-op
    conversions left out: each one a launch over the rows), counted by
    name from a capture of the round: the booster's graphs are dropped
    first, one round captures anew under a profiler of the host, and the
    carried path's other slot captures too before the profiled round.  A
    package without graphs (an older checkout) has its profiled round's
    operations counted.  `held`: the graphs the booster holds, where not
    the carried path's two or a round's (GOSS: its warm-up rounds' two
    and its sampled rounds' two)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    g = booster._gbdt
    graphs = getattr(g, "_graphs", None)
    sync = getattr(g, "_sync_model", lambda: None)
    over = None
    if rows is not None and graphs is not None:
        graphs.reset()
        with profile(activities=[ProfilerActivity.CPU],
                     record_shapes=True) as prof:
            booster.update()
        over = ops_over_rows(prof, rows)
        while True:
            held = len(graphs.graphs)
            booster.update()
            if len(graphs.graphs) == held:
                break
    sync()
    torch.cuda.synchronize()
    replays = (None if graphs is None else
               {k: x.replays for k, x in graphs.graphs.items()})
    wall = []

    def work():
        t = time.perf_counter()
        booster.update()
        sync()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t) * 1e3)
    prof, device, pad_held = traced(
        work, [ProfilerActivity.CPU, ProfilerActivity.CUDA],
        record_shapes=rows is not None and graphs is None)
    wall_ms = wall[0]
    least = 0
    if graphs is not None:
        per_round = graphs_a_round(g)
        replayed = [x for k, x in graphs.graphs.items()
                    if x.replays == replays.get(k, -1) + 1]
        expect(len(replayed) == per_round
               and sum(x.replays for x in graphs.graphs.values())
               == sum(replays.values()) + per_round
               and len(graphs.graphs) == (
                   held if held is not None else
                   2 if g._carried_active else per_round),
               "profile (%s): the profiled round did not replay its graphs"
               % what)
        # a complete trace holds an event for every node of the replayed
        # graphs (each a kernel, copy or memset), besides the drain's
        # eager launches
        least = sum(x.nodes for x in replayed)
    by_name = {}
    for ev in device:
        ms, cnt = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (ms + ev.ms, cnt + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    # the twelve longest, and every kernel of the port's own sources
    top = [kv for i, kv in enumerate(ranked)
           if i < 12 or kernel_label(kv[0]) is not None]
    by_kernel = {}
    for name, (ms, cnt) in by_name.items():
        label = kernel_label(name)
        if label is not None:
            k = by_kernel.setdefault(label, dict(ms=0.0, launches=0))
            k["ms"] += ms
            k["launches"] += cnt
    if rows is not None:
        if over is None:
            over = ops_over_rows(prof, rows)
        print("  operations over the %d rows (innermost aten, by name%s): "
              "%s" % (rows, "" if graphs is None else ", from a capture",
                      ", ".join("%s %d" % kv for kv in sorted(over.items()))
                      or "none"))
    out = {} if rows is None else dict(ops_over_rows=over)
    events = sum(c for _, c in by_name.values())
    if not by_name or events < least:
        print("profile (%s): the profiler's trace held %d device events of "
              "the replayed graph's %d nodes, and %d of %d spin "
              "kernels; device time not measured"
              % (what, events, least, pad_held, TRACE_PAD))
        return dict(out, wall_ms=wall_ms, device_ms=None, idle_share=None,
                    device_launches=events, graph_nodes=least)
    print("profile of one %s round (%s, profiler on): wall %.1f ms, device "
          "busy %.1f ms, idle share %.3f, %d device launches (the graph's "
          "nodes %s)"
          % (what, "eager" if graphs is None else
             "a graph replay, the drain of its tree included", wall_ms,
             busy_ms, 1 - busy_ms / wall_ms, events,
             least if graphs is not None else "none"))
    for name, (ms, cnt) in top:
        print("  %9.3f ms %6d x  %s" % (ms, cnt, name[:90]))
    print("  port kernels, device ms (launches): %s" % ", ".join(
        "%s %.3f (%d)" % (k, v["ms"], v["launches"])
        for k, v in sorted(by_kernel.items())))
    out.update(wall_ms=wall_ms, device_ms=busy_ms,
               idle_share=1 - busy_ms / wall_ms,
               device_launches=events, graph_nodes=least,
               by_kernel=by_kernel,
               top=[dict(name=n[:90], ms=ms, count=c) for n, (ms, c) in top])
    return out


# the runs of the multiclass phase (its EFB runs included) and the
# categorical phase whose round is profiled: softmax f32, and the
# 300-airport label run (the only round-level reading of K7 on uint16
# bins).  The others' profiles (PERF.md section 5 keeps their last
# readings) were cut to keep the smoke within its time when the public
# API's phase came in: a k-class round's trace holds some 250-310k
# device events, whose reading takes the host 8-15 s
PROFILED = ("multiclass_f32", "cat_label_wide_f32")


def profile_kept(booster, name: str) -> dict:
    """profile_round for a run of PROFILED; for another run a record that
    says it was not profiled."""
    if name in PROFILED:
        return profile_round(booster, name)
    print("profile of one %s round: not measured (PROFILED)" % name)
    return {"not_measured": "cut for the smoke's time (PROFILED)"}


def ops_over_rows(prof, rows: int) -> dict:
    """The innermost aten operations of a host profile with an input of
    `rows` elements, views and no-op conversions left out, by name."""
    import torch
    over = {}
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CPU
                and ev.name.startswith("aten::")
                and ev.name[6:] not in NO_WORK_OPS
                and not any(c.name.startswith("aten::")
                            for c in ev.cpu_children)
                and any(int(np.prod(sh)) == rows and len(sh) > 0
                        for sh in ev.input_shapes or ())):
            over[ev.name] = over.get(ev.name, 0) + 1
    return over


# the reference's Higgs experiment trains 500 rounds; cut to 250 to keep
# the whole smoke within its time when the boosting-modes phase came in,
# to 100 when the general grower's phase came in, to 50 when the public
# API's phase came in
PREDICT_ROUNDS = 50
TRAIN_ROWS_PREDICTED = 1_000_000
# processes that share the host walks of the prediction phase's checks: a
# host walk of the 100k holdout rows through 500 trees takes ~45 s in
# one process, and each row's walk (its early stop too) depends on no
# other row, so the rows are split among processes, each of which loads
# the model from its text, and the parts put together are one process's
# walk
HOST_WALK_PROCS = 8
EARLY_STOPS = ((10, 4.0), (10, 10.0))
BUCKETS = (1, 7, 1000, 4097)


_HOST_BOOSTER = None


def _host_walk_init(model: str) -> None:
    global _HOST_BOOSTER
    import torch
    import lightgbm_tpu_torch as lt
    torch.set_num_threads(1)
    _HOST_BOOSTER = lt.Booster(model_str=model, device="cpu")


def _host_walk_part(job):
    """One process's part of a host walk: (rows, predict's keywords) ->
    (the walk's output, its seconds)."""
    X, kw = job
    t = time.perf_counter()
    out = _HOST_BOOSTER.predict(X, device=False, **kw)
    return out, time.perf_counter() - t


@timed("host walks")
def host_walks(bst, X, checks: dict) -> dict:
    """The host walk (predict with device=False) of each check over all of
    X, {name: predict's keywords}, its rows split among HOST_WALK_PROCS
    spawned processes that load bst's model text: {name: (output, seconds
    of the walk summed over the parts, as one process spends them)}.  The
    processes end before it returns."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    parts = np.array_split(np.arange(len(X)), HOST_WALK_PROCS)
    jobs = [(X[p], kw) for kw in checks.values() for p in parts]
    with ProcessPoolExecutor(
            HOST_WALK_PROCS, mp_context=multiprocessing.get_context("spawn"),
            initializer=_host_walk_init,
            initargs=(bst.model_to_string(),)) as pool:
        outs = list(pool.map(_host_walk_part, jobs))
    walks = {}
    for i, name in enumerate(checks):
        mine = outs[i * len(parts):(i + 1) * len(parts)]
        walks[name] = (np.concatenate([o for o, _ in mine]),
                       sum(sec for _, sec in mine))
    return walks


def prediction_phase(X, Xh, ds_obj, dev, rounds, results):
    """The f32 carried configuration trained for `rounds` rounds at the
    dataset's rows (the entry a user calls: Booster.update, then predict),
    each drain timed; then KP1 on the model: the holdout and 1M training
    rows against its plain version on the card and the holdout against the
    host walk (host_walks), bit for bit; timed kernel-only (CUDA events, X
    on the card), from numpy (the wall of predict, the copy of X included)
    and by the host walk; leaf indices, early stop and the serving buckets
    against the host and the full sums; the ensemble's device bytes
    against the estimate.  The launch counters are zeroed just before the
    holdout's predict and read just after."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import _cuda
    from lightgbm_tpu_torch.ops import predict as pr
    from lightgbm_tpu_torch.ops.predict_kernel import predict_ensemble

    ds_obj.set_weight(None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst = lt.Booster(PARAMS, ds_obj, device=dev)
    g = bst._gbdt
    drains = []
    real_drain = g._drain_inflight

    def timed_drain():
        pending = len(g._inflight)
        t = time.perf_counter()
        out = real_drain()
        drains.append((pending, (time.perf_counter() - t) * 1e3))
        return out
    g._drain_inflight = timed_drain
    for _ in range(rounds):
        bst.update()
    g._sync_model()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    g._drain_inflight = real_drain
    leaves = [m.num_leaves for m in g.models]
    expect(len(leaves) == rounds and min(leaves) > 1 and g._carried_active
           and g._tree_fetches == 0,
           "prediction run: %d trees, leaves %d..%d, carried %s, %d fetches"
           % (len(leaves), min(leaves), max(leaves), g._carried_active,
              g._tree_fetches))
    full = [ms for k, ms in drains if k >= 48]
    print("prediction run (f32, carried arena): %d rows x %d features, %d "
          "rounds, %d trees, %d leaves (%d to %d a tree); train %.3f s "
          "(%.1f ms a round, set-up included); %d drains, of 48 trees "
          "%.1f-%.1f ms (mean %.1f), the last of %d trees %.1f ms"
          % (len(X), X.shape[1], rounds, len(leaves), sum(leaves),
             min(leaves), max(leaves), train_s, train_s * 1e3 / rounds,
             len(drains), min(full or [0]), max(full or [0]),
             float(np.mean(full or [0])), drains[-1][0], drains[-1][1]))

    ens = g._device_ensemble()
    tb, T, F = ens.tables, len(g.models), X.shape[1]
    expect(ens.device_bytes() == pr.estimate_device_bytes(g.models, 1),
           "ensemble: device bytes %d, estimated %d" % (
               ens.device_bytes(), pr.estimate_device_bytes(g.models, 1)))
    # the main path: predict on the holdout (f32, as a user passes it),
    # counted, after one warm-up call on the same rows (the first launch
    # loads the kernel's module, the first call of a size allocates the
    # pinned staging)
    bst.predict(Xh, raw_score=True)
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t = time.perf_counter()
    raw_h = bst.predict(Xh, raw_score=True)
    wall_h = (time.perf_counter() - t) * 1e3
    launches = int(_cuda.LAUNCHES["predict_ensemble"])
    expect(launches > 0, "predict did not launch KP1")
    checks = {"sums": dict(raw_score=True),
              "leaves": dict(pred_leaf=True)}
    for freq, margin in EARLY_STOPS:
        checks["freq%d_margin%g" % (freq, margin)] = dict(
            raw_score=True, pred_early_stop=True,
            pred_early_stop_freq=freq, pred_early_stop_margin=margin)
    t = time.perf_counter()
    walks = host_walks(bst, Xh, checks)
    walks_s = time.perf_counter() - t
    host_h, host_s = walks["sums"]
    host_ms = host_s * 1e3
    # the serving phase serves this model: its text and the holdout's
    # host walk
    TRAINED["prediction"] = (list(g.models), bst.model_to_string())
    HOLDOUT_HOST["raw"] = host_h
    expect(np.array_equal(raw_h, host_h), "KP1: holdout sums differ from "
           "the host walk's by up to %.3g" % float(np.abs(raw_h - host_h)
                                                  .max()))
    depths = leaf_depths(g.models, dev)
    rows = {}
    for what, Xs in (("holdout", Xh), ("train_1m", X[:TRAIN_ROWS_PREDICTED])):
        n = len(Xs)
        visits = walk_visits(tb, depths, torch.from_numpy(
            np.ascontiguousarray(Xs, np.float32)).to(dev), T)
        for dt in (np.float32, np.float64):
            Xn = np.ascontiguousarray(Xs, dt)
            Xd = torch.from_numpy(Xn).to(dev)
            out = torch.empty((1, n), dtype=torch.float64, device=dev)
            predict_ensemble(tb, Xd, T, 1, out)
            plain, plain_ms = cuda_call_ms(
                lambda: pr.predict_ensemble_plain(tb, Xd, T, 1))
            expect(torch.equal(out, plain), "KP1 %s %s: sums differ from "
                   "the plain version's by up to %.3g" % (
                       what, np.dtype(dt).name,
                       float((out - plain).abs().max())))
            kernel_ms = cuda_ms(lambda: predict_ensemble(tb, Xd, T, 1, out),
                                5)
            ko_ms = kernel_only_ms(lambda: predict_ensemble(tb, Xd, T, 1,
                                                            out), 5)
            bst.predict(Xn, raw_score=True)     # the staging, as above
            t = time.perf_counter()
            got = bst.predict(Xn, raw_score=True)
            wall_ms = (time.perf_counter() - t) * 1e3
            expect(np.array_equal(got, out[0].cpu().numpy()),
                   "KP1 %s %s: predict differs from the kernel's sums"
                   % (what, np.dtype(dt).name))
            if what == "holdout":
                expect(np.array_equal(got, raw_h), "KP1 holdout %s: sums "
                       "differ from the f32 rows' predict"
                       % np.dtype(dt).name)
            split = host_split(Xs, Xd, out, dt)
            nbytes = ensemble_bytes(n, F, Xn.itemsize, ens.device_bytes())
            rows["%s_%s" % (what, "f32" if dt == np.float32 else "f64")] = \
                dict(rows=n, dtype=np.dtype(dt).name, kernel_ms=kernel_ms,
                     kernel_only_ms=ko_ms, wall_ms=wall_ms,
                     plain_ms=plain_ms, split_ms=split, bytes=nbytes,
                     bound_ms=bound(nbytes, 0)[0], visits=visits,
                     visits_per_row=visits / n,
                     ns_per_visit=kernel_ms * 1e6 / visits,
                     visits_per_s=visits / kernel_ms * 1e3,
                     rows_per_s_kernel=n / kernel_ms * 1e3,
                     rows_per_s_wall=n / wall_ms * 1e3)
            del Xd, out, plain
    rows["holdout_f32"]["host_walk_ms"] = host_ms
    for what, r in rows.items():
        print("KP1 predict_ensemble (%s, %d rows, %d trees): kernel %.3f ms"
              " (kernel-only %s; %.4g rows/s; bound %.4f ms), from numpy "
              "%.3f ms (%.4g rows/s; %s), plain %.1f ms%s; %d visits (%.1f "
              "a row), %.4f ns a visit (%.4g visits/s); exact"
              % (what, r["rows"], T, r["kernel_ms"],
                 profiled(r["kernel_only_ms"]), r["rows_per_s_kernel"],
                 r["bound_ms"], r["wall_ms"],
                 r["rows_per_s_wall"], ", ".join(
                     "%s %.3f" % kv for kv in r["split_ms"].items()),
                 r["plain_ms"], ", host walk %.1f ms" % host_ms
                 if what == "holdout_f32" else "", r["visits"],
                 r["visits_per_row"], r["ns_per_visit"], r["visits_per_s"]))
    # leaf indices
    t = time.perf_counter()
    leaf = bst.predict(Xh, pred_leaf=True)
    leaf_ms = (time.perf_counter() - t) * 1e3
    leaf_host = walks["leaves"][0]
    expect(leaf.shape == (len(Xh), T) and np.array_equal(leaf, leaf_host),
           "KP1 leaf mode: leaves differ from the host walk's")
    # early stop
    stops = {}
    for freq, margin in EARLY_STOPS:
        kw = dict(raw_score=True, pred_early_stop=True,
                  pred_early_stop_freq=freq, pred_early_stop_margin=margin)
        t = time.perf_counter()
        es = bst.predict(Xh, **kw)
        es_ms = (time.perf_counter() - t) * 1e3
        es_host = walks["freq%d_margin%g" % (freq, margin)][0]
        expect(np.array_equal(es, es_host), "KP1 early stop (%d, %g): sums "
               "differ from the host's" % (freq, margin))
        stops["freq%d_margin%g" % (freq, margin)] = dict(
            wall_ms=es_ms, stopped_share=float(np.mean(es != raw_h)))
    # the serving buckets, the small-batch walk's path: counted from zero,
    # each bucket against predict, then timed
    _cuda.reset_launch_counts()
    for n in BUCKETS:
        got = g.predict_bucketed(Xh[:n], raw_score=True)
        expect(np.array_equal(got, raw_h[:n]), "predict_bucketed(%d rows) "
               "differs from predict" % n)
    small_launches = int(_cuda.LAUNCHES["predict_ensemble_small"])
    expect(small_launches > 0, "the serving buckets did not launch KP1's "
           "small-batch walk")
    bucket_ms = {}
    for n in BUCKETS:
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            g.predict_bucketed(Xh[:n], raw_score=True)
            ms.append((time.perf_counter() - t) * 1e3)
        bucket_ms[n] = min(ms)
    small = small_phase(tb, T, F, Xh, ens.device_bytes(), dev)
    print("KP1 leaf mode: %d x %d leaves equal to the host walk's (%.1f ms "
          "from numpy); early stop equal to the host's: %s; the host walks "
          "of the four checks %.1f s in %d processes; buckets %s "
          "equal to predict, %d small-batch launches, ms (best of 5, host "
          "clock): %s; device bytes %d equal to the estimate"
          % (len(Xh), T, leaf_ms, ", ".join(
              "freq %s: %.1f ms, %.3f of the rows stopped" % (
                  k.replace("freq", "").replace("_margin", ", margin "),
                  v["wall_ms"], v["stopped_share"])
              for k, v in stops.items()), walks_s, HOST_WALK_PROCS,
             list(BUCKETS), small_launches,
             ", ".join("%d rows %.3f" % kv for kv in bucket_ms.items()),
             ens.device_bytes()))
    print("KP1 predict_ensemble_small (%d rows, %d trees): kernel %.4f ms "
          "(kernel-only %s; bound %.5f ms), plain %.1f ms; exact"
          % (small["rows"], T, small["ms"],
             profiled(small["kernel_only_ms"]), small["bound_ms"],
             small["plain_ms"]))
    h = rows["holdout_f32"]
    b_ms, b_by = bound(h["bytes"], 0)
    results["predict_ensemble"] = dict(
        name="predict_ensemble", route="cuda", source=SRC % "predict_ensemble",
        replaces=REPLACES["predict_ensemble"], port_only=True,
        mode="f64 sum over f32 rows, row tiles", launches=launches,
        max_abs_err=0.0,
        tolerance="bit for bit (plain version and host walk)",
        ms=h["kernel_ms"], plain_ms=h["plain_ms"], bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        library="none: no single PyTorch call walks a tree",
        kernel_only_ms=h["kernel_only_ms"], host_walk_ms=host_ms,
        wall_ms=h["wall_ms"], rows=h["rows"], trees=T, by_shape=rows,
        leaf_ms=leaf_ms, early_stop=stops)
    results["predict_ensemble_small"] = dict(
        name="predict_ensemble_small", route="cuda",
        source=SRC % "predict_ensemble",
        replaces=REPLACES["predict_ensemble"], port_only=True,
        mode="f64 sum over f32 rows, (tree, row) pairs and an ordered sum",
        launches=small_launches, max_abs_err=0.0,
        tolerance="bit for bit (plain version and predict)",
        ms=small["ms"], plain_ms=small["plain_ms"],
        bound_ms=small["bound_ms"], bound_by="bytes", library_ms=None,
        library="none: no single PyTorch call walks a tree",
        kernel_only_ms=small["kernel_only_ms"], rows=small["rows"],
        trees=T, bucket_ms=bucket_ms)
    return dict(train_s=train_s, trees=T, leaves=sum(leaves),
                drains_ms=drains, predict=rows, early_stop=stops,
                leaf_ms=leaf_ms, bucket_ms=bucket_ms,
                device_bytes=ens.device_bytes(), launches=launches,
                small_launches=small_launches)


def profiled(ms) -> str:
    """A kernel-only time for print: the profiler's ms, or "not recorded"
    where its trace held none of the kernel's events (kernel_only_ms gave
    None; the CUDA-event time stands)."""
    return "not recorded" if ms is None else "%.4f" % ms


def leaf_depths(trees, dev) -> list:
    """Each tree's leaf depths by leaf id (the internal nodes a walk to
    that leaf visits), on the card."""
    import torch
    out = []
    for t in trees:
        depth = np.zeros(max(t.num_leaves, 1), np.int64)
        stack = [(0, 0)] if t.num_leaves > 1 else []
        while stack:
            node, d = stack.pop()
            for c in (int(t.left_child[node]), int(t.right_child[node])):
                if c < 0:
                    depth[~c] = d + 1
                else:
                    stack.append((c, d + 1))
        out.append(torch.from_numpy(depth).to(dev))
    return out


def walk_visits(tb, depths, Xd, T: int) -> int:
    """The node visits of KP1's sums over the rows of Xd: the sum over rows
    and trees of the depth of the leaf reached, from KP1's leaf mode (in
    chunks of 2^18 rows)."""
    import torch
    from lightgbm_tpu_torch.ops import predict as pr
    from lightgbm_tpu_torch.ops.predict_kernel import predict_ensemble
    visits = 0
    for a in range(0, Xd.shape[0], 1 << 18):
        xs = Xd[a:a + (1 << 18)]
        leaf = torch.empty((xs.shape[0], T), dtype=torch.int32,
                           device=Xd.device)
        predict_ensemble(tb, xs, T, 1, leaf, mode=pr.MODE_LEAF)
        visits += sum(int(depths[t][leaf[:, t].long()].sum())
                      for t in range(T))
    return visits


def host_split(Xs, Xd, out, dt) -> dict:
    """Where predict's host time goes, each step alone, in ms: the
    conversion of the f32 rows to dt (none for f32), their copy into
    pinned staging of dt (host clock), the copy over PCIe (CUDA events)
    and the output's fetch to numpy (host clock)."""
    import torch
    t = time.perf_counter()
    Xn = np.ascontiguousarray(Xs, dt)
    convert = (time.perf_counter() - t) * 1e3 if dt != np.float32 else 0.0
    pinned = torch.empty(Xn.shape, dtype=Xd.dtype, pin_memory=True)
    pinned.numpy()[:] = Xn
    t = time.perf_counter()
    pinned.numpy()[:] = Xn
    staging = (time.perf_counter() - t) * 1e3
    pcie = cuda_ms(lambda: Xd.copy_(pinned, non_blocking=True), 3)
    torch.cuda.synchronize()
    t = time.perf_counter()
    out.cpu().numpy()
    fetch = (time.perf_counter() - t) * 1e3
    return dict(convert=convert, staging=staging, pcie=pcie, output=fetch)


def small_phase(tb, T: int, F: int, Xh, table_bytes: int, dev) -> dict:
    """KP1's small-batch walk at the 1000-row bucket's 1024 rows (f32):
    against its plain version on the card, bit for bit, and timed."""
    import torch
    from lightgbm_tpu_torch.ops import predict as pr
    from lightgbm_tpu_torch.ops.predict_kernel import predict_ensemble
    n = min(1024, len(Xh))
    Xd = torch.from_numpy(np.ascontiguousarray(Xh[:n], np.float32)).to(dev)
    out = torch.empty((1, n), dtype=torch.float64, device=dev)

    def run():
        predict_ensemble(tb, Xd, T, 1, out, small=True)
    run()
    plain, plain_ms = cuda_call_ms(lambda: pr.ordered_sum_plain(
        pr.tree_values_plain(tb, Xd, T), 1))
    expect(torch.equal(out, plain), "KP1 small-batch walk: sums differ from "
           "the plain version's")
    nbytes = ensemble_bytes(n, F, 4, table_bytes)
    return dict(rows=n, ms=cuda_ms(run, 20),
                kernel_only_ms=kernel_only_ms(run, 20), plain_ms=plain_ms,
                bytes=nbytes, bound_ms=bound(nbytes, 0)[0])


# the serving phase (serving_phase): the server on the card over the
# prediction run's model, every batch on KP1 (the device-work floor at one
# row-tree; the JAX package's default of 2^22 row-trees would send every
# batch under 83,886 rows of a 50-tree model to the host walk)
SERVE_PARAMS = dict(serve_port=0, serve_max_batch_rows=256,
                    serve_batch_wait_ms=2.0, serve_min_device_work=1,
                    serve_queue_rows=1 << 18,
                    serve_request_timeout_ms=60_000.0, verbosity=-1)
SERVE_MODEL = "higgs"
SERVE_SIZES = (1, 2, 7, 16, 64, 200)
SERVE_CLIENTS = 8
SERVE_REQUESTS = 50
SERVE_BIG = 100_000
# the traffic's rows: slices of the holdout's first SERVE_REGION rows
SERVE_REGION = 20_000
SERVE_SWAP_CLIENTS = 4
SERVE_SHADOW_REQUESTS = 20
# tenants of the fleet check: the training phase's models (5 rounds)
FLEET_TENANTS = ("f32", "quantized", "weighted_f32")
# the caching allocator rounds each block up to 512 bytes: a released
# tenant's tables (six tensors) return within this of the bytes before
ALLOC_ROUNDING = 512 * 6 * len(FLEET_TENANTS)
WAIT_S = 60.0


def _threads(target, jobs) -> None:
    """Run target(i, job) for each job on its own thread; every thread
    joined within WAIT_S."""
    import threading
    threads = [threading.Thread(target=target, args=(i, j))
               for i, j in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    expect(not any(t.is_alive() for t in threads),
           "serving: a client thread did not end within %.0f s" % WAIT_S)


def _http_get(port: int, path: str) -> str:
    import urllib.request
    with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                timeout=WAIT_S) as resp:
        expect(resp.status == 200, "GET %s: HTTP %d" % (path, resp.status))
        return resp.read().decode()


def _metric(text: str, line_start: str) -> float:
    """The value of the exposition line that starts with line_start."""
    for line in text.splitlines():
        if line.startswith(line_start + " "):
            return float(line.rsplit(" ", 1)[1])
    raise Failure("metrics: no line %s" % line_start)


def _stats(srv) -> dict:
    return srv.stats_snapshot()["models"][SERVE_MODEL]


def serving_traffic(srv, port, Xh, want, raw_want) -> dict:
    """SERVE_CLIENTS threads of SERVE_REQUESTS requests each, of sizes
    drawn from SERVE_SIZES over the first SERVE_REGION holdout rows, half
    over HTTP through ServingClient, half through Server.predict, and one
    request of SERVE_BIG rows alone: each response bit for bit `want`'s
    rows.  The launch counters are zeroed just before and read just
    after: one KP1 launch a device batch (the small-batch walk, the big
    request's row tiles), no build, no host batch, no breaker failure.
    Returns the latencies by path and size, the counts and the stats."""
    from lightgbm_tpu_torch.obs import device as obs_device
    from lightgbm_tpu_torch.ops import _cuda
    from lightgbm_tpu_torch.serving import ServingClient
    rng = np.random.RandomState(61)
    jobs = []
    for _ in range(SERVE_CLIENTS):
        sizes = rng.choice(SERVE_SIZES, SERVE_REQUESTS)
        jobs.append([(int(rng.randint(0, SERVE_REGION - n + 1)), int(n))
                     for n in sizes])
    jobs.append([(0, SERVE_BIG)])
    lat, bad = {}, []
    before = _stats(srv)
    builds = (obs_device.compile_counts(), _cuda.BUILD_LOG.get("seconds"))

    def client(i, mine):
        http = i < SERVE_CLIENTS // 2
        c = ServingClient(port=port, timeout=WAIT_S) if http else None
        for a, n in mine:
            X = Xh[a:a + n]
            t = time.perf_counter()
            got = c.predict(X, model=SERVE_MODEL) if http else srv.predict(
                X, model=SERVE_MODEL)
            ms = (time.perf_counter() - t) * 1e3
            lat.setdefault(("http" if http else "in_process", n),
                           []).append(ms)
            if not np.array_equal(got, want[a:a + n]):
                bad.append((i, a, n))

    _cuda.reset_launch_counts()
    t = time.perf_counter()
    _threads(client, jobs)
    wall = time.perf_counter() - t
    counts = dict(_cuda.LAUNCHES)
    after = _stats(srv)
    expect(not bad, "serving: %d responses differ from the host walk's "
           "(client, first row, rows: %s)" % (len(bad), bad[:5]))
    delta = {k: after[k] - before[k] for k in (
        "requests", "rows", "batches", "device_batches", "host_batches",
        "host_fallback", "breaker_batches", "errors", "timeouts", "shed",
        "rejected_queue_full")}
    small = counts.get("predict_ensemble_small", 0)
    tiles = counts.get("predict_ensemble", 0)
    expect(delta["requests"] == SERVE_CLIENTS * SERVE_REQUESTS + 1
           and delta["device_batches"] == delta["batches"] > 0
           and not any(delta[k] for k in (
               "host_batches", "host_fallback", "breaker_batches", "errors",
               "timeouts", "shed", "rejected_queue_full"))
           and after["breaker"]["consecutive_failures"] == 0
           and after["breaker"]["open_count"] == 0,
           "serving: counts %s, breaker %s" % (delta, after["breaker"]))
    expect(tiles == 1 and small + tiles == delta["device_batches"]
           and sum(counts.values()) == small + tiles,
           "serving: launches %s for %d device batches (one a batch, the "
           "%d-row request by row tiles)" % (counts, delta["device_batches"],
                                             SERVE_BIG))
    expect((obs_device.compile_counts(), _cuda.BUILD_LOG.get("seconds"))
           == builds, "serving: a kernel was built during the traffic")
    # raw scores through the entry, on KP1, off the counted run
    entry = srv.registry.get(SERVE_MODEL)
    for n in SERVE_SIZES + (256, SERVE_BIG):
        raw, on_card = entry.predict(Xh[:n], raw_score=True)
        expect(on_card and np.array_equal(raw, raw_want[:n]),
               "serving: raw scores of %d rows differ from the host walk's"
               % n)
    pct = {"%s_%d" % key: dict(n=len(v), p50=float(np.percentile(v, 50)),
                               p99=float(np.percentile(v, 99)))
           for key, v in sorted(lat.items())}
    print("serving traffic: %d requests (%d clients x %d, sizes %s, half "
          "over HTTP; one of %d rows) in %.2f s: %d device batches (%.2f "
          "rows a batch of the small ones), KP1 launches %d small-batch + "
          "%d row tiles, 0 host batches, 0 host fallbacks, 0 breaker "
          "failures, no build; every response (and the raw scores through "
          "the entry) bit for bit the host walk's"
          % (delta["requests"], SERVE_CLIENTS, SERVE_REQUESTS,
             list(SERVE_SIZES), SERVE_BIG, wall, delta["device_batches"],
             (delta["rows"] - SERVE_BIG) / max(small, 1), small, tiles))
    print("serving latency, ms on the host clock, p50 / p99 (requests): %s"
          % "; ".join("%s %.3f / %.3f (%d)" % (k, v["p50"], v["p99"],
                                               v["n"])
                      for k, v in pct.items()))
    return dict(wall_s=wall, latency_ms=pct, launches=counts, counts=delta,
                small_launches=small, tile_launches=tiles)


def serving_swap(srv, Xh, want1, want2) -> dict:
    """Hot swap and rollback under traffic: SERVE_SWAP_CLIENTS threads
    keep sending while v2 loads under the same name; every response is
    wholly v1's or wholly v2's (host walks), both are seen, and after
    the rollback v1's answers come back bit for bit."""
    import threading
    rng = np.random.RandomState(67)
    stop = threading.Event()
    seen = {"v1": 0, "v2": 0}
    bad = []
    lock = threading.Lock()

    def client(i, _):
        r = np.random.RandomState(71 + i)
        while not stop.is_set():
            n = int(r.choice((16, 64)))
            a = int(r.randint(0, SERVE_REGION - n + 1))
            got = srv.predict(Xh[a:a + n], model=SERVE_MODEL)
            with lock:
                if np.array_equal(got, want1[a:a + n]):
                    seen["v1"] += 1
                elif np.array_equal(got, want2[a:a + n]):
                    seen["v2"] += 1
                else:
                    bad.append((a, n))

    threads = [threading.Thread(target=client, args=(i, None))
               for i in range(SERVE_SWAP_CLIENTS)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.3)
        t = time.perf_counter()
        e2 = srv.load_model(SERVE_MODEL, model_str=TRAINED["f32"][1])
        swap_s = time.perf_counter() - t
        time.sleep(0.3)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=WAIT_S)
    expect(not any(t.is_alive() for t in threads),
           "serving swap: a client did not end")
    expect(not bad and seen["v1"] > 0 and seen["v2"] > 0 and e2.version == 2,
           "serving swap: %d mixed responses, seen %s, version %d"
           % (len(bad), seen, e2.version))
    a = int(rng.randint(0, SERVE_REGION - 64))
    expect(np.array_equal(srv.predict(Xh[a:a + 64], model=SERVE_MODEL),
                          want2[a:a + 64]), "serving swap: v2 not served")
    e3 = srv.registry.rollback(SERVE_MODEL)
    got = srv.predict(Xh[:SERVE_REGION // 4], model=SERVE_MODEL)
    expect(e3.version == 3 and np.array_equal(got, want1[:SERVE_REGION // 4]),
           "serving rollback: version %d, v1's answers %s"
           % (e3.version, np.array_equal(got, want1[:SERVE_REGION // 4])))
    print("serving hot swap: v2 (the training phase's 5-round f32 model) "
          "loaded and warmed in %.3f s under %d clients, %d responses "
          "wholly v1's and %d wholly v2's, none mixed; rollback to v1 "
          "(version %d) answers v1's bit for bit"
          % (swap_s, SERVE_SWAP_CLIENTS, seen["v1"], seen["v2"], e3.version))
    return dict(swap_s=swap_s, seen=seen, versions=[2, e3.version])


def serving_shadow(srv, Xh, want1, want2) -> dict:
    """The shadow mirror: v2 (a host booster) mirrors the served batches;
    the served answers stay v1's, and the mirror's mean |v2 - v1| over
    the rows it saw equals the host walks' within 1e-12."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.serving import ShadowMirror
    mirror = ShadowMirror(SERVE_MODEL, lt.Booster(
        model_str=TRAINED["f32"][1], device="cpu"))
    srv.attach_shadow(SERVE_MODEL, mirror)
    rows = []
    try:
        for i in range(SERVE_SHADOW_REQUESTS):
            a = i * 64
            got = srv.predict(Xh[a:a + 64], model=SERVE_MODEL)
            expect(np.array_equal(got, want1[a:a + 64]),
                   "serving shadow: a served answer changed")
            rows.append(np.arange(a, a + 64))
        expect(mirror.drain(WAIT_S), "serving shadow: the mirror did not "
               "drain")
        snap = mirror.snapshot()
    finally:
        srv.detach_shadow(SERVE_MODEL)
    idx = np.concatenate(rows)
    delta = np.abs(want2[idx] - want1[idx])
    expect(snap["rows"] == len(idx) and snap["errors"] == 0
           and snap["dropped_rows"] == 0
           and abs(snap["mean_abs_delta"] - delta.mean()) <= 1e-12
           and snap["max_abs_delta"] == delta.max(),
           "serving shadow: %s against mean %.6g max %.6g"
           % (snap, delta.mean(), delta.max()))
    print("serving shadow: %d rows mirrored onto v2, mean |v2 - v1| %.6g, "
          "max %.6g (the host walks'), served answers unchanged"
          % (snap["rows"], snap["mean_abs_delta"], snap["max_abs_delta"]))
    return snap


def serving_endpoints(srv, port) -> dict:
    """/healthz, /models and /metrics over HTTP: the model, its version,
    the request counters and the card's device gauges."""
    health = json.loads(_http_get(port, "/healthz"))
    models = json.loads(_http_get(port, "/models"))["models"]
    text = _http_get(port, "/metrics")
    stats = _stats(srv)
    label = '{model="%s"}' % SERVE_MODEL
    requests = _metric(text, "lgbm_serve_requests_total" + label)
    device = _metric(text, 'lgbm_serve_batches_total{model="%s",path="device"}'
                     % SERVE_MODEL)
    live = _metric(text, "lgbm_device_live_bytes")
    compiles = _metric(text, "lgbm_xla_backend_compiles_total")
    expect(health["status"] == "ok" and SERVE_MODEL in health["models"]
           and models[SERVE_MODEL]["version"] == 3
           and models[SERVE_MODEL]["device_eligible"]
           and requests == stats["requests"]
           and device == stats["device_batches"] and live > 0
           and "lgbm_xla_traces_total" not in text,
           "serving endpoints: health %s, models %s, requests %s, device "
           "batches %s, live bytes %s" % (health, models, requests, device,
                                          live))
    print("serving endpoints: /healthz ok, /models v%d, /metrics: %d "
          "requests, %d device batches, %d live device bytes, %d kernel "
          "sources compiled" % (models[SERVE_MODEL]["version"], requests,
                                device, live, compiles))
    return dict(requests=requests, device_batches=device, live_bytes=live,
                compiles=compiles)


def serving_fleet(Xh, dev) -> dict:
    """Fleet residency on the card: a budget of two and a half of the
    largest FLEET_TENANTS estimate holds two; the byte ledger equals the
    resident ensembles' device_bytes() exactly and the allocator's bytes
    grow by it (within its rounding); loading the third spills the least
    recently used, which then answers at once on the host walk, bit for
    bit, and is promoted; after the release of every tenant the
    allocator's bytes fall back within its rounding."""
    import gc
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.obs import default_registry
    from lightgbm_tpu_torch.ops import predict as pr
    from lightgbm_tpu_torch.serving import Server
    texts = [TRAINED[p][1] for p in FLEET_TENANTS]
    hosts = [lt.Booster(model_str=t, device="cpu") for t in texts]
    ests = [pr.estimate_device_bytes(h._gbdt.models, 1) for h in hosts]
    budget = int(2.5 * max(ests))
    X = Xh[:64].astype(np.float64)
    wants = [h.predict(X, device=False) for h in hosts]
    names = ["tenant_%s" % p for p in FLEET_TENANTS]
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    srv = Server(dict(SERVE_PARAMS, serve_max_models=8,
                      tpu_fleet_hbm_budget_mb=budget / float(1 << 20)),
                 device=dev)
    fleet = srv.fleet

    def ledger():
        with fleet._lock:
            recs = [r for r in fleet._records.values() if r.state == "resident"]
            return fleet.resident_bytes, sum(r.ens.device_bytes()
                                             for r in recs)
    try:
        for name, text in zip(names[:2], texts[:2]):
            srv.load_model(name, model_str=text)
        accounted, built = ledger()
        torch.cuda.synchronize()
        grew = torch.cuda.memory_allocated(dev) - base
        expect(fleet.state_counts()["resident"] == 2
               and accounted == built == ests[0] + ests[1]
               and 0 <= grew - built <= ALLOC_ROUNDING,
               "fleet: 2 tenants: ledger %d, built %d, estimates %s, "
               "allocator +%d" % (accounted, built, ests[:2], grew))
        srv.predict(X, model=names[1])          # names[0] becomes LRU
        srv.load_model(names[2], model_str=texts[2])
        accounted3, built3 = ledger()
        expect(fleet.residency(names[0]) == "spilled"
               and fleet.residency(names[2]) == "resident"
               and accounted3 == built3 == ests[1] + ests[2]
               and fleet.peak_resident_bytes <= budget,
               "fleet: third load: %s, ledger %d, built %d"
               % (fleet.state_counts(), accounted3, built3))
        t = time.perf_counter()
        got = srv.predict(X, model=names[0])
        spilled_ms = (time.perf_counter() - t) * 1e3
        st = srv.stats_snapshot()["models"][names[0]]
        expect(np.array_equal(got, wants[0]) and st["host_batches"] == 1
               and st["device_batches"] == 0,
               "fleet: the spilled tenant's answer: equal %s, stats %s"
               % (np.array_equal(got, wants[0]), st))
        deadline = time.monotonic() + WAIT_S
        while (fleet.residency(names[0]) != "resident"
               and time.monotonic() < deadline):
            time.sleep(0.01)
        promote_s = WAIT_S - (deadline - time.monotonic())
        got = srv.predict(X, model=names[0])
        st = srv.stats_snapshot()["models"][names[0]]
        accounted4, built4 = ledger()
        expect(fleet.residency(names[0]) == "resident"
               and np.array_equal(got, wants[0])
               and st["device_batches"] == 1 and accounted4 == built4
               and fleet.peak_resident_bytes <= budget,
               "fleet: promotion: %s, stats %s, ledger %d, built %d"
               % (fleet.state_counts(), st, accounted4, built4))
        snap = fleet.snapshot()
        for name in names:
            srv.evict_model(name)
    finally:
        srv.shutdown()
        for name in names:
            default_registry().remove(model=name)
    del srv, fleet
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated(dev) - base
    expect(abs(after) <= ALLOC_ROUNDING, "fleet: %d device bytes left after "
           "the release of every tenant" % after)
    print("serving fleet: budget %d bytes (2.5 x the largest of estimates "
          "%s) held 2 of 3 tenants, the ledger equal to their tables' "
          "device_bytes() (allocator +%d); the third spilled the LRU, which "
          "answered at once on the host walk (%.3f ms, bit for bit) and was "
          "promoted in %.3f s; %d evictions, %d promotions, warmup cache %s; "
          "after the release the allocator is %+d bytes from before"
          % (budget, ests, grew, spilled_ms, promote_s, snap["evictions"],
             snap["promotions"], snap["compile_cache"], after))
    return dict(budget=budget, estimates=ests, allocator_growth=grew,
                spilled_ms=spilled_ms, promote_s=promote_s,
                evictions=snap["evictions"], promotions=snap["promotions"],
                compile_cache=snap["compile_cache"], released=after)


def serving_buckets(g, Xh, dev) -> dict:
    """At each warm bucket: KP1 through predict_bucketed from numpy (f64
    rows as the server passes them: staging, copy, walk, fetch), the
    kernel alone (CUDA events, X on the card), and the host walk; host
    clock medians."""
    import torch
    from lightgbm_tpu_torch.ops.predict import pow2_buckets
    from lightgbm_tpu_torch.ops.predict_kernel import predict_ensemble
    ens = g._device_ensemble()
    tb, T = ens.tables, len(g.models)
    out = {}
    for b in pow2_buckets(SERVE_PARAMS["serve_max_batch_rows"]):
        X = np.ascontiguousarray(Xh[:b], np.float64)
        ms = []
        for _ in range(21):
            t = time.perf_counter()
            g.predict_bucketed(X, raw_score=True)
            ms.append((time.perf_counter() - t) * 1e3)
        Xd = torch.from_numpy(X).to(dev)
        o = torch.empty((1, b), dtype=torch.float64, device=dev)
        kernel = cuda_ms(lambda: predict_ensemble(tb, Xd, T, 1, o), 20)
        host = []
        for _ in range(5):
            t = time.perf_counter()
            g.predict(X, raw_score=True, device=False)
            host.append((time.perf_counter() - t) * 1e3)
        out[b] = dict(kp1_ms=float(np.median(ms)), kernel_ms=kernel,
                      host_walk_ms=float(np.median(host)))
    print("serving buckets, ms (KP1 from numpy, median of 21 / the kernel, "
          "CUDA events / the host walk, median of 5): %s"
          % "; ".join("%d rows %.4f / %.4f / %.4f" % (
              b, r["kp1_ms"], r["kernel_ms"], r["host_walk_ms"])
              for b, r in out.items()))
    return out


def serving_phase(Xh, dev, results) -> dict:
    """The port's server on the card (lightgbm_tpu_torch.serving.Server,
    port 0, batches of up to 256 rows after at most 2 ms, every batch on
    KP1) over the prediction run's model: its warmup launches each bucket
    once; the traffic (serving_traffic); hot swap and rollback
    (serving_swap); the shadow mirror (serving_shadow); the endpoints
    (serving_endpoints); KP1 and the host walk at each bucket
    (serving_buckets); fleet residency (serving_fleet).  Every served
    answer is checked against booster.predict(rows, device=False) of its
    model, bit for bit (the holdout's host walk of the prediction phase,
    through the objective's link; checked equal on 2,000 rows here)."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.obs import default_registry
    from lightgbm_tpu_torch.ops import _cuda
    from lightgbm_tpu_torch.ops.predict import pow2_buckets
    from lightgbm_tpu_torch.serving import Server
    v1 = TRAINED["prediction"][1]
    host1 = lt.Booster(model_str=v1, device="cpu")
    host2 = lt.Booster(model_str=TRAINED["f32"][1], device="cpu")
    raw1 = HOLDOUT_HOST["raw"]
    want1 = host1._gbdt._convert_output(raw1.copy(), False)
    expect(np.array_equal(want1[:2000], host1.predict(Xh[:2000],
                                                      device=False)),
           "serving: the holdout's host walk is not predict(device=False)'s")
    want2 = host2.predict(Xh[:SERVE_REGION], device=False)
    srv = Server(dict(SERVE_PARAMS), device=dev)
    try:
        _cuda.reset_launch_counts()
        t = time.perf_counter()
        entry = srv.load_model(SERVE_MODEL, model_str=v1)
        load_s = time.perf_counter() - t
        warm = entry.warmed_buckets
        counts = dict(_cuda.LAUNCHES)
        expect(warm == pow2_buckets(SERVE_PARAMS["serve_max_batch_rows"])
               and counts == {"predict_ensemble_small": len(warm)},
               "serving warmup: buckets %s, launches %s" % (warm, counts))
        print("serving: %s loaded onto %s in %.3f s (%d trees), warmup "
              "launched KP1's small-batch walk once at each bucket %s"
              % (SERVE_MODEL, dev, load_s, entry.num_trees, warm))
        httpd = srv.serve_http(block=False)
        port = httpd.server_address[1]
        traffic = serving_traffic(srv, port, Xh, want1, raw1)
        buckets = serving_buckets(entry.booster._gbdt, Xh, dev)
        swap = serving_swap(srv, Xh, want1, want2)
        shadow = serving_shadow(srv, Xh, want1, want2)
        endpoints = serving_endpoints(srv, port)
    finally:
        srv.shutdown()
        default_registry().remove(model=SERVE_MODEL)
    fleet = serving_fleet(Xh, dev)
    r = results["predict_ensemble_small"]
    r["serving_launches"] = traffic["small_launches"]
    r["serving_bucket_ms"] = buckets
    results["predict_ensemble"]["serving_launches"] = traffic["tile_launches"]
    return dict(load_s=load_s, warm=warm, traffic=traffic, buckets=buckets,
                swap=swap, shadow=shadow, endpoints=endpoints, fleet=fleet)


def kp2_phase(booster, dev, results):
    """KP2 on the last round of a bagged run: its 255-leaf device tree, its
    bag's K4 leaf ids (-1 out of the bag) and the dataset's row-major bins
    at the full row count.  Leaf mode against the plain walk, the masked
    add (the round's score update) and the add mode (a validation set's)
    against the plain adds, bit for bit; timed by CUDA events and
    kernel-only beside the bound and the plain version."""
    import torch
    from lightgbm_tpu_torch.ops.grow import TreeArrays
    from lightgbm_tpu_torch.ops.predict_kernel import (walk_binned,
                                                       walk_binned_plain)

    g = booster._gbdt
    (graph,) = g._graphs.graphs.values()
    outs = [t.clone() for t in graph.outputs]
    ids, tree = outs[1], TreeArrays(*outs[2:])
    nl = int(tree.num_leaves)
    bins = g.train_set.device_bins(dev)
    n, G = bins.shape
    in_bag = int((ids >= 0).sum())
    expect(nl == LEAVES and in_bag == g._bag_count,
           "KP2: the tree has %d leaves, %d rows in its bag of %d"
           % (nl, in_bag, g._bag_count))
    nb, db = g.num_bins, g.default_bins
    got = walk_binned(bins, tree, nb, db)
    want = walk_binned_plain(bins, tree, nb, db)
    expect(torch.equal(got, want), "KP2 leaf mode: leaves differ")
    expect(torch.equal(got[ids >= 0], ids[ids >= 0]),
           "KP2 leaf mode: a row of the bag walks to another leaf than K4's")
    lv = tree.leaf_value * g._shrink_dev
    score0 = torch.randn(n, generator=torch.Generator(device=dev)
                         .manual_seed(9), device=dev)
    r = {}
    for mode, kw in (("masked_add", dict(leaf_ids=ids)), ("add", {}),
                     ("leaf", None)):
        if kw is None:
            run = lambda: walk_binned(bins, tree, nb, db)
            plain = lambda: walk_binned_plain(bins, tree, nb, db)
        else:
            sk_, sp_ = score0.clone(), score0.clone()
            walk_binned(bins, tree, nb, db, lv=lv, score=sk_, **kw)
            walk_binned_plain(bins, tree, nb, db, lv=lv, score=sp_, **kw)
            expect(torch.equal(sk_.view(torch.int32), sp_.view(torch.int32)),
                   "KP2 %s: scores differ" % mode)
            run = lambda: walk_binned(bins, tree, nb, db, lv=lv, score=sk_,
                                      **kw)
            plain = lambda: walk_binned_plain(bins, tree, nb, db, lv=lv,
                                              score=sp_, **kw)
        walked = ids < 0 if mode == "masked_add" else torch.ones_like(
            ids, dtype=torch.bool)
        nbytes = walk_binned_bytes(walked, G, tree.split_feature.shape[0],
                                   nl, mode)
        r[mode] = dict(ms=cuda_ms(run, 10), kernel_ms=kernel_only_ms(run, 10),
                       plain_ms=cuda_ms(plain, 1, warmup=0), bytes=nbytes,
                       bound_ms=bound(nbytes, 0)[0])
    per_round = int(graph.launches.get(WALK_MASKED, 0))
    print("KP2 walk_binned: %d rows x %d features, a %d-leaf tree of the "
          "bagged run, %d rows in its bag; %s; a bagged round launches it "
          "%d time(s); exact" % (n, G, nl, in_bag, "; ".join(
              "%s %.4f ms, kernel-only %s (bound %.4f, plain %.3f)" % (
                  m, v["ms"], profiled(v["kernel_ms"]), v["bound_ms"],
                  v["plain_ms"])
              for m, v in r.items()), per_round))
    for name, mode in ((WALK_MASKED, "masked_add"), (WALK_ADD, "add")):
        v = r[mode]
        results[name] = dict(
            name=name, route="cuda", source=SRC % "walk_binned",
            replaces=REPLACES["walk_binned"], port_only=True, mode=mode,
            launches=0, max_abs_err=0.0, tolerance="bit for bit",
            ms=v["ms"], kernel_ms=v["kernel_ms"], plain_ms=v["plain_ms"],
            bound_ms=v["bound_ms"], bound_by="bytes", library_ms=None,
            library="none: no single PyTorch call walks a tree", rows=n,
            leaves=nl, in_bag=in_bag, launches_a_bagged_round=per_round,
            leaf_mode=r["leaf"] if mode == "masked_add" else None)
    del outs, ids, tree, score0
    torch.cuda.empty_cache()


# bench.py's second headline workload, lambdarank on MSLR-WEB30K's shape
# (bench.py:192-275; the reference's experiment, docs/Experiments.rst:110,
# 137-144): 18,900 queries of 120 documents x 137 features, 63 leaves
RANK_QUERIES = 18_900
RANK_DOCS = 120
RANK_FEATURES = 137
# bins found from 50,000 sampled rows, not the default 200,000: the host's
# greedy bin walk over 137 features of near-distinct values took 98.8 s of
# the lambdarank phase (its `steps, s:` binning, on the NVIDIA H100 80GB
# HBM3 machine, 700.00 W), and its time goes with the sample
RANK_PARAMS = {"objective": "lambdarank", "metric": "ndcg", "num_leaves": 63,
               "learning_rate": 0.1, "min_data_in_leaf": 20, "max_bin": 255,
               "bin_construct_sample_cnt": 50_000, "verbose": -1}
# 1,000 more queries of the generator (seed 12, relevance by the training
# draw's utility weights) as the validation set
RANK_VALID_QUERIES = 1_000
# training NDCG@10 after 5 rounds (constant scores: about 0.11)
NDCG_FLOOR = 0.70
# the parity run: about 20k rows of the generator
RANK_PARITY_QUERIES = 167
# the pointwise objectives on the smoke's Higgs data, cut to 1M rows
OBJECTIVE_ROWS = 1_000_000
OBJECTIVE_RUNS = ("regression_l1", "huber", "poisson", "xentropy")
# the lambdarank and pointwise fused paths: the pristine root by K2, K3
# and K1 a split, K4's add mode the score update; the refitting L1 runs
# the eager path (K4's set mode for its leaf ids); a validation set adds
# KP2's add mode
TRAINING_KERNELS = ("segment_histogram", "segment_histogram_i8",
                    "partition_segment", "partition_segment_i8",
                    "partition_segment_pred", "partition_segment_pred_i8",
                    "scatter_segments", "scatter_segments_add",
                    "fused_root_histogram", "compact_carry",
                    "compact_carry_i8", "leaf_histogram",
                    "leaf_histogram_i8", "split_scan") + WALKS


def pristine_kernels(k4: str, *extra) -> tuple:
    """(kernels a pristine-root f32 run must launch, every other training
    or prediction kernel)."""
    must = ("segment_histogram", "partition_segment", "split_scan", k4) + extra
    return must, tuple(k for k in TRAINING_KERNELS + PREDICT_KERNELS
                       if k not in must)


@timed("data")
def mslr_like(n_query: int, seed: int = 11, w=None):
    """Copied from bench.py:197-222 (bench_lambdarank's generator): X [n,
    137] f32, graded relevance 0-4 from each query's ranking of a sparse
    linear utility, and the query sizes; then the utility's weights.  With
    `w`, more queries ranked by those weights (a draw with its own weights
    would rank by another utility, which no model of the first can
    learn)."""
    docs_per_q = RANK_DOCS
    F = RANK_FEATURES
    n = n_query * docs_per_q
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    w_own = np.zeros(F)
    w_own[:10] = rng.randn(10)
    w = w_own if w is None else w
    util = X @ w + 0.3 * rng.randn(n)
    labels = np.zeros(n, np.float32)
    u2 = util.reshape(n_query, docs_per_q)
    order = np.argsort(-u2, axis=1)
    grades = [(2, 4), (6, 3), (15, 2), (40, 1)]   # top-k cutoffs -> grade
    for qi in range(n_query):
        prev = 0
        lab_row = labels[qi * docs_per_q:(qi + 1) * docs_per_q]
        for cut, g in grades:
            lab_row[order[qi, prev:cut]] = g
            prev = cut
    group = np.full(n_query, docs_per_q)
    return X, labels, group, w


def ndcg_at(k: int, y, group, score) -> float:
    """NDCG@k of a score by the port's metric (f32, on the score's device)."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.io.metadata import Metadata
    from lightgbm_tpu_torch.metric import create_metric
    meta = Metadata(len(y))
    meta.set_label(y)
    meta.set_query(group)
    m = create_metric("ndcg", lt.Config({"eval_at": [k]}))
    m.init(meta, len(y))
    return m.eval(score)[0]


def k2_width_phase(ds, dev, results, shape_of: str):
    """K2 f32 at a dataset's width (its G columns: a feature each, or
    EFB groups) at the root and on a 40k-row child,
    against its plain version on the same inputs and timed beside its
    bound and index_add_; its entry goes to the kernels line as
    segment_histogram_g<G>, its launches counted later in the `shape_of`
    run.  Returns the two histograms' results."""
    import torch
    from lightgbm_tpu_torch.ops import partition_kernel as pk

    n, G = ds.num_data, ds.num_groups
    B = ds.hist_max_bin()
    gen = torch.Generator(device=dev).manual_seed(17)
    a = pk.Arena(n, G, 4, dev)
    pk.init_pristine(a, ds.device_bins(dev).t())
    a.payload[0, :n] = torch.randn(n, generator=gen, device=dev)
    a.payload[1, :n] = torch.rand(n, generator=gen, device=dev) * 0.25 + 0.01
    segs = {"root": (0, n), "child": (98_765, CHILD_ROWS)}
    k2 = {}
    for what, (s, c) in segs.items():
        seg = torch.tensor([s, c], dtype=torch.int32, device=dev)
        got = pk.segment_histogram(a, seg, B)
        want = pk.segment_histogram_plain(a, seg, B)
        keep = a.payload[0, s:s + c].clone()
        a.payload[0, s:s + c] = keep.abs()
        scale = pk.segment_histogram_plain(a, seg, B)
        a.payload[0, s:s + c] = keep
        expect(torch.equal(got[..., 2], want[..., 2]),
               "K2 at G=%d %s: counts differ" % (G, what))
        err_t = (got - want).abs()
        rel = float((err_t / scale.clamp_min(1e-30)).max())
        expect(rel <= 1e-5, "K2 at G=%d %s: error %.3g of the |value| sums "
               "exceeds rtol 1e-5" % (G, what, rel))
        nbytes = pk.segment_histogram_bytes(c, G, B)
        k2[what] = dict(
            max_abs_err=float(err_t.max()), rel_err=rel, hist=got, rows=c,
            ms=cuda_ms(lambda: pk.segment_histogram(a, seg, B), 20),
            kernel_ms=kernel_only_ms(lambda: pk.segment_histogram(a, seg, B),
                                     20),
            plain_ms=cuda_ms(lambda: pk.segment_histogram_plain(a, seg, B), 3),
            library_ms=index_add_ms(a, s, c, B),
            bound=bound(nbytes, 3 * G * c))
    r, c = k2["root"], k2["child"]
    print("K2 segment_histogram (f32) at the %s width G=%d B=%d: "
          "root %d rows %.4f ms, kernel-only %s (bound %.4f, plain %.4f, "
          "index_add_ %.4f); child %d rows %.4f ms, kernel-only %s (bound "
          "%.5f, plain %.4f, index_add_ %.4f); rel err %.3g"
          % (shape_of, G, B, n, r["ms"], profiled(r["kernel_ms"]),
             r["bound"][0], r["plain_ms"], r["library_ms"], c["rows"],
             c["ms"], profiled(c["kernel_ms"]), c["bound"][0], c["plain_ms"],
             c["library_ms"], max(r["rel_err"], c["rel_err"])))
    name = "segment_histogram_g%d" % G
    results[name] = dict(
        route="cuda", mode="f32", launches=0, shape_of=shape_of, name=name,
        source=SRC % "segment_histogram",
        replaces=REPLACES["segment_histogram"],
        max_abs_err=max(r["max_abs_err"], c["max_abs_err"]),
        tolerance="counts equal; g/h within 1e-5 of the bin's |value| sum",
        ms=r["ms"], kernel_ms=r["kernel_ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound"][0], bound_by=r["bound"][1],
        library_ms=r["library_ms"], library="index_add_ of every (feature, "
        "row) into the [G*B, 3] histogram", rows=n,
        shape="root %d rows, G=%d, B=%d" % (n, G, B),
        child=dict(rows=c["rows"], ms=c["ms"], kernel_ms=c["kernel_ms"],
                   plain_ms=c["plain_ms"], bound_ms=c["bound"][0],
                   library_ms=c["library_ms"]))
    del a
    torch.cuda.empty_cache()
    return k2


# the boosting-modes phase on the training phase's Higgs dataset: run ->
# (settings over PARAMS, rounds).  GOSS at learning_rate 0.1: 10 warm-up
# rounds of every row, then 3 sampled ones; RF over the smoke's bag; DART
# at its defaults (drop_rate 0.1, skip_drop 0.5, max_drop 50), whose drop
# stream (drop_seed 4) drops trees in rounds 4, 6, 7, 8 and 12
LABEL = dict(tpu_tree_engine="label", tpu_histogram_impl="pallas")
BOOST_RUNS = {
    "goss_f32": (dict(boosting="goss"), 13),
    "goss_quantized": (dict(boosting="goss", tpu_quantized_grad=True), 13),
    "goss_valid_f32": (dict(boosting="goss", metric="auc"), 13),
    "goss_label_f32": (dict(LABEL, boosting="goss"), 13),
    "rf_f32": (dict(BAGGING, boosting="rf"), 5),
    "dart_f32": (dict(boosting="dart"), 12),
}
SCORE_ROWS = 100_000


def boost_kernels(name: str) -> tuple:
    """(kernels a boosting-modes run must launch, every other training or
    prediction kernel).  GOSS's warm-up rounds grow over every row (K4's
    add mode; K5 at a quantized root), its sampled rounds over the sample
    as over a bag (K3's pred mode at the root, K4's set mode, KP2's masked
    add); the label engine grows with K7 and K1, KP2's masked add in the
    sampled rounds; the valid-set run's fetched trees reach the training
    score by K4's add mode (warm-up) and its validation score by KP2's add
    mode; RF grows every tree over its bag; DART grows over every row,
    its fetched trees and its drops reaching the score by K4's and KP2's
    add modes."""
    if "label" in name:
        must = ("leaf_histogram", "split_scan", WALK_MASKED)
    elif name.startswith("goss"):
        sfx = "_i8" if "quantized" in name else ""
        must = ("split_scan", "segment_histogram" + sfx,
                "partition_segment" + sfx, "partition_segment_pred" + sfx,
                "scatter_segments", "scatter_segments_add", WALK_MASKED)
        if sfx:
            must += ("fused_root_histogram",)
        if "valid" in name:
            must += (WALK_ADD,)
    elif name.startswith("rf"):
        must = ("split_scan", "segment_histogram", "partition_segment",
                "partition_segment_pred", "scatter_segments", WALK_MASKED)
    else:
        must = ("split_scan", "segment_histogram", "partition_segment",
                "scatter_segments_add", WALK_ADD)
    return must, tuple(k for k in TRAINING_KERNELS + PREDICT_KERNELS
                       if k not in must)


def goss_tie_round(booster) -> dict:
    """One more sampled GOSS round, its sample counted against the rows
    at or above the top_k-th largest |g*h| of the round's starting score,
    computed apart: the sample holds those rows and other_k more, so
    top_k + other_k where no row ties the threshold."""
    import torch
    g = booster._gbdt
    top_k, other_k = g._goss_counts
    grad, hess = g._gradients()
    score = (grad * hess).abs().sum(0)
    thr = torch.sort(score, descending=True).values[top_k - 1]
    tops = int((score >= thr).sum())
    booster.update()
    got = int(g._bag_pred.sum())
    expect(got == tops + other_k, "GOSS: %d rows in the sample, %d at or "
           "above the threshold and %d others" % (got, tops, other_k))
    return dict(in_sample=got, tied_past_top_k=tops - top_k)


def boosting_phase(X, Xh, yh, ds_obj, valid_obj, dev) -> tuple:
    """GOSS, RF and DART on the training phase's Higgs dataset through
    lightgbm_tpu_torch.train (train_and_check), BOOST_RUNS: the holdout's
    AUC at least AUC_FLOOR and KP1's sums bit for bit the host walk's;
    GOSS's sampled rounds hold at least top_k + other_k rows, exactly that
    many past ties at the threshold (goss_tie_round); the valid-set run's
    last evals_result equal to the host prediction's within 1e-6; RF's and
    DART's training scores equal to their models' prediction of the first
    SCORE_ROWS training rows within 1e-5 (the averaging, the drops and the
    normalization against the saved trees); each run's replayed round and
    a profiled one (GOSS's sampled, DART's with its drops where the drop
    stream draws them).  Returns (records by run, launches by run)."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.metric import auc

    ds_obj.set_weight(None)
    recs, launches = {}, {}
    for name, (extra, rounds) in BOOST_RUNS.items():
        goss = name.startswith("goss")
        valid = "valid" in name
        counts = []

        def count_sample(env):
            pred = env.model._gbdt._bag_pred
            if pred is not None:
                counts.append(pred.sum())
        kw, evals = dict(callbacks=[count_sample] if goss else None), {}
        if valid:
            kw.update(valid_sets=[valid_obj], valid_names=["holdout"],
                      evals_result=evals, verbose_eval=False)
        must, never = boost_kernels(name)
        booster, rec = train_and_check(
            name, dict(PARAMS, **extra), ds_obj, dev, rounds, must, never,
            deferred=goss and not valid, graphs=4 if goss else 1,
            replays=2 * rounds - 4 if goss else rounds - 1, **kw)
        g = booster._gbdt
        expect(type(g).__name__ == BOOSTING_CLASS[extra["boosting"]]
               and not g._carried_active
               and g._quantized is ("quantized" in name)
               and g._use_partition_engine is ("label" not in name),
               "%s: %s, carried %s, quantized %s, partition engine %s"
               % (name, type(g).__name__, g._carried_active, g._quantized,
                  g._use_partition_engine))
        raw = booster.predict(Xh, raw_score=True)
        host = booster.predict(Xh, raw_score=True, device=False)
        expect(np.array_equal(raw, host), "%s: KP1's holdout sums differ "
               "from the host walk's by up to %.3g"
               % (name, float(np.abs(raw - host).max())))
        holdout_auc = auc(yh, booster.predict(Xh))
        expect(holdout_auc >= AUC_FLOOR, "%s holdout AUC %.4f < %.2f"
               % (name, holdout_auc, AUC_FLOOR))
        extra_msg = ""
        if goss:
            top_k, other_k = g._goss_counts
            counts = [int(c) for c in counts]
            expect(len(counts) == rounds - 10
                   and min(counts) >= top_k + other_k,
                   "%s: in-sample rows %s of sampled rounds (top_k %d, "
                   "other_k %d)" % (name, counts, top_k, other_k))
            rec["sample"] = dict(top_k=top_k, other_k=other_k,
                                 in_sample=counts)
            rec["sample"].update(goss_tie_round(booster))
            extra_msg = ("; in-sample rows of the sampled rounds %s (top_k "
                         "%d + other_k %d); one more round: %d, %d rows "
                         "tied past top_k at the threshold"
                         % (counts, top_k, other_k,
                            rec["sample"]["in_sample"],
                            rec["sample"]["tied_past_top_k"]))
        if valid:
            last = evals["holdout"]["auc"][-1]
            expect(len(evals["holdout"]["auc"]) == rounds
                   and abs(last - holdout_auc) <= 1e-6,
                   "%s: last evals_result AUC %.8f, host predict AUC %.8f"
                   % (name, last, holdout_auc))
            extra_msg += "; evals_result holdout AUC %s" % [
                "%.6f" % v for v in evals["holdout"]["auc"]]
        if not goss:
            want = booster.predict(X[:SCORE_ROWS], raw_score=True)
            got = g.score[:SCORE_ROWS].cpu().numpy()
            err = float(np.abs(got - want).max())
            expect(err <= 1e-5, "%s: the training score is %.3g from the "
                   "model's prediction" % (name, err))
            rec["score_err"] = err
            extra_msg += ("; training score within %.3g of predict on %d "
                          "training rows" % (err, SCORE_ROWS))
        if name.startswith("dart"):
            extra_msg += "; tree weights %s" % ["%.5f" % w
                                                for w in g.tree_weight]
        rec["replay_round_ms"] = replayed_round_ms(booster, REPLAYED_ROUNDS)
        rec["profile"] = profile_round(booster, name,
                                       held=4 if goss else None)
        rec.update(holdout_auc=holdout_auc, evals_result=evals or None)
        print("boosting (%s): %d rows, %d rounds, leaves %s; train %.3f s "
              "(%.1f ms a round, set-up included); holdout AUC %.4f%s; "
              "graphs x nodes %s, capture and instantiate %s s; %d drains, "
              "%d tree fetches; %.1f ms a replayed round (%d more rounds); "
              "peak device memory %.3f GB; kernels launched %s"
              % (name, len(X), rounds, rec["leaves"], rec["train_s"],
                 rec["round_ms"], holdout_auc, extra_msg,
                 ["1 x %d" % x["nodes"] for x in rec["graphs"]],
                 ["%.3f" % x["capture_s"] for x in rec["graphs"]],
                 rec["drains"], rec["tree_fetches"], rec["replay_round_ms"],
                 REPLAYED_ROUNDS, rec["peak_bytes"] / 1e9,
                 {k: v for k, v in sorted(rec["launches"].items()) if v}))
        recs[name] = rec
        launches[name] = rec["launches"]
        del booster, g
        torch.cuda.empty_cache()
    return recs, launches


def rank_kernel_phase(ds, dev, results):
    """K2 f32 at the lambdarank widths (G = 137: five slabs, the last one
    partial, across several feature chunks) at the root and on a 40k-row
    child (k2_width_phase), and K1 at G = 137, B = 255 on both histograms,
    against its plain version on the same inputs and timed beside its
    bound."""
    import torch
    from lightgbm_tpu_torch.ops import split_kernel as sk
    from lightgbm_tpu_torch.ops.split import SplitParams

    G = ds.num_features
    B = int(ds.feature_num_bins().max())
    k2 = k2_width_phase(ds, dev, results, "lambdarank")
    hist2 = torch.stack([k2["root"]["hist"], k2["child"]["hist"]])
    nb = torch.as_tensor(ds.feature_num_bins(), device=dev)
    db = torch.as_tensor(np.array([m.default_bin for m in ds.bin_mappers],
                                  np.int32), device=dev)
    mt = torch.as_tensor(np.array([m.missing_type for m in ds.bin_mappers],
                                  np.int32), device=dev)
    fvec = sk.build_feature_statics(nb, db, mt, children=2)
    svec = sk.child_vector(hist2[:, 0, :, 0].sum(1), hist2[:, 0, :, 1].sum(1),
                           hist2[:, 0, :, 2].sum(1))
    pvec = sk.params_vector(SplitParams(min_data_in_leaf=20), dev)
    rows_k, best_k = sk.split_scan(hist2, fvec, svec, pvec)
    rows_p, best_p = sk.split_scan_plain(hist2, fvec, svec, pvec)
    lanes = [sk._OF, sk._OT, sk._ODL]
    valid = rows_p[:, sk._OG] > sk.NEG_GATE
    expect(torch.equal(rows_k[valid][:, lanes], rows_p[valid][:, lanes])
           and torch.equal(best_k[:, lanes], best_p[:, lanes]),
           "K1 at G=%d: feature, threshold or default_left differ" % G)
    gain_rel = float(((rows_k[:, sk._OG] - rows_p[:, sk._OG]).abs()
                      / rows_p[:, sk._OG].abs())[valid].max())
    expect(gain_rel <= 1e-5, "K1 at G=%d: gain rel err %.3g exceeds 1e-5"
           % (G, gain_rel))
    k1_bytes, k1_ops = sk.scan_bytes_and_ops(2, G, B)
    k1 = dict(ms=cuda_ms(lambda: sk.split_scan(hist2, fvec, svec, pvec), 50),
              kernel_ms=kernel_only_ms(
                  lambda: sk.split_scan(hist2, fvec, svec, pvec), 50),
              plain_ms=cuda_ms(lambda: sk.split_scan_plain(
                  hist2, fvec, svec, pvec), 5),
              bound=bound(k1_bytes, k1_ops))
    print("K1 split_scan at CH=2 F=%d B=%d: %.4f ms, kernel-only %s (bound "
          "%.6f, plain %.4f); gain rel err %.3g, %d valid features"
          % (G, B, k1["ms"], profiled(k1["kernel_ms"]), k1["bound"][0],
             k1["plain_ms"], gain_rel, int(valid.sum())))
    results["split_scan_g137"] = dict(
        route="cuda", mode="f32", launches=0, shape_of="lambdarank",
        name="split_scan_g137", source=SRC % "split_scan",
        replaces=REPLACES["split_scan"],
        max_abs_err=float((rows_k - rows_p)[valid].abs().max()),
        tolerance="feature, threshold, default_left equal; gain rtol 1e-5",
        ms=k1["ms"], kernel_ms=k1["kernel_ms"], plain_ms=k1["plain_ms"],
        bound_ms=k1["bound"][0], bound_by=k1["bound"][1], library_ms=None,
        shape="CH=2 F=%d B=%d" % (G, B))
    del hist2, k2
    torch.cuda.empty_cache()


@timed("train")
def train_and_check(name, params, ds, dev, rounds, must, never, deferred,
                    graphs: int = 1, replays: int = None, **train_kw):
    """lightgbm_tpu_torch.train on the card with the launch counters zeroed
    just before and read just after: the kernels of `must` launched, those
    of `never` not; every round trained unless early stopping ended the
    run, each of its k trees (k classes, else one) of more than one leaf;
    `graphs` graphs (the carried path's two slots, else one; k > 1: one a
    class and the gradients'), each replayed at every round after its
    first call (the first class's and the gradients' first calls run
    eagerly, the other classes' capture in round 1), or `replays` in
    all; with `deferred` no tree fetched but at drains, else one a
    tree."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import _cuda
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    booster = lt.train(params, ds, num_boost_round=rounds, device=dev,
                       **train_kw)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    g = booster._gbdt
    for k in must:
        expect(launches.get(k, 0) > 0, "kernel %s was not launched on the "
               "%s training path" % (k, name))
    for k in never:
        expect(launches.get(k, 0) == 0, "kernel %s was launched on the %s "
               "training path" % (k, name))
    leaves = [m.num_leaves for m in g.models]
    k = booster.num_model_per_iteration()
    trained = len(leaves) // k
    expect((trained == rounds or "early_stopping_rounds" in train_kw)
           and min(leaves) > 1, "%s trees did not grow: leaves %s"
           % (name, leaves))
    stats = g._graphs.stats()
    want = (replays if replays is not None else trained - 1 if k == 1
            else (k * trained - 1) + (trained - 1))
    got = sum(x["replays"] for x in stats)
    expect(len(stats) == graphs and got == want,
           "%s: %d graphs, %d replays in %d rounds"
           % (name, len(stats), got, trained))
    expect((g._tree_fetches, g._drains > 0) == ((0, True) if deferred
                                                 else (len(leaves), False)),
           "%s: %d tree fetches, %d drains in %d rounds"
           % (name, g._tree_fetches, g._drains, trained))
    return booster, dict(
        train_s=train_s, round_ms=train_s * 1e3 / trained, peak_bytes=peak,
        held_bytes=held, leaves=leaves, launches=launches, drains=g._drains,
        tree_fetches=g._tree_fetches, graphs=stats)


def rank_report(name, booster, rec) -> None:
    """Three more replayed rounds, then a profiled one: printed and kept."""
    rec["replay_round_ms"] = replayed_round_ms(booster, REPLAYED_ROUNDS)
    rec["profile"] = profile_round(booster, name)
    print("  %s: train %.3f s (%.1f ms a round, set-up included), leaves %s; "
          "graphs x nodes %s; %d drains, %d tree fetches; %.1f ms a "
          "replayed round (%d more rounds); peak device memory %.3f GB, "
          "%.3f GB above the %.3f GB held before the run (the Higgs "
          "phases' data and this phase's binned rows)"
          % (name, rec["train_s"], rec["round_ms"], rec["leaves"],
             ["1 x %d" % x["nodes"] for x in rec["graphs"]], rec["drains"],
             rec["tree_fetches"], rec["replay_round_ms"], REPLAYED_ROUNDS,
             rec["peak_bytes"] / 1e9,
             (rec["peak_bytes"] - rec["held_bytes"]) / 1e9,
             rec["held_bytes"] / 1e9))


def rank_phase(dev, rounds: int, results) -> dict:
    """Lambdarank at MSLR width through the entry points a user calls:
    (a) lightgbm_tpu_torch.train on 2,268,000 x 137 with no validation set
    (the fused pristine path: a graph replay every round after the first,
    trees fetched at drains), then predict; (b) the same with 1,000 more
    queries as a validation set (eval_at 10, early stopping after 2),
    whose last ndcg must equal the host prediction's."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.objective import create_objective

    t = time.perf_counter()
    X, y, group, w_util = mslr_like(RANK_QUERIES)
    ds = lt.Dataset(X, y, group=group, params=RANK_PARAMS,
                    device=dev).construct()
    n = len(y)
    print("lambdarank data: %d queries x %d documents = %d rows x %d "
          "features generated and binned in %.1f s"
          % (RANK_QUERIES, RANK_DOCS, n, X.shape[1],
             time.perf_counter() - t))
    rank_kernel_phase(ds._binned, dev, results)

    # (a) the fused path
    must, never = pristine_kernels("scatter_segments_add")
    booster, rec = train_and_check("lambdarank", RANK_PARAMS, ds, dev, rounds,
                                   must, never, deferred=True)
    g = booster._gbdt
    expect(g._carried_active is False and g._use_partition_engine,
           "lambdarank: carried %s, partition engine %s"
           % (g._carried_active, g._use_partition_engine))
    # the card's gradients of the trained score against the plain CPU
    # ones of the same score
    score = g.score.clone()
    gk, hk = (t_.cpu() for t_ in g.objective.get_gradients(score))
    cpu_obj = create_objective("lambdarank", g.config)
    cpu_obj.init(ds._binned.metadata, n, "cpu")
    gc, hc = cpu_obj.get_gradients(score.cpu())
    grad_err = max(float((gk - gc).abs().max() / gc.abs().max()),
                   float((hk - hc).abs().max() / hc.abs().max()))
    expect(grad_err <= 1e-5, "lambdarank: the card's gradients differ from "
           "the CPU's by %.3g of their largest magnitude" % grad_err)
    grad_ms = cuda_ms(lambda: g.objective.get_gradients(score), 3)
    grad_busy = kernel_only_ms(lambda: g.objective.get_gradients(score), 3,
                               any_kernel=True)
    raw = booster.predict(X, raw_score=True)
    host = booster.predict(X, raw_score=True, device=False)
    expect(np.array_equal(raw, host), "lambdarank: KP1's sums differ from "
           "the host walk's by up to %.3g" % float(np.abs(raw - host).max()))
    ndcg10 = ndcg_at(10, y, group, raw)
    const10 = ndcg_at(10, y, group, np.zeros(n))
    expect(ndcg10 >= NDCG_FLOOR, "lambdarank: training NDCG@10 %.4f < %.2f"
           % (ndcg10, NDCG_FLOOR))
    print("lambdarank (fused, pristine arena): %d rows x %d features, %d "
          "rounds; training NDCG@10 %.4f of predict (constant scores %.4f); "
          "KP1 sums bit for bit the host walk's; card gradients within %.3g "
          "of the CPU's (rtol of the largest, limit 1e-5); gradients %.3f "
          "ms a call (CUDA events), device busy %s ms"
          % (n, X.shape[1], len(rec["leaves"]), ndcg10, const10, grad_err,
             grad_ms, "not recorded" if grad_busy is None else
             "%.3f" % grad_busy))
    rank_report("lambdarank", booster, rec)
    busy = rec["profile"].get("device_ms")
    rec.update(ndcg10=ndcg10, constant_ndcg10=const10, grad_rel_err=grad_err,
               gradient_ms=grad_ms, gradient_busy_ms=grad_busy,
               gradient_share=(grad_busy / busy if grad_busy and busy
                               else None))
    print("  lambdarank: the gradients' share of a replayed round's busy "
          "time %s" % ("not measured" if rec["gradient_share"] is None
                       else "%.3f" % rec["gradient_share"]))
    for name in ("segment_histogram_g137", "split_scan_g137"):
        results[name]["launches"] = int(rec["launches"].get(
            name[:-len("_g137")], 0))
    del booster, g, score
    torch.cuda.empty_cache()

    # (b) a validation set
    Xv, yv, gv, _ = mslr_like(RANK_VALID_QUERIES, seed=12, w=w_util)
    dv = lt.Dataset(Xv, yv, group=gv, reference=ds, device=dev)
    evals = {}
    must, never = pristine_kernels("scatter_segments_add", WALK_ADD)
    booster, vrec = train_and_check(
        "lambdarank_valid", dict(RANK_PARAMS, eval_at=[10]), ds, dev, rounds,
        must, never, deferred=False, valid_sets=[dv], valid_names=["valid"],
        early_stopping_rounds=EARLY_STOPPING_ROUNDS, evals_result=evals,
        verbose_eval=False)
    series = evals["valid"]["ndcg"]
    host_v = booster.predict(Xv, raw_score=True, device=False)
    want = ndcg_at(10, yv, gv, host_v)
    expect(len(series) == len(vrec["leaves"])
           and abs(series[-1] - want) <= 1e-6,
           "lambdarank valid: last evals_result NDCG@10 %.8f, host "
           "prediction's %.8f" % (series[-1], want))
    const_v = ndcg_at(10, yv, gv, np.zeros(len(yv)))
    expect(want >= NDCG_FLOOR, "lambdarank valid: NDCG@10 %.4f < %.2f"
           % (want, NDCG_FLOOR))
    print("lambdarank (valid set, eager): %d validation rows; evals_result "
          "NDCG@10 %s, best_iteration %d; the host prediction's %.8f "
          "(constant scores %.4f)"
          % (len(yv), ["%.6f" % v for v in series], booster.best_iteration,
             want, const_v))
    rank_report("lambdarank_valid", booster, vrec)
    vrec.update(evals_result=series, host_ndcg10=want,
                constant_ndcg10=const_v,
                best_iteration=booster.best_iteration)
    del booster, ds, dv, X
    torch.cuda.empty_cache()
    return {"fused": rec, "valid": vrec}


def objectives_phase(X, y, dev, rounds: int) -> dict:
    """regression_l1, huber, poisson and xentropy on the Higgs data cut to
    OBJECTIVE_ROWS rows, 255 leaves: trees of more than one leaf, a graph
    replay every round after the first, the fused runs' fetches deferred
    and L1's one a round (its leaf refit); the training metric of the
    first 1..rounds trees (KP1) falling; the sums bit for bit the host
    walk's."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.metric import (create_metric,
                                           default_metric_for_objective)
    X1, y1 = X[:OBJECTIVE_ROWS], y[:OBJECTIVE_ROWS]
    ds = lt.Dataset(X1, y1, params=PARAMS, device=dev).construct()
    out = {}
    for obj in OBJECTIVE_RUNS:
        renew = obj == "regression_l1"
        must, never = pristine_kernels("scatter_segments" if renew
                                       else "scatter_segments_add")
        params = dict(PARAMS, objective=obj)
        booster, rec = train_and_check(obj, params, ds, dev, rounds, must,
                                       never, deferred=not renew)
        g = booster._gbdt
        raw = booster.predict(X1, raw_score=True)
        host = booster.predict(X1, raw_score=True, device=False)
        expect(np.array_equal(raw, host), "%s: KP1's sums differ from the "
               "host walk's" % obj)
        m = create_metric(default_metric_for_objective(obj), g.config)
        m.init(ds._binned.metadata, len(y1))
        curve = [m.eval(booster.predict(X1, num_iteration=k, raw_score=True),
                        g.objective)[0] for k in range(1, rounds + 1)]
        expect(curve[-1] < curve[0], "%s: training %s did not fall: %s"
               % (obj, m.name, curve))
        print("objective %s (%s): %d rows, %d rounds, leaves %s; training "
              "%s by trees %s; graphs x nodes %s, %d tree fetches; train "
              "%.3f s; KP1 sums bit for bit the host walk's"
              % (obj, "eager, a leaf refit a round" if renew else
                 "fused, pristine arena", len(y1), rounds, rec["leaves"],
                 m.name, ["%.6f" % v for v in curve],
                 ["1 x %d" % x["nodes"] for x in rec["graphs"]],
                 rec["tree_fetches"], rec["train_s"]))
        rec.update(metric=m.name, curve=curve)
        out[obj] = rec
        del booster, g
        torch.cuda.empty_cache()
    return out


# the UCI Covertype dataset's shape (Blackard & Dean; the multiclass
# workload of XGBoost's GPU demo, demo/gpu_acceleration/cover_type.py):
# 581,012 rows x 54 features, 7 classes of these counts; a holdout of a
# tenth from another seed.  Its 44 one-hot columns would form multi-feature
# EFB bundles, which the port does not run yet (ROADMAP queue 1, item 11),
# so the generator's 54 columns are dense
COVTYPE_ROWS = 581_012
COVTYPE_FEATURES = 54
COVTYPE_COUNTS = (211_840, 283_301, 35_754, 2_747, 9_493, 17_367, 20_510)
COVTYPE_K = len(COVTYPE_COUNTS)
COVTYPE_HOLDOUT = 58_101
MC_PARAMS = dict(PARAMS, objective="multiclass", num_class=COVTYPE_K)
# the rounds of the multiclass phase's runs and its EFB runs: cut from 5
# to 3 to keep the whole smoke within its time when the boosting-modes
# phase came in
MC_ROUNDS = 3
# the runs of the multiclass phase: name -> (objective, quantized, a
# validation set)
MC_RUNS = {"multiclass_f32": ("multiclass", False, False),
           "multiclass_quantized": ("multiclass", True, False),
           "multiclass_valid": ("multiclass", False, True),
           "multiclassova_f32": ("multiclassova", False, False)}
# the quantized run's holdout multi_logloss within this of the f32 run's
MC_LOGLOSS_GAP = 0.01
# prediction early stop on the f32 run's model: tested every 2 iterations
# (14 trees), at the median top-two gap of the holdout's first 2
# iterations, so that about half of the rows stop there
MC_ES_FREQ = 2 * COVTYPE_K
MC_TILE_ROWS = 100_000      # rows that KP1 walks by row tiles
MC_BUCKETS = (1, 7, 1000)


def class_counts(n: int) -> np.ndarray:
    """Covertype's class counts scaled to n rows (exactly them at 581,012
    rows), the largest remainders rounded up."""
    c = np.asarray(COVTYPE_COUNTS, np.float64) * n / COVTYPE_ROWS
    out = np.floor(c).astype(np.int64)
    out[np.argsort(-(c - out))[:n - int(out.sum())]] += 1
    return out


@timed("data")
def covertype_like(n: int, seed: int = 21, means=None):
    """X [n, 54] f32 and labels 0-6 with Covertype's class counts scaled to
    n (class_counts): the labels a shuffled vector of those counts, each
    row a standard normal draw shifted by its class's mean vector, so that
    its class depends on every feature (means [7, 54]: drawn from the seed,
    0.6 standard deviations on the first 12 features, 0.15 on the others,
    unless given: a holdout takes the training draw's).  Returns (X, y,
    means)."""
    rng = np.random.RandomState(seed)
    if means is None:
        scale = np.where(np.arange(COVTYPE_FEATURES) < 12, 0.6, 0.15)
        means = rng.randn(COVTYPE_K, COVTYPE_FEATURES) * scale
    y = np.repeat(np.arange(COVTYPE_K), class_counts(n))
    rng.shuffle(y)
    X = (rng.randn(n, COVTYPE_FEATURES) + means[y]).astype(np.float32)
    return X, y.astype(np.float32), means


def multiclass_kernels(quantized: bool, valid: bool) -> tuple:
    """(kernels a multiclass run must launch, every other training or
    prediction kernel): the pristine root of every class's tree (K5 and
    K2 int8 quantized), K3 and K1 a split, K4's add mode (on the fused
    runs in the grower, on the valid-set run over the fetched tree's
    segments with shrink 1), KP2's add mode for a validation set; never K6
    (the carried arena needs one tree an iteration) nor K7."""
    sfx = "_i8" if quantized else ""
    must = ("segment_histogram" + sfx, "partition_segment" + sfx,
            "split_scan", "scatter_segments_add")
    if quantized:
        must += ("fused_root_histogram",)
    if valid:
        must += (WALK_ADD,)
    return must, tuple(k for k in TRAINING_KERNELS + PREDICT_KERNELS
                       if k not in must)


def multi_metrics(y, raw, objective) -> dict:
    """multi_logloss and multi_error of [n, k] raw scores by the port's
    metrics, through the objective's link."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.io.metadata import Metadata
    from lightgbm_tpu_torch.metric import create_metric
    meta = Metadata(len(y))
    meta.set_label(y)
    out = {}
    for name in ("multi_logloss", "multi_error"):
        m = create_metric(name, lt.Config({"num_class": COVTYPE_K}))
        m.init(meta, len(y))
        out[name] = m.eval(np.ascontiguousarray(raw.T).reshape(-1),
                           objective)[0]
    return out


def multiclass_predict_phase(booster, X, Xh, dev, results) -> dict:
    """KP1 on the f32 run's 21 trees (k = 7): the holdout's sums (the
    small-batch walk) and MC_TILE_ROWS training rows' (row tiles) bit for
    bit the host walk's; the leaves the host walk's; softmax rows summing
    to 1 within 1e-12; early stop every MC_ES_FREQ trees at a margin that
    stops about half the rows, through predict on the holdout, the tile
    rows and the serving buckets, bit for bit the host walk's, the
    launches of both walks counted; and KP1's early stop by both walks
    against its plain version on the card, timed."""
    import torch
    from lightgbm_tpu_torch.ops import _cuda
    from lightgbm_tpu_torch.ops import predict as pr
    from lightgbm_tpu_torch.ops.predict_kernel import predict_ensemble

    g = booster._gbdt
    k, T = COVTYPE_K, len(g.models)
    Xt = X[:MC_TILE_ROWS]
    sums = {}
    for what, Xs in (("holdout", Xh), ("tiles", Xt)):
        raw = booster.predict(Xs, raw_score=True)
        host = booster.predict(Xs, raw_score=True, device=False)
        expect(raw.shape == (len(Xs), k) and np.array_equal(raw, host),
               "multiclass KP1 %s: sums differ from the host walk's by up "
               "to %.3g" % (what, float(np.abs(raw - host).max())))
        sums[what] = raw
    prob = booster.predict(Xh)
    row_err = float(np.abs(prob.sum(axis=1) - 1.0).max())
    expect(row_err <= 1e-12, "multiclass: softmax rows sum to 1 within %.3g"
           % row_err)
    leaf = booster.predict(Xh, pred_leaf=True)
    expect(leaf.shape == (len(Xh), T) and np.array_equal(
        leaf, booster.predict(Xh, pred_leaf=True, device=False)),
        "multiclass KP1 leaf mode: leaves differ from the host walk's")
    # the margin: the median top-two gap of the first 2 iterations
    two = np.sort(booster.predict(Xh, num_iteration=2, raw_score=True,
                                  device=False), axis=1)
    margin = float(np.median(two[:, -1] - two[:, -2]))
    kw = dict(raw_score=True, pred_early_stop=True,
              pred_early_stop_freq=MC_ES_FREQ, pred_early_stop_margin=margin)
    _cuda.reset_launch_counts()
    es = {"holdout": booster.predict(Xh, **kw),
          "tiles": booster.predict(Xt, **kw)}
    for n in MC_BUCKETS:
        es["bucket_%d" % n] = booster.predict(Xh[:n], **kw)
    launches = dict(_cuda.LAUNCHES)
    expect(launches.get("predict_ensemble", 0) > 0
           and launches.get("predict_ensemble_small", 0) > 0,
           "multiclass early stop: KP1's walks launched %s" % launches)
    share = {}
    for what, got in es.items():
        Xs = {"holdout": Xh, "tiles": Xt}.get(what, Xh[:len(got)])
        host = booster.predict(Xs, device=False, **kw)
        expect(np.array_equal(got, host), "multiclass early stop (%s): sums "
               "differ from the host walk's" % what)
        full = sums["tiles" if what == "tiles" else "holdout"][:len(got)]
        share[what] = float(np.mean((got != full).any(axis=1)))
    expect(0.05 <= share["holdout"] <= 0.95, "multiclass early stop stopped "
           "%.3f of the holdout's rows" % share["holdout"])
    # KP1's early stop on the card against its plain version, both walks
    tb = g._device_ensemble().tables
    Xd = torch.from_numpy(np.ascontiguousarray(Xh)).to(dev)
    es_kw = dict(mode=pr.MODE_SUM_EARLY_STOP, freq=MC_ES_FREQ, margin=margin)
    plain = pr.predict_ensemble_plain(tb, Xd, T, k, **es_kw)
    out = torch.empty((k, len(Xh)), dtype=torch.float64, device=dev)
    walk_ms = {}
    for small in (False, True):
        def run():
            predict_ensemble(tb, Xd, T, k, out, small=small, **es_kw)
        run()
        expect(torch.equal(out, plain), "KP1 early stop k=%d (%s): sums "
               "differ from the plain version's" % (k, "small" if small
                                                    else "tiles"))
        walk_ms["small" if small else "tiles"] = cuda_ms(run, 10)
    plain_ms = cuda_ms(lambda: pr.predict_ensemble_plain(tb, Xd, T, k,
                                                         **es_kw), 1,
                       warmup=0)
    print("multiclass prediction (KP1, k=%d, %d trees): holdout %d rows "
          "(small-batch walk) and %d training rows (row tiles) bit for bit "
          "the host walk's; leaves equal; softmax rows sum to 1 within "
          "%.3g; early stop every %d trees at margin %.6f (the holdout's "
          "median top-two gap after 2 iterations) equal to the host walk's, "
          "rows stopped: %s; launches %s; KP1 early stop on the holdout "
          "against its plain version, exact: row tiles %.4f ms, small-batch "
          "walk %.4f ms, plain %.1f ms"
          % (k, T, len(Xh), len(Xt), row_err, MC_ES_FREQ, margin,
             ", ".join("%s %.3f" % kv for kv in share.items()),
             {n: launches.get(n, 0) for n in PREDICT_KERNELS},
             walk_ms["tiles"], walk_ms["small"], plain_ms))
    results["predict_ensemble"]["multiclass_early_stop"] = dict(
        k=k, trees=T, rows=len(Xh), freq=MC_ES_FREQ, margin=margin,
        stopped_share=share, tiles_ms=walk_ms["tiles"],
        small_ms=walk_ms["small"], plain_ms=plain_ms, max_abs_err=0.0,
        launches={n: launches.get(n, 0) for n in PREDICT_KERNELS})
    del Xd, out, plain
    torch.cuda.empty_cache()
    return dict(es_margin=margin, es_stopped_share=share,
                softmax_row_err=row_err, es_tiles_ms=walk_ms["tiles"],
                es_small_ms=walk_ms["small"], es_plain_ms=plain_ms)


def multiclass_phase(dev, rounds: int, results) -> tuple:
    """Multiclass at Covertype width through the entry points a user calls:
    lightgbm_tpu_torch.train with num_class 7 on 581,012 x 54, each run
    through train_and_check (3 rounds of 7 trees, every class growing a
    tree in round 1): softmax f32 and quantized on the fused pristine path
    (one graph a class and one for the gradients, replayed every round),
    softmax with the holdout as a validation set (multi_logloss and
    multi_error, early stopping after 2; the eager path, a fetch a tree),
    and one-vs-all f32; the holdout's metrics against the constant prior's;
    then KP1 on the f32 run's model (multiclass_predict_phase), and K2 f32
    at G = 54.  Returns (records by run, launches by run)."""
    import torch
    import lightgbm_tpu_torch as lt

    t = time.perf_counter()
    X, y, means = covertype_like(COVTYPE_ROWS)
    Xh, yh, _ = covertype_like(COVTYPE_HOLDOUT, seed=22, means=means)
    ds = lt.Dataset(X, y, params=MC_PARAMS, device=dev).construct()
    dv = lt.Dataset(Xh, yh, reference=ds, device=dev)
    print("multiclass data (Covertype's shape): %d rows x %d features, "
          "classes %s, holdout %d rows; generated and binned in %.1f s"
          % (len(y), X.shape[1], class_counts(len(y)).tolist(), len(yh),
             time.perf_counter() - t))
    k2_width_phase(ds._binned, dev, results, "multiclass")
    recs, launches = {}, {}
    for name, (objective, quantized, valid) in MC_RUNS.items():
        params = dict(MC_PARAMS, objective=objective,
                      tpu_quantized_grad=quantized)
        kw = {}
        evals = {}
        if valid:
            params["metric"] = ["multi_logloss", "multi_error"]
            kw = dict(valid_sets=[dv], valid_names=["holdout"],
                      early_stopping_rounds=EARLY_STOPPING_ROUNDS,
                      evals_result=evals, verbose_eval=False)
        must, never = multiclass_kernels(quantized, valid)
        booster, rec = train_and_check(
            name, params, ds, dev, rounds, must, never, deferred=not valid,
            graphs=COVTYPE_K + 1, **kw)
        g = booster._gbdt
        expect(g.num_tree_per_iteration == COVTYPE_K
               and g._quantized is quantized
               and g._carried_active is (None if valid else False)
               and g._use_partition_engine,
               "%s: k %d, quantized %s, carried %s" % (
                   name, g.num_tree_per_iteration, g._quantized,
                   g._carried_active))
        first = rec["leaves"][:COVTYPE_K]
        expect(min(first) > 1, "%s: a class grew no tree in round 1: %s"
               % (name, first))
        raw = booster.predict(Xh, raw_score=True)
        got = multi_metrics(yh, raw, g.objective)
        # the constant scores of the objective's init: every class's prior
        prior = [g.objective.boost_from_score(c) for c in range(COVTYPE_K)]
        const = multi_metrics(yh, np.tile(prior, (len(yh), 1)), g.objective)
        expect(got["multi_logloss"] < const["multi_logloss"],
               "%s: holdout multi_logloss %.6f, the prior's %.6f"
               % (name, got["multi_logloss"], const["multi_logloss"]))
        extra = ""
        if valid:
            last = evals["holdout"]["multi_logloss"][-1]
            expect(abs(last - got["multi_logloss"]) <= 1e-6,
                   "%s: last evals_result multi_logloss %.8f, host "
                   "predict's %.8f" % (name, last, got["multi_logloss"]))
            extra = "; evals_result multi_logloss %s, multi_error %s" % (
                ["%.6f" % v for v in evals["holdout"]["multi_logloss"]],
                ["%.6f" % v for v in evals["holdout"]["multi_error"]])
        if name == "multiclass_f32":
            rec["predict"] = multiclass_predict_phase(booster, X, Xh, dev,
                                                      results)
        rec["replay_round_ms"] = replayed_round_ms(booster, REPLAYED_ROUNDS)
        rec["profile"] = profile_kept(booster, name)
        # the gradients of every class, one call's device time against the
        # replayed round's busy time
        rec["gradient_busy_ms"] = kernel_only_ms(
            lambda: g.objective.get_gradients(g.score), 3, any_kernel=True)
        busy = rec["profile"].get("device_ms")
        rec["gradient_share"] = (rec["gradient_busy_ms"] / busy
                                 if rec["gradient_busy_ms"] and busy
                                 else None)
        rec.update(holdout=got, prior=const, evals_result=evals or None)
        print("multiclass (%s): %d rows x %d features, %d classes, %d "
              "rounds, leaves %s; train %.3f s (%.1f ms a round, set-up "
              "included); holdout multi_logloss %.6f (prior %.6f), "
              "multi_error %.6f (prior %.6f)%s; the gradients %s ms of "
              "device time a call, a share %s of the round's busy time; "
              "graphs x nodes %s, capture "
              "and instantiate %s s; %d drains, %d tree fetches; %.1f ms a "
              "replayed round (%d more rounds); peak device memory %.3f GB, "
              "%.3f GB above the %.3f GB held before the run"
              % (name, len(y), X.shape[1], COVTYPE_K,
                 len(rec["leaves"]) // COVTYPE_K, rec["leaves"],
                 rec["train_s"], rec["round_ms"], got["multi_logloss"],
                 const["multi_logloss"], got["multi_error"],
                 const["multi_error"], extra,
                 profiled(rec["gradient_busy_ms"]),
                 "not measured" if rec["gradient_share"] is None
                 else "%.4f" % rec["gradient_share"],
                 ["1 x %d" % x["nodes"] for x in rec["graphs"]],
                 ["%.3f" % x["capture_s"] for x in rec["graphs"]],
                 rec["drains"], rec["tree_fetches"], rec["replay_round_ms"],
                 REPLAYED_ROUNDS, rec["peak_bytes"] / 1e9,
                 (rec["peak_bytes"] - rec["held_bytes"]) / 1e9,
                 rec["held_bytes"] / 1e9))
        recs[name] = rec
        launches[name] = rec["launches"]
        del booster, g
        torch.cuda.empty_cache()
    gap = abs(recs["multiclass_quantized"]["holdout"]["multi_logloss"]
              - recs["multiclass_f32"]["holdout"]["multi_logloss"])
    expect(gap <= MC_LOGLOSS_GAP, "multiclass_quantized holdout "
           "multi_logloss is %.6f from the f32 run's (limit %.2f)"
           % (gap, MC_LOGLOSS_GAP))
    results["segment_histogram_g54"]["launches"] = int(
        launches["multiclass_f32"].get("segment_histogram", 0))
    del ds, dv, X
    torch.cuda.empty_cache()
    return recs, launches

# the airline on-time data of szilard's benchm-ml and GBM-perf benchmarks,
# their 10M-row training set train-10m: Month, DayofMonth, DayOfWeek,
# DepTime, UniqueCarrier, Origin, Dest, Distance, six of them categories,
# the label dep_delayed_15min
AIRLINE_ROWS = 10_000_000
AIRLINE_HOLDOUT = 100_000
# the airports each way: train-10m has about 300, which skewed to the same
# top share leave a categorical bin mapper 292 of them, past the 256 bins
# of a uint8 column: uint16 bins, which only the label engine takes, as in
# JAX (lightgbm_tpu/models/gbdt.py:1217-1219).  The label run takes the
# 300 (AIRLINE_WIDE); the partition runs, on uint8 bins, the 255 that
# max_bin 255 keeps
AIRLINE_AIRPORTS = 255
AIRLINE_WIDE = 300
AIRLINE_CARDS = {0: 12, 1: 31, 2: 7, 4: 22, 5: AIRLINE_AIRPORTS,
                 6: AIRLINE_AIRPORTS}
AIRLINE_CATS = tuple(sorted(AIRLINE_CARDS))
# the airports' Zipf exponent, set so that the busiest airport has ATL's
# share of departures in the BTS on-time data that train-10m samples
# (413,851 of the 7,453,215 flights of 2007 in the ASA Data Expo 2009
# extract, 5.55%); a one-parameter skew, matched at the top only
AIRPORT_SKEW = 0.6431
# the categorical runs: name -> (path of PATHS, categories as numbers)
CAT_RUNS = {"cat_f32": ("f32", False), "cat_quantized": ("quantized", False),
            "cat_valid_f32": ("valid_f32", False),
            "cat_numeric_f32": ("f32", True)}
# the label engine's run on the 300 airports: uint16 bins, bin sets wider
# than 256 bits, the 300-airport holdout as a validation set (KP2's add
# mode over uint16 bins)
CAT_WIDE_RUN = "cat_label_wide_f32"
# Covertype at its own layout: 10 numbers, then 4 wilderness-area and 40
# soil-type one-hot columns, which EFB bundles
COVTYPE_NUMERIC, COVTYPE_AREAS, COVTYPE_SOILS = 10, 4, 40
EFB_RUNS = {"efb_multiclass_f32": False, "efb_multiclass_label_f32": True}
# multi_logloss of Covertype's class prior (the constant score of
# boost_from_average), which an EFB run's holdout must beat
COVTYPE_PRIOR_LOGLOSS = 1.2052


@timed("data")
def airline_like(n: int, seed: int = 31, effects=None,
                 airports: int = AIRLINE_AIRPORTS):
    """X [n, 8] f32 in the airline layout, categories as integer codes
    (months, days, weekdays, 22 carriers, `airports` airports each way
    drawn with a Zipf skew of AIRPORT_SKEW), DepTime as hhmm, Distance in
    miles; the label a logistic draw from per-category effects (no order
    of the codes carries them), a route effect of each (Origin, Dest)
    pair, the hour of departure and noise, about a fifth of the rows
    delayed.  effects: a holdout takes the training draw's.  Returns (X,
    y, effects)."""
    rng = np.random.RandomState(seed)
    cards = dict(AIRLINE_CARDS)
    cards[5] = cards[6] = airports
    if effects is None:
        er = np.random.RandomState(seed + 1000)
        scale = {0: 0.35, 1: 0.15, 2: 0.2, 4: 0.5, 5: 0.7, 6: 0.7}
        effects = {j: er.randn(c).astype(np.float32) * scale[j]
                   for j, c in cards.items()}
        effects["route"] = er.randn(airports, airports).astype(
            np.float32) * 0.4
        effects["miles"] = er.gamma(2.0, 450.0, (airports, airports)).astype(
            np.float32)
    X = np.empty((n, 8), np.float32)
    score = np.zeros(n, np.float32)
    zipf = 1.0 / np.arange(1, airports + 1) ** AIRPORT_SKEW
    zipf /= zipf.sum()
    codes = {}
    for j, card in cards.items():
        c = (rng.choice(card, n, p=zipf) if j in (5, 6) else
             rng.randint(0, card, n))
        codes[j] = c
        X[:, j] = c
        score += effects[j][c]
    hour = rng.randint(5, 24, n)
    X[:, 3] = hour * 100 + rng.randint(0, 60, n)
    X[:, 7] = np.round(effects["miles"][codes[5], codes[6]])
    score += effects["route"][codes[5], codes[6]] + 0.09 * (hour - 14)
    score += rng.logistic(size=n).astype(np.float32) * 0.6
    y = (score > np.quantile(score, 0.8)).astype(np.float32)
    return X, y, effects


@timed("data")
def covertype_onehot(n: int, seed: int = 51, means=None):
    """X [n, 54] f32 at Covertype's layout: 10 numbers (a standard normal
    draw shifted by the class's means), then the row's wilderness area
    and soil type as 4 and 40 one-hot columns, each drawn from its
    class's own distribution over the areas and soils; labels with
    Covertype's class counts scaled to n (class_counts).  means: a holdout
    takes the training draw's.  Returns (X, y, means)."""
    rng = np.random.RandomState(seed)
    if means is None:
        mr = np.random.RandomState(seed + 1000)
        means = dict(
            num=mr.randn(COVTYPE_K, COVTYPE_NUMERIC) * 0.5,
            area=mr.dirichlet(np.ones(COVTYPE_AREAS), COVTYPE_K),
            soil=mr.dirichlet(np.full(COVTYPE_SOILS, 0.3), COVTYPE_K))
    y = np.repeat(np.arange(COVTYPE_K), class_counts(n))
    rng.shuffle(y)
    X = np.zeros((n, COVTYPE_FEATURES), np.float32)
    X[:, :COVTYPE_NUMERIC] = rng.randn(n, COVTYPE_NUMERIC) + means["num"][y]
    for key, off, width in (("area", COVTYPE_NUMERIC, COVTYPE_AREAS),
                            ("soil", COVTYPE_NUMERIC + COVTYPE_AREAS,
                             COVTYPE_SOILS)):
        cum = np.cumsum(means[key], axis=1)[y]
        pick = (rng.rand(n, 1) > cum).sum(axis=1).clip(0, width - 1)
        X[np.arange(n), off + pick] = 1.0
    return X, y.astype(np.float32), means


def cat_kernels(path: str, numeric: bool) -> tuple:
    """(must, never) of a categorical run: its path's kernels, but K1
    never where a feature is categorical (the JAX rule,
    lightgbm_tpu/ops/grow_partition.py:343, ops/grow.py:346: every scan of
    a categorical dataset is the XLA route's, plain PyTorch here)."""
    must, never = path_kernels(path)
    if numeric:
        return must, never
    return (tuple(k for k in must if k != "split_scan"),
            never + ("split_scan",))


def kp2_categorical(booster, X, dev, results,
                    key: str = "walk_binned_cat") -> dict:
    """KP2 over a categorical valid-set run's last tree: its device form
    (gbdt._tree_to_device, the bin sets as [N, B] masks) over the 10M
    training rows' bins, leaf mode, add mode and masked add (a bag of
    about 80% of the rows at their leaf ids, the others walked) against
    the plain walk, bit for bit, and the leaves against the host walk of
    the raw rows; timed beside the bytes each mode must move.  Its entry goes to the
    kernels line under `key` (walk_binned_cat: the 255-airport run, uint8
    bins and 32-byte bin sets; walk_binned_u16: the 300-airport label
    run, uint16 bins and wider sets), its launches those of the
    valid-set run."""
    import torch
    from lightgbm_tpu_torch.models.gbdt import _tree_to_device
    from lightgbm_tpu_torch.ops.predict_kernel import (cat_set_bytes,
                                                       walk_binned,
                                                       walk_binned_plain)
    g = booster._gbdt
    tree = g.models[-1]
    dt = _tree_to_device(tree, dev, g.max_bin)
    ncat = int(dt.is_cat.sum())
    expect(ncat > 0, "KP2 categorical: the tree has no categorical node")
    bins = g.train_set.device_bins(dev)
    n, G = bins.shape
    nb, db = g.num_bins, g.default_bins
    got = walk_binned(bins, dt, nb, db)
    want = walk_binned_plain(bins, dt, nb, db)
    expect(torch.equal(got, want), "KP2 categorical leaf mode: leaves "
           "differ from the plain walk's")
    rows = slice(0, 200_000)
    host = tree.predict_leaf_index(X[rows])
    expect(np.array_equal(got[rows].cpu().numpy(), host),
           "KP2 categorical: leaves differ from the host walk's")
    lv = torch.as_tensor(tree.leaf_value[:tree.num_leaves].astype(np.float32),
                         device=dev)
    score0 = torch.randn(n, generator=torch.Generator(device=dev)
                         .manual_seed(9), device=dev)
    out_of_bag, ids = bag_ids(got, dev)
    r = {}
    for mode, kw in (("add", {}), ("masked_add", dict(leaf_ids=ids)),
                     ("leaf", None)):
        if kw is None:
            def run():
                walk_binned(bins, dt, nb, db)

            def plain():
                walk_binned_plain(bins, dt, nb, db)
        else:
            sk_, sp_ = score0.clone(), score0.clone()
            walk_binned(bins, dt, nb, db, lv=lv, score=sk_, **kw)
            walk_binned_plain(bins, dt, nb, db, lv=lv, score=sp_, **kw)
            expect(torch.equal(sk_.view(torch.int32), sp_.view(torch.int32)),
                   "KP2 categorical %s (%s): scores differ" % (mode, key))

            def run():
                walk_binned(bins, dt, nb, db, lv=lv, score=sk_, **kw)

            def plain():
                walk_binned_plain(bins, dt, nb, db, lv=lv, score=sp_, **kw)
        walked = (out_of_bag if mode == "masked_add" else
                  torch.ones(n, dtype=torch.bool, device=dev))
        # the tables: 21 bytes a node, its bin set a categorical one; a
        # row's bins G * the bin's bytes
        nbytes = walk_binned_bytes(walked, G * bins.element_size(),
                                   dt.split_feature.shape[0],
                                   tree.num_leaves, mode) + ncat * \
            cat_set_bytes(dt.cat_mask.shape[1])
        r[mode] = dict(ms=cuda_ms(run, 10), kernel_ms=kernel_only_ms(run, 10),
                       plain_ms=cuda_ms(plain, 1, warmup=0), bytes=nbytes,
                       bound_ms=bound(nbytes, 0)[0])
    print("KP2 walk_binned over categorical nodes (%s): %d rows x %d "
          "columns of %s bins, the valid-set run's last tree (%d leaves, %d "
          "categorical nodes, %d-byte bin sets); %s; exact, leaves the host "
          "walk's"
          % (key, n, G, "uint16" if bins.element_size() == 2 else "uint8",
             tree.num_leaves, ncat, cat_set_bytes(dt.cat_mask.shape[1]),
             "; ".join(
              "%s %.4f ms, kernel-only %s (bound %.4f, plain %.3f)" % (
                  m, v["ms"], profiled(v["kernel_ms"]), v["bound_ms"],
                  v["plain_ms"]) for m, v in r.items())))
    v = r["add"]
    results[key] = dict(
        name=key, route="cuda", source=SRC % "walk_binned",
        replaces=REPLACES["walk_binned"], port_only=True, mode="add",
        launches=0, shape_of="categorical", max_abs_err=0.0,
        tolerance="bit for bit", ms=v["ms"], kernel_ms=v["kernel_ms"],
        plain_ms=v["plain_ms"], bound_ms=v["bound_ms"], bound_by="bytes",
        library_ms=None, library="none: no single PyTorch call walks a "
        "tree", rows=n, leaves=tree.num_leaves, categorical_nodes=ncat,
        bins="uint16" if bins.element_size() == 2 else "uint8",
        leaf_mode=r["leaf"], masked_add=r["masked_add"])
    return r


def bag_ids(leaf_ids, dev) -> tuple:
    """(out_of_bag, ids): a seeded draw of about 20% of the rows out of a
    bag, and the rows' leaf ids with -1 at those rows, as K4 leaves them
    for KP2's masked add (the bag's rows add at their ids, the others are
    walked)."""
    import torch
    out_of_bag = torch.rand(leaf_ids.shape[0], device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(5)) < 0.2
    return out_of_bag, torch.where(out_of_bag, -1, leaf_ids)


def categorical_phase(dev, rounds: int, results) -> tuple:
    """The airline data at its width (AIRLINE_ROWS x 8, six columns
    categorical, a 100k-row holdout of a second seed) through
    lightgbm_tpu_torch.train with PARAMS (255 leaves, max_bin 255, the
    categorical knobs at their defaults): f32 and quantized on the carried
    arena, f32 with the holdout as a validation set (the eager path, KP2's
    add mode over categorical nodes, early stopping after 2) and an f32
    carried twin given the six columns as numbers; each through train_and_check with K1 launched only by the
    twin, KP1's holdout sums bit for bit the host walk's, the holdout AUC
    at least AUC_FLOOR, the replayed round and a profiled round; the
    categorical f32 run's AUC above the twin's, the quantized run's within
    AUC_GAP of it, the valid-set run's last evals_result equal to the host
    prediction's within 1e-6; K2 f32 at the dataset's G against its plain
    version; KP2 over the valid-set run's categorical tree
    (kp2_categorical); and the node count of one categorical split's
    scan (ops/grow.scan_rows of two children), counted from a capture;
    then the label engine on AIRLINE_WIDE airports (wide_label_run).
    Returns (records by run, launches by run)."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.metric import auc

    t = time.perf_counter()
    X, y, eff = airline_like(AIRLINE_ROWS)
    Xh, yh, _ = airline_like(AIRLINE_HOLDOUT, seed=32, effects=eff)
    cat = dict(categorical_feature=list(AIRLINE_CATS))
    ds = lt.Dataset(X, y, params=PARAMS, device=dev, **cat).construct()
    dv = lt.Dataset(Xh, yh, reference=ds, device=dev)
    ds_num = lt.Dataset(X, y, params=PARAMS, device=dev,
                        categorical_feature=[]).construct()
    b = ds._binned
    print("categorical data (the airline layout): %d rows x %d columns, "
          "categories %s in columns %s (bins %s), %.3f delayed; holdout %d "
          "rows; EFB groups %s; generated and binned (twice) in %.1f s"
          % (len(y), X.shape[1], list(AIRLINE_CARDS.values()),
             list(AIRLINE_CATS), b.feature_num_bins().tolist(),
             float(y.mean()), len(yh), b.num_groups,
             time.perf_counter() - t))
    expect(int(b.is_categorical.sum()) == len(AIRLINE_CATS),
           "airline: %d categorical features" % int(b.is_categorical.sum()))
    k2_width_phase(b, dev, results, "categorical")
    recs, launches = {}, {}
    for name, (path, numeric) in CAT_RUNS.items():
        dset = ds_num if numeric else ds
        kw, evals = {}, {}
        if flag(path, "valid"):
            kw = dict(valid_sets=[dv], valid_names=["holdout"],
                      early_stopping_rounds=EARLY_STOPPING_ROUNDS,
                      evals_result=evals, verbose_eval=False)
        must, never = cat_kernels(path, numeric)
        booster, rec = train_and_check(
            name, path_params(path), dset, dev, rounds, must, never,
            deferred=not flag(path, "valid"),
            graphs=2 if carried(path) else 1, **kw)
        g = booster._gbdt
        expect((g.is_categorical is None) is numeric
               and bool(g._carried_active) is carried(path)
               and g._quantized is flag(path, "quantized"),
               "%s: categorical %s, carried %s, quantized %s"
               % (name, g.is_categorical is not None, g._carried_active,
                  g._quantized))
        cats = sum(m.num_cat for m in g.models)
        expect(numeric or cats > 0, "%s: no categorical split" % name)
        raw = booster.predict(Xh, raw_score=True)
        host = booster.predict(Xh, raw_score=True, device=False)
        expect(np.array_equal(raw, host), "%s: KP1's holdout sums differ "
               "from the host walk's by up to %.3g"
               % (name, float(np.abs(raw - host).max())))
        pred = booster.predict(Xh)
        holdout_auc = auc(yh, pred)
        expect(holdout_auc >= AUC_FLOOR, "%s holdout AUC %.4f < %.2f"
               % (name, holdout_auc, AUC_FLOOR))
        extra = ""
        if flag(path, "valid"):
            last = evals["holdout"]["auc"][-1]
            expect(abs(last - holdout_auc) <= 1e-6, "%s: last evals_result "
                   "AUC %.8f, host predict AUC %.8f"
                   % (name, last, holdout_auc))
            expect(rec["launches"].get(WALK_ADD, 0) > 0, "%s: KP2's add "
                   "mode did not run over categorical nodes" % name)
            extra = "; evals_result holdout AUC %s" % evals["holdout"]["auc"]
            rec["kp2"] = kp2_categorical(booster, X, dev, results)
        rec["replay_round_ms"] = replayed_round_ms(booster, REPLAYED_ROUNDS)
        rec["profile"] = profile_kept(booster, name)
        rec.update(holdout_auc=holdout_auc, categorical_splits=cats,
                   evals_result=evals or None)
        print("categorical (%s, %s%s): %d rows, %d rounds, leaves %s, %d "
              "categorical splits; train %.3f s (%.1f ms a round, set-up "
              "included); holdout AUC %.4f%s; graphs x nodes %s, capture "
              "and instantiate %s s; %d drains, %d tree fetches; %.1f ms a "
              "replayed round (%d more rounds); peak device memory %.3f GB, "
              "%.3f GB above the %.3f GB held before the run"
              % (name, path, ", the six columns as numbers" if numeric else
                 "", len(y), len(rec["leaves"]), rec["leaves"], cats,
                 rec["train_s"], rec["round_ms"], holdout_auc, extra,
                 ["1 x %d" % x["nodes"] for x in rec["graphs"]],
                 ["%.3f" % x["capture_s"] for x in rec["graphs"]],
                 rec["drains"], rec["tree_fetches"], rec["replay_round_ms"],
                 REPLAYED_ROUNDS, rec["peak_bytes"] / 1e9,
                 (rec["peak_bytes"] - rec["held_bytes"]) / 1e9,
                 rec["held_bytes"] / 1e9))
        recs[name] = rec
        launches[name] = rec["launches"]
        del booster, g
        torch.cuda.empty_cache()
    f32, twin = recs["cat_f32"]["holdout_auc"], \
        recs["cat_numeric_f32"]["holdout_auc"]
    expect(f32 > twin, "categorical f32 holdout AUC %.4f is not above its "
           "numeric-coded twin's %.4f" % (f32, twin))
    gap = abs(recs["cat_quantized"]["holdout_auc"] - f32)
    expect(gap <= AUC_GAP, "cat_quantized holdout AUC is %.4f from the "
           "cat_f32 run's (limit %.2f)" % (gap, AUC_GAP))
    recs["scan_nodes"] = categorical_scan_nodes(b, dev)
    results["segment_histogram_g%d" % b.num_groups]["launches"] = int(
        launches["cat_f32"].get("segment_histogram", 0))
    results["walk_binned_cat"]["launches"] = int(
        launches["cat_valid_f32"].get(WALK_ADD, 0))
    del ds, dv, ds_num, X
    torch.cuda.empty_cache()
    recs[CAT_WIDE_RUN], launches[CAT_WIDE_RUN] = wide_label_run(
        dev, rounds, results)
    return recs, launches


def wide_label_run(dev, rounds: int, results) -> tuple:
    """The airline data with AIRLINE_WIDE airports each way (10M x 8, a
    100k-row holdout of the same draw): uint16 bins (Origin and Dest past
    256 categorical bins), which the label engine takes; K7's uint16 form
    against its plain version at the root and on a ~40k-row leaf; then
    the label engine through train_and_check with the holdout as a
    validation set (KP2's add mode over uint16 bins and bin sets wider
    than 256 bits), early stopping after 2: K7's uint16 form and KP2's
    uint16 add launched, no other training kernel; categorical splits,
    KP1's holdout sums bit for bit the host walk's, the holdout AUC at
    least AUC_FLOOR, the last evals_result the host prediction's within
    1e-6; KP2 over its last tree at the full row count
    (kp2_categorical).  Returns (record, launches)."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.metric import auc

    t = time.perf_counter()
    X, y, eff = airline_like(AIRLINE_ROWS, airports=AIRLINE_WIDE)
    Xh, yh, _ = airline_like(AIRLINE_HOLDOUT, seed=32, effects=eff,
                             airports=AIRLINE_WIDE)
    cat = dict(categorical_feature=list(AIRLINE_CATS))
    ds = lt.Dataset(X, y, params=PARAMS, device=dev, **cat).construct()
    dv = lt.Dataset(Xh, yh, reference=ds, device=dev)
    b = ds._binned
    print("categorical data, %d airports each way: %d rows, bins %s (%s), "
          "a histogram column of %d bins; generated and binned in %.1f s"
          % (AIRLINE_WIDE, len(y), b.feature_num_bins().tolist(),
             b.bins.dtype, b.hist_max_bin(), time.perf_counter() - t))
    expect(b.bins.dtype == np.uint16 and b.hist_max_bin() > 256,
           "%d airports: bins %s, %d a column" % (AIRLINE_WIDE, b.bins.dtype,
                                                  b.hist_max_bin()))
    n = len(y)
    rng = np.random.RandomState(19)
    g = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
    h = torch.from_numpy((rng.rand(n) * 0.25 + 0.01).astype(np.float32)
                         ).to(dev)
    leaves = rng.randint(0, LEAVES, n)
    child = int(np.argmin(np.abs(np.bincount(leaves) - CHILD_ROWS)))
    from lightgbm_tpu_torch.ops import histogram_kernel as hk
    leaf_forms(b.device_bins(dev), {"leaf_histogram_u16": (g, h)},
               {"root": np.zeros(n, np.int64), "child": leaves}, child,
               b.hist_max_bin(), hk.row_list(n, dev), dev, results,
               shape_of="categorical")
    del g, h, leaves
    evals = {}
    must = ("leaf_histogram_u16", WALK_ADD + "_u16")
    booster, rec = train_and_check(
        CAT_WIDE_RUN, path_params("label_f32", metric="auc"), ds, dev, rounds,
        must, TRAINING_KERNELS + PREDICT_KERNELS, deferred=False, graphs=1,
        valid_sets=[dv], valid_names=["holdout"],
        early_stopping_rounds=EARLY_STOPPING_ROUNDS, evals_result=evals,
        verbose_eval=False)
    g = booster._gbdt
    cats = sum(m.num_cat for m in g.models)
    expect(not g._use_partition_engine and cats > 0
           and g.max_bin == b.hist_max_bin(),
           "%s: partition engine %s, %d categorical splits, max_bin %d"
           % (CAT_WIDE_RUN, g._use_partition_engine, cats, g.max_bin))
    raw = booster.predict(Xh, raw_score=True)
    host = booster.predict(Xh, raw_score=True, device=False)
    expect(np.array_equal(raw, host), "%s: KP1's holdout sums differ from "
           "the host walk's by up to %.3g"
           % (CAT_WIDE_RUN, float(np.abs(raw - host).max())))
    holdout_auc = auc(yh, booster.predict(Xh))
    last = evals["holdout"]["auc"][-1]
    expect(holdout_auc >= AUC_FLOOR and abs(last - holdout_auc) <= 1e-6,
           "%s: holdout AUC %.4f (floor %.2f), last evals_result %.8f"
           % (CAT_WIDE_RUN, holdout_auc, AUC_FLOOR, last))
    rec["kp2"] = kp2_categorical(booster, X, dev, results,
                                 key="walk_binned_u16")
    rec["replay_round_ms"] = replayed_round_ms(booster, REPLAYED_ROUNDS)
    rec["profile"] = profile_kept(booster, CAT_WIDE_RUN)
    rec.update(holdout_auc=holdout_auc, categorical_splits=cats,
               evals_result=evals)
    print("categorical (%s, label engine, %d airports, uint16 bins): %d "
          "rows, %d rounds, leaves %s, %d categorical splits; train %.3f s "
          "(%.1f ms a round, set-up included); holdout AUC %.4f; "
          "evals_result holdout AUC %s; graphs x nodes %s, capture and "
          "instantiate %s s; %d drains, %d tree fetches; %.1f ms a "
          "replayed round (%d more rounds); peak device memory %.3f GB"
          % (CAT_WIDE_RUN, AIRLINE_WIDE, n, len(rec["leaves"]),
             rec["leaves"], cats, rec["train_s"], rec["round_ms"],
             holdout_auc, evals["holdout"]["auc"],
             ["1 x %d" % x["nodes"] for x in rec["graphs"]],
             ["%.3f" % x["capture_s"] for x in rec["graphs"]],
             rec["drains"], rec["tree_fetches"], rec["replay_round_ms"],
             REPLAYED_ROUNDS, rec["peak_bytes"] / 1e9))
    results["leaf_histogram_u16"]["launches"] = int(
        rec["launches"].get("leaf_histogram_u16", 0))
    results["walk_binned_u16"]["launches"] = int(
        rec["launches"].get(WALK_ADD + "_u16", 0))
    del booster, g, ds, dv, X
    torch.cuda.empty_cache()
    return rec, rec["launches"]


def categorical_scan_nodes(ds, dev) -> dict:
    """The device nodes of one categorical split's scan of both children
    (ops/grow.scan_rows over the airline dataset's features, random
    histograms at its widths), counted from a CUDA graph capture of it."""
    import torch
    from lightgbm_tpu_torch.ops.grow import scan_rows
    from lightgbm_tpu_torch.ops.split import SplitParams
    F, B = ds.num_features, ds.hist_max_bin()
    gen = torch.Generator(device=dev).manual_seed(5)
    hists = torch.rand((2, F, B, 3), generator=gen, device=dev)
    hists[..., 2] = torch.floor(hists[..., 2] * 1000)
    sums = hists[:, 0, :, :2].sum(dim=1)
    counts = hists[:, 0, :, 2].sum(dim=1).long()
    inf = torch.full((2,), torch.inf, device=dev)
    statics = [torch.as_tensor(v, device=dev) for v in (
        ds.feature_num_bins(),
        np.array([m.default_bin for m in ds.bin_mappers], np.int32),
        np.array([m.missing_type for m in ds.bin_mappers], np.int32),
        ds.is_categorical)]
    mask = torch.ones(F, dtype=torch.bool, device=dev)

    def scan():
        return scan_rows(hists, sums, counts, -inf, inf, *statics[:3],
                         SplitParams(), feature_mask=mask,
                         is_categorical=statics[3])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        scan()
    torch.cuda.current_stream().wait_stream(side)
    from lightgbm_tpu_torch.ops.graphs import graph_nodes
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        scan()
    nodes = graph_nodes(graph)
    graph.instantiate()
    t = time.perf_counter()
    for _ in range(20):
        graph.replay()
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t) * 1e3 / 20
    print("categorical scan of one split (both children, F=%d, B=%d): %d "
          "graph nodes, %.3f ms a replay (host clock)"
          % (F, B, nodes, replay_ms))
    return dict(nodes=nodes, replay_ms=replay_ms, F=F, B=B)


def efb_runs(dev, rounds: int, results) -> tuple:
    """Multiclass softmax f32 at Covertype's one-hot layout (581,012 x 54,
    enable_bundle at its default): EFB groups the 54 columns, K2 f32 at
    the groups' G against its plain version; the partition engine (fused
    pristine; K1 after unbundling) and the label engine, each through
    train_and_check, its holdout multi_logloss below the prior's 1.2052,
    KP1's holdout sums bit for bit the host walk's, the replayed and a
    profiled round.  Returns (records by run, launches by run)."""
    import torch
    import lightgbm_tpu_torch as lt

    t = time.perf_counter()
    X, y, means = covertype_onehot(COVTYPE_ROWS)
    Xh, yh, _ = covertype_onehot(COVTYPE_HOLDOUT, seed=52, means=means)
    ds = lt.Dataset(X, y, params=MC_PARAMS, device=dev).construct()
    b = ds._binned
    expect(b.bundle is not None and b.bundle.any_bundled,
           "Covertype one-hot: EFB bundled nothing")
    print("EFB data (Covertype's one-hot layout): %d rows x %d columns (%d "
          "numbers, %d areas, %d soils), EFB groups %d (bins %s); "
          "generated and binned in %.1f s"
          % (len(y), X.shape[1], COVTYPE_NUMERIC, COVTYPE_AREAS,
             COVTYPE_SOILS, b.num_groups, b.bundle.group_num_bins.tolist(),
             time.perf_counter() - t))
    k2_width_phase(b, dev, results, "efb")
    recs, launches = {}, {}
    for name, label in EFB_RUNS.items():
        params = dict(MC_PARAMS)
        if label:
            params.update(tpu_tree_engine="label",
                          tpu_histogram_impl="pallas")
            must = ("leaf_histogram", "split_scan")
            never = PARTITION_KERNELS + PREDICT_KERNELS + WALKS
        else:
            must, never = multiclass_kernels(False, False)
        booster, rec = train_and_check(
            name, params, ds, dev, rounds, must, never, deferred=True,
            graphs=COVTYPE_K + 1)
        g = booster._gbdt
        expect(g.bundle is not None and g._use_partition_engine is not label,
               "%s: bundle %s, partition engine %s"
               % (name, g.bundle is not None, g._use_partition_engine))
        raw = booster.predict(Xh, raw_score=True)
        host = booster.predict(Xh, raw_score=True, device=False)
        expect(np.array_equal(raw, host), "%s: KP1's holdout sums differ "
               "from the host walk's" % name)
        got = multi_metrics(yh, raw, g.objective)
        expect(got["multi_logloss"] < COVTYPE_PRIOR_LOGLOSS,
               "%s: holdout multi_logloss %.6f, the prior's %.4f"
               % (name, got["multi_logloss"], COVTYPE_PRIOR_LOGLOSS))
        rec["replay_round_ms"] = replayed_round_ms(booster, REPLAYED_ROUNDS)
        rec["profile"] = profile_kept(booster, name)
        rec.update(holdout=got, groups=b.num_groups)
        print("EFB (%s, %s engine): %d rows, %d groups, %d rounds of %d "
              "trees, leaves %s; train %.3f s (%.1f ms a round, set-up "
              "included); holdout multi_logloss %.6f (prior %.4f), "
              "multi_error %.6f; graphs x nodes %s; %d drains, %d tree "
              "fetches; %.1f ms a replayed round; peak device memory %.3f "
              "GB"
              % (name, "label" if label else "partition", len(y),
                 b.num_groups, len(rec["leaves"]) // COVTYPE_K, COVTYPE_K,
                 rec["leaves"], rec["train_s"], rec["round_ms"],
                 got["multi_logloss"], COVTYPE_PRIOR_LOGLOSS,
                 got["multi_error"],
                 ["1 x %d" % x["nodes"] for x in rec["graphs"]],
                 rec["drains"], rec["tree_fetches"], rec["replay_round_ms"],
                 rec["peak_bytes"] / 1e9))
        recs[name] = rec
        launches[name] = rec["launches"]
        del booster, g
        torch.cuda.empty_cache()
    results["segment_histogram_g%d" % b.num_groups]["launches"] = int(
        launches["efb_multiclass_f32"].get("segment_histogram", 0))
    del ds, X
    torch.cuda.empty_cache()
    return recs, launches


# --------------------------------------------------------------------------- #
# the general grower: CEGB, forced splits, histogram pooling, f64 on the
# label engine (uint16 bins: the categorical phase's 300-airport run)
# --------------------------------------------------------------------------- #
# CEGB: a small split penalty (times the leaf's rows: 10.5 at the root)
# and a coupled penalty on the odd features, charged until a tree first
# splits on one
CEGB_SPLIT = 1e-6
CEGB_COUPLED = 1e4
# a pool of about 64 of the 255 leaves' [28, 255, 3] f32 histograms
POOL_SLOTS = 64
POOL_MB = POOL_SLOTS * FEATURES * 255 * 12 / (1 << 20)
# name -> (params over PARAMS, the label engine)
GENERAL_RUNS = {
    "cegb_f32": (dict(cegb_tradeoff=1.0, cegb_penalty_split=CEGB_SPLIT,
                      cegb_penalty_feature_coupled=[
                          CEGB_COUPLED * (f % 2) for f in range(FEATURES)]),
                 False),
    "cegb_label_f32": (dict(LABEL, cegb_tradeoff=1.0,
                            cegb_penalty_split=CEGB_SPLIT,
                            cegb_penalty_feature_coupled=[
                                CEGB_COUPLED * (f % 2)
                                for f in range(FEATURES)]), True),
    "forced_f32": (dict(forced=True), False),
    "forced_label_f32": (dict(LABEL, forced=True), True),
    "pooled_quantized": (dict(tpu_quantized_grad=True,
                              histogram_pool_size=POOL_MB), False),
    # with the holdout as a validation set: KP2's f64 add a round
    "f64_label": (dict(LABEL, tpu_double_precision=True, metric="auc"),
                  True),
}
# the 20k-row card-vs-CPU runs of the general grower (general_parity)
GENERAL_PARITY = {
    "cegb": dict(cegb_tradeoff=1.0, cegb_penalty_split=CEGB_SPLIT,
                 cegb_penalty_feature_coupled=[2.0 * (f % 2)
                                               for f in range(FEATURES)]),
    "forced": dict(forced=True),
    "pooled_quantized": dict(tpu_quantized_grad=True,
                             histogram_pool_size=8 * FEATURES * 63 * 12
                             / (1 << 20)),
    "f64_label": dict(LABEL, tpu_double_precision=True),
    "label_airports_300": dict(LABEL, airports=True),
}


def forced_plan(root: int) -> dict:
    """A three-node plan over the Higgs features (each N(0, 1), split at
    0): feature root + 1 at the root, root + 2 and root + 3 on its
    children, where `root` is the unforced run's root feature."""
    f = [(root + k) % FEATURES for k in (1, 2, 3)]
    return {"feature": f[0], "threshold": 0.0,
            "left": {"feature": f[1], "threshold": 0.0},
            "right": {"feature": f[2], "threshold": 0.0}}


def write_plan(plan: dict) -> str:
    import os
    import tempfile
    fd, path = tempfile.mkstemp(suffix=".json", prefix="forced_")
    with os.fdopen(fd, "w") as f:
        json.dump(plan, f)
    return path


def general_parity(dev, case: str, root: int) -> dict:
    """A 20k-row, 3-round, 31-leaf run of a general-grower option on the
    card against the same run on the CPU, both grown from the CPU's
    gradients rounded to 1/256 (`share_gradients`: every histogram sum
    exact on both devices, f32 or f64): equal split features and
    thresholds, every row in the same leaf (on the 300-airport data, a
    tree that takes a bin set's complement holds the same leaves,
    relabelled), leaf values within 1e-5 of the largest."""
    import os
    import lightgbm_tpu_torch as lt
    extra = dict(GENERAL_PARITY[case])
    airports = extra.pop("airports", False)
    plan = None
    if extra.pop("forced", False):
        plan = write_plan(forced_plan(root))
        extra["forcedsplits_filename"] = plan
    kw = {}
    if airports:
        X, y, _ = airline_like(20_000, seed=44, airports=AIRLINE_WIDE)
        kw = dict(categorical_feature=list(AIRLINE_CATS))
        params = dict(PARAMS, num_leaves=31, **extra)
    else:
        X, y, _, _ = higgs_like(20_000, seed=12)
        params = dict(PARAMS, num_leaves=31, max_bin=63, **extra)
    out = {}
    try:
        for role, d in (("card", dev), ("cpu", "cpu")):
            out[role] = lt.Booster(params, lt.Dataset(X, y, device=d, **kw),
                                   device=d)
    finally:
        if plan is not None:
            os.unlink(plan)
    bk, bc = out["card"], out["cpu"]
    shared = share_gradients(bk, bc)
    for _ in range(3):
        bc.update()
        shared()
        bk.update()
    gk, gc = bk._gbdt, bc._gbdt
    expect(bk.num_trees() == bc.num_trees() == 3, "general parity %s: tree "
           "counts differ" % case)
    mirrored, leaf_err = 0, 0.0
    for t, (a, b) in enumerate(zip(gk.models, gc.models)):
        k = a.num_leaves - 1
        la, lb = a.predict_leaf_index(X), b.predict_leaf_index(X)
        expect(a.num_leaves == b.num_leaves > 1 and np.array_equal(
            np.sort(a.split_feature[:k]), np.sort(b.split_feature[:k])),
            "general parity %s: tree %d's splits differ" % (case, t))
        if airports and not np.array_equal(la, lb):
            expect(len(set(zip(la, lb))) == len(set(la)) == len(set(lb)),
                   "general parity %s: tree %d's leaves differ" % (case, t))
            mirrored += 1
            continue
        expect(np.array_equal(a.split_feature[:k], b.split_feature[:k])
               and np.array_equal(a.threshold_in_bin[:k],
                                  b.threshold_in_bin[:k])
               and np.array_equal(la, lb),
               "general parity %s: tree %d's splits or leaves differ"
               % (case, t))
        scale = float(np.abs(b.leaf_value[:k + 1]).max())
        err = float(np.abs(a.leaf_value[:k + 1] - b.leaf_value[:k + 1]).max())
        leaf_err = max(leaf_err, err / max(scale, 1e-30))
    expect(leaf_err <= 1e-5, "general parity %s: leaf values differ by %.3g "
           "of the largest" % (case, leaf_err))
    if case == "cegb":
        expect(torch_equal(gk._cegb_used, gc._cegb_used), "general parity "
               "cegb: the used-feature vectors differ")
    if case == "forced":
        for t in gk.models:
            expect(t.split_feature[0] == (root + 1) % FEATURES,
                   "general parity forced: the root is not forced")
    if case == "pooled_quantized":
        expect(gk._quantized and 4 <= gk._hist_slots < 31, "general parity "
               "pooled: quantized %s, %d slots" % (gk._quantized,
                                                    gk._hist_slots))
    if case == "f64_label":
        expect(str(gk.score.dtype) == "torch.float64", "general parity f64:"
               " the score is %s" % gk.score.dtype)
    if airports:
        expect(str(gk.train_set.device_bins(dev).dtype) == "torch.int16",
               "general parity airports: the bins are not uint16")
    print("parity (general grower, %s): %d rows, 3 rounds, 31 leaves, card "
          "and CPU grown from the CPU's gradients rounded to 1/256: the same "
          "splits with every row in the same leaf%s; leaf values within "
          "%.3g of the largest"
          % (case, len(y), "" if not airports else
             " (%d trees took a bin set's complement, the same leaves "
             "relabelled)" % mirrored, leaf_err))
    return dict(rows=len(y), leaf_rel_err=leaf_err, mirrored_trees=mirrored)


def torch_equal(a, b) -> bool:
    return bool((a.cpu() == b.cpu()).all())


def general_kernels(name: str) -> tuple:
    """(must, never) of a general-grower run: the f32 carried path's
    kernels (the quantized one's for the pooled run), or the label
    engine's (K7 in its f64 form for f64)."""
    if name == "f64_label":
        must = ("leaf_histogram_f64", WALK_ADD + "_f64")
        return must, TRAINING_KERNELS + PREDICT_KERNELS
    if "label" in name:
        return path_kernels("label_f32")
    return path_kernels("quantized" if "quantized" in name else "f32")


def split_share(models, feats) -> float:
    """The share of the models' splits on the features `feats`."""
    counts = np.zeros(FEATURES)
    for t in models:
        np.add.at(counts, t.split_feature[:t.num_leaves - 1], 1)
    return float(counts[list(feats)].sum() / max(counts.sum(), 1))


def general_phase(X, Xh, yh, ds_obj, valid_obj, dev, rounds, base,
                  results) -> tuple:
    """The general grower at Higgs width (10.5M x 28, PARAMS, 255 leaves),
    each run of GENERAL_RUNS through train_and_check with its kernels
    launched and no other, the holdout AUC at least AUC_FLOOR and KP1's
    sums bit for bit the host walk's: CEGB on the carried arena and on the
    label engine (the penalized odd features take a smaller share of the
    splits than in the training phase's f32 run); forced splits on both
    engines (a three-node plan whose root is not the unforced run's, every
    tree's first splits the plan's); the quantized carried run with a pool
    of POOL_SLOTS histograms (the training phase's quantized trees: the
    same splits and leaves, leaf values within 1e-5; some but not all
    splits missing the pool, counted on the device, each miss recomputing
    its parent by K2); f64 on the label engine
    with the holdout as a validation set (the holdout AUC within AUC_GAP
    of the f32 label run's, the score f64, the last evals_result equal to
    the host prediction's within 1e-6, the validation score by KP2's f64
    add; then KP2's f64 add and masked add over its last tree at the full
    row count against the plain version, bit for bit).  `base`: the
    training phase's f32 root feature, its odd features' split share, its
    quantized model's trees, text and K2 launches, and its label run's
    AUC.  Returns (records,
    launches)."""
    import os
    import torch
    from lightgbm_tpu_torch.metric import auc

    ds_obj.set_weight(None)
    recs, launches = {}, {}
    for name, (extra, label) in GENERAL_RUNS.items():
        params = dict(PARAMS, **extra)
        plan = None
        if params.pop("forced", False):
            plan = write_plan(forced_plan(base["root"]))
            params["forcedsplits_filename"] = plan
        must, never = general_kernels(name)
        carried_run = not label
        kw, evals = {}, {}
        if "metric" in params:
            kw = dict(valid_sets=[valid_obj], valid_names=["holdout"],
                      evals_result=evals, verbose_eval=False)
        try:
            booster, rec = train_and_check(
                name, params, ds_obj, dev, rounds, must, never,
                deferred=not kw, graphs=2 if carried_run else 1, **kw)
        finally:
            if plan is not None:
                os.unlink(plan)
        g = booster._gbdt
        expect(g._use_partition_engine is not label
               and bool(g._carried_active) is carried_run,
               "%s: partition engine %s, carried %s"
               % (name, g._use_partition_engine, g._carried_active))
        raw = booster.predict(Xh, raw_score=True)
        host = booster.predict(Xh, raw_score=True, device=False)
        expect(np.array_equal(raw, host), "%s: KP1's holdout sums differ "
               "from the host walk's by up to %.3g"
               % (name, float(np.abs(raw - host).max())))
        holdout_auc = auc(yh, booster.predict(Xh))
        expect(holdout_auc >= AUC_FLOOR, "%s holdout AUC %.4f < %.2f"
               % (name, holdout_auc, AUC_FLOOR))
        msg = ""
        if name.startswith("cegb"):
            share = split_share(g.models, range(1, FEATURES, 2))
            used = g._cegb_used.cpu().numpy()
            expect(share < base["odd_share"], "%s: the penalized features "
                   "take %.4f of the splits, the unpenalized run %.4f"
                   % (name, share, base["odd_share"]))
            rec.update(penalized_share=share,
                       used_features=int(used.sum()))
            msg = ("; penalized (odd) features %.4f of the splits (f32 run "
                   "%.4f), %d of %d features used"
                   % (share, base["odd_share"], int(used.sum()), FEATURES))
        if name.startswith("forced"):
            plan_f = forced_plan(base["root"])
            for t in g.models:
                expect(t.split_feature[0] == plan_f["feature"]
                       and t.split_feature[t.left_child[0]]
                       == plan_f["left"]["feature"]
                       and t.split_feature[t.right_child[0]]
                       == plan_f["right"]["feature"],
                       "%s: a tree's first splits are not the plan's" % name)
            msg = ("; every tree's first splits the plan's (features %d, "
                   "%d, %d; the unforced root %d)"
                   % (plan_f["feature"], plan_f["left"]["feature"],
                      plan_f["right"]["feature"], base["root"]))
        if name == "pooled_quantized":
            expect(g._hist_slots == POOL_SLOTS and g._quantized,
                   "%s: %d slots, quantized %s" % (name, g._hist_slots,
                                                   g._quantized))
            # a recomputed parent is the dequantized sum of its codes where
            # the dense cache holds a difference of two dequantized sums, as
            # in the JAX package, so the reals may part in the last bits;
            # the misses are the trained rounds' (read before the timed and
            # profiled rounds below)
            same, err = 0, 0.0
            for a, b in zip(g.models, base["quantized_models"]):
                k = a.num_leaves - 1
                expect(a.num_leaves == b.num_leaves
                       and np.array_equal(a.split_feature[:k],
                                          b.split_feature[:k])
                       and np.array_equal(a.threshold_in_bin[:k],
                                          b.threshold_in_bin[:k])
                       and np.array_equal(a.leaf_count[:k + 1],
                                          b.leaf_count[:k + 1]),
                       "%s: a tree differs from the dense run's" % name)
                d = np.abs(a.leaf_value[:k + 1] - b.leaf_value[:k + 1])
                err = max(err, float(d.max() / np.abs(b.leaf_value[:k + 1])
                                     .max()))
                same += int(np.array_equal(a.leaf_value, b.leaf_value))
            expect(err <= 1e-5, "%s: leaf values %.3g from the dense run's"
                   % (name, err))
            misses = int(g._pool_misses)
            splits = sum(t.num_leaves - 1 for t in g.models)
            expect(0 < misses < splits, "%s: %d of the %d splits missed "
                   "the pool" % (name, misses, splits))
            k2 = rec["launches"].get("segment_histogram_i8", 0)
            text_equal = booster.model_to_string() == base["quantized_text"]
            rec.update(leaf_rel_err=err, trees_bit_equal=same,
                       pool_misses=misses, splits=splits, k2_launches=k2,
                       text_equal=text_equal)
            msg = ("; %d slots; %d of %d splits missed the pool and "
                   "recomputed their parent by K2 (%d launches, dense %d); "
                   "trees the dense quantized run's (%d of %d bit for bit, "
                   "leaf values within %.3g; model text %s)"
                   % (g._hist_slots, misses, splits, k2,
                      base["quantized_k2"], same, len(g.models), err,
                      "equal" if text_equal else "differs in its reals"))
        if name == "f64_label":
            gap = abs(holdout_auc - base["label_auc"])
            last = evals["holdout"]["auc"][-1]
            expect(str(g.score.dtype) == "torch.float64" and gap <= AUC_GAP
                   and abs(last - holdout_auc) <= 1e-6,
                   "%s: score %s, holdout AUC %.4f from the f32 label run's,"
                   " last evals_result %.8f against predict's %.8f"
                   % (name, g.score.dtype, gap, last, holdout_auc))
            msg = ("; score f64; AUC %.4f from the f32 label run's; "
                   "evals_result holdout AUC %s" % (gap,
                                                    evals["holdout"]["auc"]))
            rec["kp2_f64"] = kp2_f64(booster, dev, results)
        rec["replay_round_ms"] = replayed_round_ms(booster, REPLAYED_ROUNDS)
        rec["profile"] = profile_round(booster, name)
        rec["holdout_auc"] = holdout_auc
        print("general grower (%s): %d rows, %d rounds, leaves %s; train "
              "%.3f s (%.1f ms a round, set-up included); holdout AUC %.4f%s;"
              " graphs x nodes %s, capture and instantiate %s s; %d drains, "
              "%d tree fetches; %.1f ms a replayed round (%d more rounds); "
              "peak device memory %.3f GB; kernels launched %s"
              % (name, len(X), rounds, rec["leaves"], rec["train_s"],
                 rec["round_ms"], holdout_auc, msg,
                 ["1 x %d" % x["nodes"] for x in rec["graphs"]],
                 ["%.3f" % x["capture_s"] for x in rec["graphs"]],
                 rec["drains"], rec["tree_fetches"], rec["replay_round_ms"],
                 REPLAYED_ROUNDS, rec["peak_bytes"] / 1e9,
                 {k: v for k, v in sorted(rec["launches"].items()) if v}))
        recs[name] = rec
        launches[name] = rec["launches"]
        del booster, g
        torch.cuda.empty_cache()
    results["leaf_histogram_f64"]["launches"] = int(
        launches["f64_label"].get("leaf_histogram_f64", 0))
    results["walk_binned_add_f64"]["launches"] = int(
        launches["f64_label"].get("walk_binned_add_f64", 0))
    return recs, launches


def kp2_f64(booster, dev, results) -> dict:
    """KP2's f64 add (the f64 run's score updates: a validation set's, a
    rebuilt training score's) and masked add (a bagged f64 round's: a bag
    of about 80% of the rows at their leaf ids) over the f64 label run's
    last tree at the full row count, against its plain version, bit for
    bit, timed beside the bytes each must move (8-byte scores)."""
    import torch
    from lightgbm_tpu_torch.models.gbdt import _tree_to_device
    from lightgbm_tpu_torch.ops.predict_kernel import (walk_binned,
                                                       walk_binned_plain)
    g = booster._gbdt
    tree = g.models[-1]
    dt = _tree_to_device(tree, dev, g.max_bin)
    bins = g.train_set.device_bins(dev)
    n, G = bins.shape
    nb, db = g.num_bins, g.default_bins
    lv = torch.as_tensor(tree.leaf_value[:tree.num_leaves], device=dev)
    score0 = torch.randn(n, dtype=torch.float64, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
    out_of_bag, ids = bag_ids(walk_binned_plain(bins, dt, nb, db), dev)
    modes = {}
    for mode, kw in (("add", {}), ("masked_add", dict(leaf_ids=ids))):
        sk_, sp_ = score0.clone(), score0.clone()
        walk_binned(bins, dt, nb, db, lv=lv, score=sk_, **kw)
        walk_binned_plain(bins, dt, nb, db, lv=lv, score=sp_, **kw)
        expect(torch.equal(sk_.view(torch.int64), sp_.view(torch.int64)),
               "KP2 f64 %s: scores differ from the plain version's" % mode)

        def run():
            walk_binned(bins, dt, nb, db, lv=lv, score=sk_, **kw)

        def plain():
            walk_binned_plain(bins, dt, nb, db, lv=lv, score=sp_, **kw)
        walked = (out_of_bag if mode == "masked_add" else
                  torch.ones(n, dtype=torch.bool, device=dev))
        nbytes = walk_binned_bytes(walked, G, dt.split_feature.shape[0],
                                   tree.num_leaves, mode) + 8 * n
        modes[mode] = dict(ms=cuda_ms(run, 10),
                           kernel_ms=kernel_only_ms(run, 10),
                           plain_ms=cuda_ms(plain, 1, warmup=0),
                           bytes=nbytes, bound_ms=bound(nbytes, 0)[0])
    r = dict(modes["add"], masked_add=modes["masked_add"])
    print("KP2 walk_binned, f64: %d rows x %d bins, the f64 label run's "
          "last tree (%d leaves): %s; bit for bit"
          % (n, G, tree.num_leaves, "; ".join(
              "%s %.4f ms, kernel-only %s (bound %.4f, plain %.3f)" % (
                  m, v["ms"], profiled(v["kernel_ms"]), v["bound_ms"],
                  v["plain_ms"]) for m, v in modes.items())))
    results["walk_binned_add_f64"] = dict(
        name="walk_binned_add_f64", route="cuda", source=SRC % "walk_binned",
        replaces=REPLACES["walk_binned"], port_only=True, mode="add, f64",
        launches=0, shape_of="general", max_abs_err=0.0,
        tolerance="bit for bit", ms=r["ms"], kernel_ms=r["kernel_ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by="bytes",
        library_ms=None, library="none: no single PyTorch call walks a "
        "tree", rows=n, leaves=tree.num_leaves, masked_add=r["masked_add"])
    return r


# the public API phase (api_phase): the learning-rate schedule of its
# deferred and eager runs, the rows of its continuation, cv's folds and
# rounds, the scikit-learn wrapper's rows, refit's decay.  TIE_RTOL: a
# first tree grown from f32 histograms must be the built-in run's split
# for split in growth order up to a split whose two gains are within
# TIE_RTOL of each other (a near-tie), and the same tree where there is
# none.  Two f32 runs of one configuration on the card sum their
# histograms in a varying order: the gains of one split differ by up to
# 8.7e-5 of their value between them, and where two candidates' gains are
# that close the runs part (tools/first_tree_ties.py on an NVIDIA H100
# 80GB HBM3 at 700.00 W, 1-round runs: the first difference at split 20,
# two leaves of equal gains, or 3.5e-7 apart, split in the other order;
# 2.5% of the rows then lie in leaves the trees do not share).  A
# quantized first tree sums integer histograms and must part the rows as
# the built-in one does
TIE_RTOL = 1e-3
# the most the continuation's two stages' raw holdout predictions summed
# may differ from the 10-round run's where their ten trees are its split
# for split: the continued trees' f32 histograms add in another order
# (measured on an NVIDIA H100 80GB HBM3 at 700.00 W: 1.14e-5 and 1.51e-5).
# A split parted at a near-tie moves a leaf's rows by far more (0.0126 on
# the same card), so there the trees are held to TIE_RTOL instead
CONT_MAX_DIFF = 1e-3
API_RATES = [0.1, 0.1, 0.05, 0.05, 0.05]
API_ROWS = 1_000_000
# the rows the scikit-learn check's two bin findings sample (the host's
# greedy bin walk is the smoke's slowest step; both runs take the value)
SK_BIN_SAMPLE = 20_000
CV_FOLDS, CV_ROUNDS = 3, 3
# cv's rows: the binned set's first million at full width (10.5M until the
# serving phase came in and the smoke needed its time)
CV_ROWS = 1_000_000
REFIT_DECAY = 0.9
# the built-in run of the training phase each custom-objective run is held
# against (the same engine, arena root and quantization key), its params
# and its kernels' path
FOBJ_RUNS = {"fobj_f32": ("valid_f32", dict(metric="auc"), "valid_f32"),
             "fobj_quantized": ("valid_quantized",
                                dict(tpu_quantized_grad=True),
                                "weighted_quantized"),
             "fobj_label_f32": ("label_f32",
                                dict(tpu_tree_engine="label",
                                     tpu_histogram_impl="pallas"),
                                "label_f32")}


def logloss_fobj(preds, ds):
    """Binary logloss of the raw scores in numpy, in f32 as the port's
    built-in objective computes it (objective.py BinaryLogloss)."""
    s = np.asarray(preds, np.float32)
    sl = np.where(ds.get_label() > 0, np.float32(1), np.float32(-1))
    resp = -sl / (np.float32(1) + np.exp(sl * s))
    a = np.abs(resp)
    return resp, a * (np.float32(1) - a)


def auc_feval(preds, ds):
    from lightgbm_tpu_torch.metric import auc
    return ("feval_auc", auc(ds.get_label(), preds), True)


def train_leaves(booster, tree, dev):
    """Each training row's leaf in a host tree, by KP2's leaf mode over the
    booster's device bins."""
    from lightgbm_tpu_torch.models.gbdt import _tree_to_device
    from lightgbm_tpu_torch.ops.predict_kernel import walk_binned
    g = booster._gbdt
    return walk_binned(g.train_set.device_bins(dev),
                       _tree_to_device(tree, dev, g.max_bin), g.num_bins,
                       g.default_bins, bundle=g.bundle)


def partition_share(booster, a, b, dev) -> float:
    """The share of the booster's training rows that lie in a leaf of
    tree a holding the same rows as a leaf of tree b (1.0: the two trees
    part the rows alike, whatever the numbering of their leaves)."""
    import torch
    la = train_leaves(booster, a, dev).long()
    lb = train_leaves(booster, b, dev).long()
    width = int(lb.max()) + 1
    pairs, counts = torch.unique(la * width + lb, return_counts=True)
    pa, pb = pairs // width, pairs % width
    # a leaf of a in one (a, b) pair only, and that leaf of b too
    alone = (torch.bincount(pa)[pa] == 1) & (torch.bincount(pb)[pb] == 1)
    return float(counts[alone].sum()) / la.numel()


def hold_first_tree(name, booster, tree, want, quantized, dev) -> dict:
    """A first tree against the built-in run's: quantized, the same
    partition of the training rows; f32, the same splits in growth order
    up to a near-tie (TIE_RTOL).  Returns the comparison's record."""
    share = partition_share(booster, tree, want, dev)
    div = first_divergence(want, tree)
    if quantized:
        expect(share == 1.0, "%s: the first tree parts the training rows "
               "unlike the built-in run's (%.6f of them in shared leaves)"
               % (name, share))
    else:
        expect(div["rdiff"] <= TIE_RTOL, "%s: the first tree differs from "
               "the built-in run's at split %s, gains %s there and %s in "
               "the built-in tree (%.3g apart, at most %g)"
               % (name, div["at"], div["gain_b"], div["gain_a"],
                  div["rdiff"], TIE_RTOL))
    return dict(first_tree_shared_leaves_share=share,
                first_divergence=div["at"], divergence_rdiff=div["rdiff"],
                prefix_gain_rdiff=div["prefix_rdiff"])


def said_first_tree(c: dict) -> str:
    return ("the first tree %s; %.6f of the training rows in leaves it "
            "shares with the built-in run's; its equal splits' gains "
            "within %.3g" % (
                "the built-in run's split for split"
                if c["first_divergence"] is None else
                "parts from the built-in run's at split %d (a near-tie, "
                "gains %.3g apart)" % (c["first_divergence"],
                                       c["divergence_rdiff"]),
                c["first_tree_shared_leaves_share"],
                c["prefix_gain_rdiff"]))


def split_parents(tree) -> dict:
    """Each internal node's (parent node, side): the leaf a split took,
    since a split's node is numbered in growth order and takes the slot of
    the leaf it split."""
    out = {0: (-1, -1)}
    for j in range(tree.num_leaves - 1):
        for side, c in ((0, tree.left_child[j]), (1, tree.right_child[j])):
            if c >= 0:
                out[int(c)] = (j, side)
    return out


def first_divergence(a, b) -> dict:
    """Trees a and b compared split by split in growth order: `at`, the
    first split that differs (the leaf it took, its feature, bin threshold
    or decision), None where a and b are the same tree; there, their
    split gains and the relative difference; `prefix_rdiff`, the largest
    relative difference of the gains of the equal splits before it (what
    rounding alone moved)."""
    pa, pb = split_parents(a), split_parents(b)
    na, nb = a.num_leaves - 1, b.num_leaves - 1

    def rdiff(i):
        ga, gb = float(a.split_gain[i]), float(b.split_gain[i])
        return abs(ga - gb) / max(abs(ga), abs(gb), 1e-300)
    prefix = 0.0
    for i in range(min(na, nb)):
        if (pa[i] != pb[i]
                or a.split_feature_inner[i] != b.split_feature_inner[i]
                or a.threshold_in_bin[i] != b.threshold_in_bin[i]
                or a.decision_type[i] != b.decision_type[i]):
            return dict(at=i, gain_a=float(a.split_gain[i]),
                        gain_b=float(b.split_gain[i]), rdiff=rdiff(i),
                        prefix_rdiff=prefix)
        prefix = max(prefix, rdiff(i))
    if na != nb:
        # one tree stopped where the other split on: no gain to compare
        return dict(at=min(na, nb), gain_a=None, gain_b=None,
                    rdiff=float("inf"), prefix_rdiff=prefix)
    return dict(at=None, gain_a=None, gain_b=None, rdiff=0.0,
                prefix_rdiff=prefix)


def text_importance(text: str, kind: str, F: int) -> np.ndarray:
    """Split counts or summed positive gains by feature, recounted from the
    model text's trees."""
    imp = np.zeros(F)
    for blk in text.split("Tree=")[1:]:
        kv = dict(line.split("=", 1) for line in blk.split("\n")
                  if "=" in line)
        if int(kv["num_leaves"]) <= 1:
            continue
        feats = [int(v) for v in kv["split_feature"].split()]
        gains = [float(v) for v in kv["split_gain"].split()]
        for f, gn in zip(feats, gains):
            imp[f] += 1 if kind == "split" else max(gn, 0.0)
    return imp


def launched(counts: dict, must) -> None:
    for k in must:
        expect(counts.get(k, 0) > 0, "kernel %s was not launched" % k)


def leaf_regions(tree) -> list:
    """Each leaf's region: the conditions on its path from the root (split
    feature, bin threshold, decision type, side), whatever the order the
    tree grew in."""
    out = [()] * tree.num_leaves
    stack = [(0, ())] if tree.num_leaves > 1 else []
    while stack:
        node, path = stack.pop()
        cond = (int(tree.split_feature_inner[node]),
                int(tree.threshold_in_bin[node]),
                int(tree.decision_type[node]))
        for side, child in ((0, tree.left_child[node]),
                            (1, tree.right_child[node])):
            child = int(child)
            if child < 0:
                out[~child] = path + (cond + (side,),)
            else:
                stack.append((child, path + (cond + (side,),)))
    return out


def continuation_divergence(m5, m10, cont) -> dict:
    """The 5-round run's trees, then the continued booster's, against the
    10-round run's in order, up to the first pair whose leaves are not the
    same regions (`regions_tree`, its index in the 10-round run; None where
    all ten pairs are): `parted`, the pairs that part split for split in
    growth order (two leaves of equal gains split in the other order part
    the growth order only), and `tree`, `at` and the gains where the two
    splits' gains lie furthest apart (first_divergence)."""
    ours = m5._gbdt.models + cont._gbdt.models
    theirs = m10._gbdt.models
    expect(len(ours) == len(theirs) == 10, "continuation: %d trees against "
           "the 10-round run's %d" % (len(ours), len(theirs)))
    out = dict(tree=None, at=None, gain_a=None, gain_b=None, rdiff=0.0,
               parted=[], regions_tree=None, ours=ours, theirs=theirs)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        div = first_divergence(b, a)
        if div["at"] is not None:
            out["parted"].append(i)
            if out["tree"] is None or div["rdiff"] > out["rdiff"]:
                out.update(tree=i, at=div["at"], gain_a=div["gain_a"],
                           gain_b=div["gain_b"], rdiff=div["rdiff"])
        if set(leaf_regions(a)) != set(leaf_regions(b)):
            out["regions_tree"] = i
            break
    return out


def said_continuation(div: dict) -> str:
    if div["tree"] is None:
        return "the 10-round run's split for split"
    return ("part from the 10-round run's in growth order at trees %s "
            "(near-ties, the widest at tree %d, split %d, gains %.3g "
            "apart), %s" % (
                div["parted"], div["tree"], div["at"], div["rdiff"],
                "their leaves the same regions in all ten"
                if div["regions_tree"] is None else
                "their leaves other regions first at tree %d"
                % div["regions_tree"]))


def continue_and_rollback(X, y, Xh, yh, ds_obj, dev) -> dict:
    """Continued training and rollback on the first API_ROWS rows (see
    api_phase): a 5-round and a 10-round run, then 5 rounds from the
    5-round model.  The two stages' ten trees are held to the 10-round
    run's in order (continuation_divergence) up to the first tree whose
    leaves are other regions than its twin's: each that parts from its
    twin in growth order must part at a near-tie (TIE_RTOL).  Two f32 runs
    part so on the card, and the continuation's init score (KP1's f64 sum)
    rounds otherwise than the 10-round run's f32 score: on the card the ten
    trees parted at a near-tie in every one of five runs, mostly two
    leaves of equal gains split in the other order.  The two stages' raw
    holdout predictions summed must lie within CONT_MAX_DIFF of the
    10-round run's through that first tree, on the rows whose leaf in it
    is one region in both (all ten trees and all rows where none parts);
    the trees after it grow from other scores, so there the holdout AUC
    (within AUC_DRIFT) is held.  Returns the record."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.metric import auc
    from lightgbm_tpu_torch.ops import _cuda

    X1, y1 = X[:API_ROWS], y[:API_ROWS]

    def part():
        return lt.Dataset(X1, y1, reference=ds_obj, device=dev)
    t = time.perf_counter()
    d1 = part()
    m5 = lt.train(PARAMS, d1, 5, verbose_eval=False, device=dev)
    m10 = lt.train(PARAMS, d1, 10, verbose_eval=False, device=dev)
    dc = part()
    _cuda.reset_launch_counts()
    cont = lt.train(PARAMS, dc, 5, init_model=m5, verbose_eval=False,
                    device=dev)
    torch.cuda.synchronize()
    counts = dict(_cuda.LAUNCHES)
    launched(counts, ("predict_ensemble", "segment_histogram",
                      "partition_segment", "split_scan",
                      "scatter_segments_add"))
    init_pred = m5.predict(X1, raw_score=True)
    expect(cont.num_trees() == 5 and np.array_equal(dc.get_init_score(),
                                                    init_pred),
           "continuation: %d trees, init score KP1's prediction %s"
           % (cont.num_trees(), np.array_equal(dc.get_init_score(),
                                               init_pred)))
    div = continuation_divergence(m5, m10, cont)
    expect(div["rdiff"] <= TIE_RTOL, "continuation: tree %s differs from "
           "the 10-round run's at split %s, gains %s there and %s in the "
           "10-round run's (%.3g apart, at most %g)"
           % (div["tree"], div["at"], div["gain_b"], div["gain_a"],
              div["rdiff"], TIE_RTOL))
    p10 = m10.predict(Xh, raw_score=True)
    psum = m5.predict(Xh, raw_score=True) + cont.predict(Xh, raw_score=True)
    d = np.abs(psum - p10)
    within = float(np.mean(d <= 1e-6 + 1e-5 * np.abs(p10)))
    a10, asum = auc(yh, p10), auc(yh, psum)
    # the raw predictions through the first tree of other regions, on the
    # rows whose leaf there is one region in both
    k = div["regions_tree"]
    held = np.ones(len(Xh), bool)
    upto = 10
    if k is not None:
        upto = k + 1
        mine = (m5 if k < 5 else cont).predict(Xh, pred_leaf=True)[:, k % 5]
        theirs = m10.predict(Xh, pred_leaf=True)[:, k]
        at = {r: j for j, r in enumerate(leaf_regions(div["theirs"][k]))}
        match = np.array([at.get(r, -1)
                          for r in leaf_regions(div["ours"][k])])
        held = match[mine] == theirs
    pk = m5.predict(Xh, raw_score=True, num_iteration=min(upto, 5))
    if upto > 5:
        pk = pk + cont.predict(Xh, raw_score=True, num_iteration=upto - 5)
    dk = np.abs(pk - m10.predict(Xh, raw_score=True, num_iteration=upto))
    dk_max = float(dk[held].max()) if held.any() else 0.0
    expect(abs(a10 - asum) <= AUC_DRIFT and dk_max <= CONT_MAX_DIFF,
           "continuation: holdout AUC %.6f, the 10-round run's %.6f; raw "
           "predictions' |diff| max %.3g through %d trees on %.6f of the "
           "rows (at most %g; %.3g through all ten on all rows)"
           % (asum, a10, dk_max, upto, float(held.mean()), CONT_MAX_DIFF,
              d.max()))
    before = cont.predict(Xh, raw_score=True, num_iteration=4)
    cont.rollback_one_iter()
    after = cont.predict(Xh, raw_score=True)
    score_err = float(np.abs(cont.predict(X1, raw_score=True)
                             + dc.get_init_score()
                             - cont._gbdt.score.cpu().numpy()).max())
    expect(np.array_equal(after, before) and cont.num_trees() == 4
           and score_err <= 1e-5,
           "rollback: %d trees, prediction the 4-iteration one %s, "
           "training score %.3g from it" % (cont.num_trees(),
                                             np.array_equal(after, before),
                                             score_err))
    rec = dict(
        seconds=time.perf_counter() - t, max_abs_diff=float(d.max()),
        mean_abs_diff=float(d.mean()), share_within_jax_tol=within,
        auc_sum=asum, auc_10=a10, launches=counts,
        rollback_score_err=score_err, parted_trees=div["parted"],
        widest_tie_tree=div["tree"], widest_tie_split=div["at"],
        widest_tie_rdiff=div["rdiff"], regions_tree=k, held_trees=upto,
        held_share=float(held.mean()), held_max_abs_diff=dk_max)
    print("api (continue): %d rows; 5 rounds from the 5-round model (init "
          "scores by KP1, %d launches); the ten trees %s; holdout AUC of "
          "the two stages %.6f, the 10-round run's %.6f; raw predictions' "
          "|diff| max %.3g through %d trees on %.6f of the rows (%.3g, mean "
          "%.3g, through all ten on all rows, %.4f of them within the JAX "
          "package's rtol 1e-5, atol 1e-6); rollback_one_iter: 4 trees, "
          "prediction bit for bit the 4-iteration one, training score "
          "within %.3g"
          % (API_ROWS, counts.get("predict_ensemble", 0),
             said_continuation(div), asum, a10, dk_max, upto,
             float(held.mean()), float(d.max()), float(d.mean()), within,
             score_err))
    return rec

def api_phase(X, y, Xh, yh, ds_obj, valid_obj, dev, rounds, base) -> dict:
    """The public training and model API at Higgs width (10.5M x 28,
    PARAMS, 255 leaves), through the entry points a user calls:
    - custom objectives: binary logloss in numpy as fobj (objective=none,
      the training set's init score the built-in run's boost-from-average
      score) against the built-in runs of the training phase with the same
      root and key: f32 with the holdout as a validation set and an AUC
      feval, quantized, and on the label engine; each through
      train_and_check with its path's kernels, the first tree parting the
      training rows as the built-in first tree does (quantized; KP2's leaf
      mode) or its splits the built-in tree's in growth order up to a
      near-tie (f32, TIE_RTOL), the holdout AUC within AUC_DRIFT of the
      built-in run's, and the feval's AUC within 1e-6 of the built-in
      `auc` of the same run every round;
    - a learning-rate schedule (API_RATES), deferred on the carried arena
      (quantized) and eager (f32) with the holdout as a validation set:
      every tree shrunk by its own round's rate, each run capturing its
      unscheduled run's graphs and no more, each model predicting its
      training score within 1e-5 (1M rows), the first trees (the first
      rate is the default) the unscheduled quantized run's bit for bit
      (integer histograms) and the unscheduled valid_f32 run's split for
      split up to a near-tie (a carried f32 tree ends where the arena's
      room does, so it is not the f32 run held here);
    - continued training on the first API_ROWS rows (binned with the
      training set's mappers): a 5-round and a 10-round run, then 5 rounds
      from the 5-round model (init scores by KP1, equal to its prediction);
      the continued booster holds 5 trees, the two stages' ten trees the
      10-round run's split for split up to a near-tie (TIE_RTOL), their
      holdout predictions summed against the 10-round run's (AUC within
      AUC_DRIFT, and raw predictions within CONT_MAX_DIFF where no tree
      parts: the card's f32 histograms add in a varying order, so the
      continued trees are not bitwise the 10-round run's last 5;
      continue_and_rollback); rollback_one_iter
      leaves a prediction bit for bit the 4-iteration one and a training
      score within 1e-5 of it;
    - refit of the training phase's f32 model on the holdout (decay
      REFIT_DECAY) on the card against the CPU's refit of the same text:
      leaf values within 1e-6 of each tree's largest;
    - model text: save_model, Booster(model_file=...) and
      model_from_string give the text back and predictions bit for bit;
      split and gain importance equal a recount from the text;
    - cv: CV_FOLDS folds of the first CV_ROWS rows (a subset of the
      binned set), CV_ROUNDS rounds, the validation logloss falling every
      round;
    - LGBMClassifier(device=..., num_leaves=255, n_estimators=5) on the
      first API_ROWS rows (quantized, whose integer histograms make two
      runs bitwise equal; bins found from SK_BIN_SAMPLE rows), without
      scikit-learn on the card: predict_proba bit for bit `train` with the
      same params, trees past the default 31 leaves, shrinkage 0.1.
    Returns the records."""
    import os
    import tempfile
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import sklearn as lsk
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.metric import auc
    from lightgbm_tpu_torch.objective import create_objective
    from lightgbm_tpu_torch.ops import _cuda

    recs = {}
    n = len(X)
    ds_obj.set_weight(None)
    obj = create_objective("binary", Config(PARAMS))
    obj.init(ds_obj._binned.metadata, n, "cpu")
    init = obj.boost_from_score(0)

    # custom objectives against the built-in runs
    ds_obj.set_init_score(np.full(n, init))
    try:
        for name, (builtin, extra, kpath) in FOBJ_RUNS.items():
            params = dict(PARAMS, objective="none", **extra)
            kw, evals = {}, {}
            if "metric" in extra:
                kw = dict(valid_sets=[valid_obj], valid_names=["holdout"],
                          evals_result=evals, feval=auc_feval)
            must, never = path_kernels(kpath)
            booster, rec = train_and_check(
                name, params, ds_obj, dev, rounds, must, never,
                deferred=not kw, fobj=logloss_fobj, verbose_eval=False,
                **kw)
            g = booster._gbdt
            expect(g.objective is None and g._held
                   and not g._carried_active,
                   "%s: objective %s, held %s, carried %s"
                   % (name, g.objective, g._held, g._carried_active))
            first = hold_first_tree(name, booster, g.models[0],
                                    base["trained"][builtin][0][0],
                                    g._quantized, dev)
            holdout_auc = auc(yh, booster.predict(Xh, raw_score=True))
            gap = abs(holdout_auc - base["auc"][builtin])
            expect(gap <= AUC_DRIFT, "%s: holdout AUC %.6f is %.6f from the "
                   "built-in %s run's" % (name, holdout_auc, gap, builtin))
            msg = ""
            if evals:
                diff = np.abs(np.subtract(evals["holdout"]["feval_auc"],
                                          evals["holdout"]["auc"]))
                expect(len(diff) == rounds and diff.max() <= 1e-6,
                       "%s: feval AUC %s, built-in auc %s"
                       % (name, evals["holdout"]["feval_auc"],
                          evals["holdout"]["auc"]))
                rec["feval_auc"] = evals["holdout"]["feval_auc"]
                msg = "; feval AUC %s (built-in auc within %.3g)" % (
                    ["%.6f" % v for v in evals["holdout"]["feval_auc"]],
                    float(diff.max()))
            rec.update(first, holdout_auc=holdout_auc, builtin_auc_gap=gap)
            print("api (%s): %d rows, %d rounds, leaves %s; train %.3f s "
                  "(%.1f ms a round); %s (%s); holdout AUC %.6f (built-in "
                  "%.6f)%s; graphs x nodes %s; %d drains, %d tree fetches; "
                  "peak %.3f GB"
                  % (name, n, rounds, rec["leaves"], rec["train_s"],
                     rec["round_ms"], said_first_tree(first), builtin,
                     holdout_auc,
                     base["auc"][builtin], msg,
                     ["1 x %d" % x["nodes"] for x in rec["graphs"]],
                     rec["drains"], rec["tree_fetches"],
                     rec["peak_bytes"] / 1e9))
            recs[name] = rec
            del booster, g
            torch.cuda.empty_cache()
    finally:
        ds_obj.set_init_score(None)

    # a learning-rate schedule: deferred on the carried arena, eager with
    # a validation set
    sched = {}
    for name, path, kw in (
            ("schedule_carried", "quantized", {}),
            ("schedule_valid", "valid_f32", dict(
                valid_sets=[valid_obj], valid_names=["holdout"],
                evals_result={}))):
        must, never = path_kernels(path)
        booster, rec = train_and_check(
            name, path_params(path), ds_obj, dev, rounds, must, never,
            deferred=not kw, graphs=base["graphs"][path],
            learning_rates=API_RATES[:rounds], verbose_eval=False, **kw)
        g = booster._gbdt
        shrink = [t.shrinkage for t in g.models]
        expect(shrink[1:] == API_RATES[1:rounds],
               "%s: tree shrinkages %s, the schedule %s"
               % (name, shrink, API_RATES[:rounds]))
        rows = slice(0, API_ROWS)
        err = float(np.abs(booster.predict(X[rows], raw_score=True)
                           - g.score[rows].cpu().numpy()).max())
        expect(err <= 1e-5, "%s: predict is %.3g from the training score"
               % (name, err))
        rec.update(shrinkages=shrink, predict_vs_score=err)
        sched[name] = (booster, rec)
        print("api (%s): learning rates %s; leaves %s; train %.3f s; "
              "shrinkages %s; predict of %d training rows within %.3g of "
              "the training score; graphs x nodes %s (the unscheduled %s "
              "run's: %d); %d drains, %d tree fetches"
              % (name, API_RATES[:rounds], rec["leaves"], rec["train_s"],
                 shrink, API_ROWS, err,
                 ["1 x %d" % x["nodes"] for x in rec["graphs"]], path,
                 base["graphs"][path], rec["drains"], rec["tree_fetches"]))
        recs[name] = rec
    bc, bv, rv = (sched["schedule_carried"][0],) + sched["schedule_valid"]
    # the quantized carried round sums integer histograms, so its first
    # tree is the unscheduled run's bit for bit
    first = bc._gbdt.models[0].to_string()
    expect(first == base["trained"]["quantized"][0][0].to_string(),
           "schedule: the carried quantized run's first tree is not the "
           "unscheduled run's")
    first = hold_first_tree("schedule_valid", bv, bv._gbdt.models[0],
                            base["trained"]["valid_f32"][0][0], False, dev)
    rv.update(first)
    print("api (schedule): the carried quantized run's first tree the "
          "unscheduled run's bit for bit; the eager f32 run's: %s "
          "(unscheduled valid_f32)" % said_first_tree(first))
    del sched, bc, bv
    torch.cuda.empty_cache()

    # continued training and rollback on the first API_ROWS rows
    recs["continue"] = continue_and_rollback(X, y, Xh, yh, ds_obj, dev)
    torch.cuda.empty_cache()

    # refit on the card against the CPU's refit of the same text
    text = base["trained"]["f32"][1]
    t = time.perf_counter()
    _cuda.reset_launch_counts()
    rf = lt.Booster(model_str=text, device=dev).refit(Xh, yh,
                                                      decay_rate=REFIT_DECAY)
    counts = dict(_cuda.LAUNCHES)
    launched(counts, ("predict_ensemble",))
    card_s = time.perf_counter() - t
    rcpu = lt.Booster(model_str=text, device="cpu").refit(
        Xh, yh, decay_rate=REFIT_DECAY)
    err = max(float(np.abs(a.leaf_value[:a.num_leaves]
                           - b.leaf_value[:b.num_leaves]).max()
                    / np.abs(b.leaf_value[:b.num_leaves]).max())
              for a, b in zip(rf._gbdt.models, rcpu._gbdt.models))
    orig = lt.Booster(model_str=text, device="cpu")._gbdt.models
    moved = sum(not np.array_equal(a.leaf_value, b.leaf_value)
                for a, b in zip(rf._gbdt.models, orig))
    expect(err <= 1e-6 and moved == len(orig),
           "refit: leaf values %.3g from the CPU's, %d of %d trees moved"
           % (err, moved, len(orig)))
    recs["refit"] = dict(card_s=card_s, rel_err=err, launches=counts)
    print("api (refit): the f32 model on the %d-row holdout, decay %.1f, "
          "leaves by KP1 on the card (%.2f s): leaf values within %.3g of "
          "the CPU's refit (of each tree's largest), every tree moved"
          % (len(Xh), REFIT_DECAY, card_s, err))

    # model text in and out; importance against a recount from the text
    bst = lt.Booster(model_str=text, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.txt")
        bst.save_model(path)
        loaded = lt.Booster(model_file=path, device=dev)
        with open(path) as f:
            saved = f.read()
    shell = lt.Booster(model_str=base["trained"]["quantized"][1],
                       device=dev).model_from_string(text)
    p = bst.predict(Xh, raw_score=True)
    expect(saved == text and loaded.model_to_string() == text
           and shell.model_to_string() == text
           and np.array_equal(loaded.predict(Xh, raw_score=True), p)
           and np.array_equal(shell.predict(Xh, raw_score=True), p),
           "model text: save, load and model_from_string do not give the "
           "text and predictions back")
    for kind in ("split", "gain"):
        want = text_importance(text, kind, X.shape[1])
        expect(np.array_equal(bst.feature_importance(kind), want),
               "%s importance differs from the text's recount" % kind)
    print("api (model text): save_model, Booster(model_file=...) and "
          "model_from_string give the %d-byte text back, predictions bit "
          "for bit; split and gain importance equal the recount from the "
          "text (top features by gain %s)"
          % (len(text), list(np.argsort(-bst.feature_importance("gain"))
                             [:5])))

    # cv over subsets of the binned set's first CV_ROWS rows
    t = time.perf_counter()
    _cuda.reset_launch_counts()
    res = lt.cv(PARAMS, ds_obj.subset(np.arange(CV_ROWS)),
                num_boost_round=CV_ROUNDS, nfold=CV_FOLDS, device=dev)
    torch.cuda.synchronize()
    counts = dict(_cuda.LAUNCHES)
    launched(counts, ("segment_histogram", "partition_segment",
                      "split_scan", "scatter_segments_add", WALK_ADD))
    means = res.get("binary_logloss-mean", [])
    expect(len(means) == CV_ROUNDS and np.all(np.diff(means) < 0)
           and means[-1] < np.log(2),
           "cv: binary_logloss-mean %s" % means)
    recs["cv"] = dict(seconds=time.perf_counter() - t, result=res,
                      launches=counts)
    print("api (cv): %d folds of %d rows, %d rounds in %.1f s: "
          "binary_logloss-mean %s, -stdv %s (folds %s)"
          % (CV_FOLDS, CV_ROWS, CV_ROUNDS, recs["cv"]["seconds"],
             ["%.6f" % v for v in means],
             ["%.6f" % v for v in res["binary_logloss-stdv"]],
             "stratified" if lsk._SKLEARN else "plain, no scikit-learn"))
    torch.cuda.empty_cache()

    # the scikit-learn wrapper against train with the same params
    X1, y1 = X[:API_ROWS], y[:API_ROWS]
    t = time.perf_counter()
    clf = lt.LGBMClassifier(device=dev, num_leaves=255, n_estimators=5,
                            subsample_for_bin=SK_BIN_SAMPLE,
                            tpu_quantized_grad=True)
    clf.fit(X1, y1)
    proba = clf.predict_proba(Xh)
    ref = lt.train(dict(QPARAMS, bin_construct_sample_cnt=SK_BIN_SAMPLE),
                   lt.Dataset(X1, y1, device=dev), 5, verbose_eval=False,
                   device=dev)
    trees = clf.booster_._gbdt.models
    leaves = [tr.num_leaves for tr in trees]
    shrink = [tr.shrinkage for tr in trees]
    same = np.array_equal(proba[:, 1], ref.predict(Xh))
    expect(same and max(leaves) > 31 and shrink[1:] == [0.1] * 4
           and clf.get_params()["num_leaves"] == 255,
           "sklearn: predict_proba equal to train's %s, leaves %s, "
           "shrinkages %s" % (same, leaves, shrink))
    recs["sklearn"] = dict(seconds=time.perf_counter() - t, leaves=leaves,
                           sklearn=lsk._SKLEARN)
    print("api (sklearn): LGBMClassifier on %d rows %s scikit-learn: "
          "predict_proba bit for bit train's; leaves %s, shrinkages %s "
          "(%.1f s with its binning)"
          % (API_ROWS, "with" if lsk._SKLEARN else "without", leaves,
             shrink, recs["sklearn"]["seconds"]))
    return recs


def phase_start(name: str) -> float:
    """The phase that timed steps count to from now (STEP_S), and the
    time it starts."""
    PHASE[0] = name
    return time.perf_counter()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=ROWS,
                    help="training rows (the widths are never cut)")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--predict-rounds", type=int, default=PREDICT_ROUNDS,
                    help="rounds of the prediction run's model")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import _cuda
    # binning's share of each phase (STEP_S): every dataset of the smoke,
    # a Booster's own included, is binned by construct()
    lt.Dataset.construct = timed("binning")(lt.Dataset.construct)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print("torch %s, CUDA %s, python %s" % (torch.__version__,
                                           torch.version.cuda,
                                           sys.version.split()[0]))
    dev = torch.device("cuda", torch.cuda.current_device())

    t = time.perf_counter()
    log = _cuda.build(verbose=True)
    print("build: %.1f s for %s" % (time.perf_counter() - t,
                                   ", ".join(log["compiled"])))
    for stem, text in sorted(log["output"].items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print("ptxas %s: %s" % (stem, line.strip()))

    t = time.perf_counter()
    X, y, Xh, yh = higgs_like(args.rows)
    ds_obj = lt.Dataset(X, y, params=PARAMS, device=dev).construct()
    print("data: %d x %d generated and binned in %.1f s"
          % (X.shape[0], X.shape[1], time.perf_counter() - t))

    valid_obj = lt.Dataset(Xh, yh, reference=ds_obj, device=dev).construct()
    results = {}
    phase_s = {}
    t = phase_start("kernels")
    for quantized in (False, True):
        kernel_phase(ds_obj._binned, dev, results, quantized)
    leaf_kernel_phase(ds_obj._binned, dev, results)
    ablate_phase(len(X), dev, results)
    phase_s["kernels"] = time.perf_counter() - t
    t = phase_start("parity")
    parity = {path: parity_phase(dev, path) for path in PARITY_PATHS}
    for objective in PARITY_OBJECTIVES:
        parity[objective] = parity_phase(dev, "f32", objective)
    for mode, path in BOOSTING_PARITY_PATHS.items():
        parity[mode] = parity_phase(dev, path, boosting=mode)
    for case in GENERAL_PARITY:
        parity["general_" + case] = general_parity(dev, case, root=0)
    phase_s["parity"] = time.perf_counter() - t
    t = phase_start("training")
    train = {}
    launches = {}
    for path in PATHS:
        booster, launches[path], train[path] = training_phase(
            X, Xh, yh, ds_obj, valid_obj, args.rounds, dev,
            args.rows != ROWS, path)
        train[path]["profile"] = profile_round(booster, path)
        if path == "bagged_f32":
            kp2_phase(booster, dev, results)
        del booster
        torch.cuda.empty_cache()
    for f32 in ("f32", "weighted_f32", "bagged_f32", "valid_f32"):
        q = f32.replace("f32", "quantized")
        gap = abs(train[q]["holdout_auc"] - train[f32]["holdout_auc"])
        expect(gap <= AUC_GAP, "%s holdout AUC is %.4f from the %s run's "
               "(limit %.2f)" % (q, gap, f32, AUC_GAP))
    for path in PATHS:
        drift = abs(train[path]["holdout_auc"] - AUC_BEFORE[path])
        expect(drift <= AUC_DRIFT, "%s holdout AUC %.4f is %.4f from the "
               "last accepted run's %.4f (limit %.3f)"
               % (path, train[path]["holdout_auc"], drift, AUC_BEFORE[path],
                  AUC_DRIFT))
    # the label engine grows the same 255-leaf f32 trees as the partition
    # engine at the pristine root (the valid-set run's)
    for path in ("label_f32", "label_bagged_f32"):
        gap = abs(train[path]["holdout_auc"] - train["valid_f32"]["holdout_auc"])
        expect(gap <= AUC_GAP, "%s holdout AUC is %.4f from the valid_f32 "
               "run's (limit %.2f)" % (path, gap, AUC_GAP))
    phase_s["training"] = time.perf_counter() - t
    t = phase_start("boosting")
    boosting, boost_launches = boosting_phase(X, Xh, yh, ds_obj, valid_obj,
                                              dev)
    phase_s["boosting"] = time.perf_counter() - t
    t = phase_start("general")
    f32_models = TRAINED["f32"][0]
    base = dict(root=int(f32_models[0].split_feature[0]),
                odd_share=split_share(f32_models, range(1, FEATURES, 2)),
                quantized_models=TRAINED["quantized"][0],
                quantized_text=TRAINED["quantized"][1],
                quantized_k2=int(launches["quantized"].get(
                    "segment_histogram_i8", 0)),
                label_auc=train["label_f32"]["holdout_auc"])
    general, general_launches = general_phase(
        X, Xh, yh, ds_obj, valid_obj, dev, args.rounds, base, results)
    phase_s["general"] = time.perf_counter() - t
    t = phase_start("prediction")
    prediction = prediction_phase(X, Xh, ds_obj, dev, args.predict_rounds,
                                  results)
    torch.cuda.empty_cache()
    phase_s["prediction"] = time.perf_counter() - t
    t = phase_start("serving")
    serving = serving_phase(Xh, dev, results)
    torch.cuda.empty_cache()
    phase_s["serving"] = time.perf_counter() - t
    t = phase_start("lambdarank")
    ranking = rank_phase(dev, args.rounds, results)
    phase_s["lambdarank"] = time.perf_counter() - t
    t = phase_start("objectives")
    objectives = objectives_phase(X, y, dev, args.rounds)
    phase_s["objectives"] = time.perf_counter() - t
    t = phase_start("api")
    api = api_phase(X, y, Xh, yh, ds_obj, valid_obj, dev, args.rounds, dict(
        trained=TRAINED, graphs={p: len(train[p]["graphs"]) for p in PATHS},
        auc={p: train[p]["holdout_auc"] for p in PATHS}))
    torch.cuda.empty_cache()
    phase_s["api"] = time.perf_counter() - t
    del X, y, Xh, yh, ds_obj, valid_obj
    torch.cuda.empty_cache()
    t = phase_start("multiclass")
    parity["multiclass"] = parity_phase(dev, "f32", "multiclass")
    mc_rounds = min(args.rounds, MC_ROUNDS)
    multiclass, mc_launches = multiclass_phase(dev, mc_rounds, results)
    parity["multiclass_onehot"] = parity_phase(dev, "f32", "multiclass",
                                               data="onehot")
    efb, efb_launches = efb_runs(dev, mc_rounds, results)
    mc_launches.update(efb_launches)
    phase_s["multiclass"] = time.perf_counter() - t
    t = phase_start("categorical")
    parity["weighted_f32_airline"] = parity_phase(dev, "weighted_f32",
                                                  data="airline")
    categorical, cat_launches = categorical_phase(dev, args.rounds, results)
    mc_launches.update(cat_launches)
    phase_s["categorical"] = time.perf_counter() - t
    print("steps, s: %s" % "; ".join(
        "%s: %s" % (ph, ", ".join(
            "%s %.1f" % (kind, sec) for kind, sec in
            [(k, v) for (p_, k), v in STEP_S.items() if p_ == ph]
            + [("other", total - sum(v for (p_, _), v in STEP_S.items()
                                     if p_ == ph))]))
        for ph, total in phase_s.items()))
    print("phases, s: %s" % ", ".join("%s %.1f" % kv
                                      for kv in phase_s.items()))
    launches.update(mc_launches)
    # launches of each kernel in the run of the path it belongs to: K3's
    # pred mode and K4's set mode in the bagged runs, the int8 modes and K5
    # in the quantized carried run, the f32 modes in the f32 carried run,
    # K7 in the label run; the kernels both carried paths run (K1, K4's add
    # mode) report the quantized run; launches_by_path has every path's
    # run.  The kernels of NO_PATH are on no training path and report 0
    for name, r in results.items():
        if r.get("shape_of") in ("lambdarank", "multiclass", "efb",
                                 "categorical", "general"):
            # counted in the lambdarank fused run (rank_phase), the
            # multiclass f32 run (multiclass_phase), the EFB partition run
            # (efb_runs), the categorical f32 and valid-set runs and the
            # 300-airport label run (categorical_phase), or the general
            # grower's f64 run (general_phase)
            expect(r["launches"] > 0, "kernel %s was not launched on the "
                   "%s path" % (name, r["shape_of"]))
            continue
        r["launches_by_path"] = {p: int(launches[p].get(name, 0))
                                 for p in launches}
        if name in NO_PATH:
            r["launches"] = 0
            r["no_path"] = NO_PATH[name]
            expect(not any(r["launches_by_path"].values()),
                   "kernel %s was launched on a training path" % name)
            continue
        if name in PREDICT_KERNELS:
            # the prediction run's predict on the holdout, and its serving
            # buckets (the small-batch walk)
            expect(r["launches"] > 0, "%s was not launched by predict"
                   % name)
            continue
        if name == "leaf_histogram":
            path = "label_f32"
        elif name == WALK_MASKED:
            path = "bagged_f32"
        elif name == WALK_ADD:
            path = "valid_f32"
        elif name.startswith("partition_segment_pred"):
            path = "bagged_quantized" if name.endswith("_i8") else "bagged_f32"
        elif name == "scatter_segments":
            path = "bagged_f32"
        elif name in ("segment_histogram", "partition_segment",
                      "compact_carry"):
            path = "f32"
        else:
            path = "quantized"
        r["launches"] = int(launches[path].get(name, 0))
        expect(r["launches"] > 0, "kernel %s was not launched on the %s "
               "training path" % (name, path))
    launches.update(boost_launches)
    launches.update(general_launches)
    print(json.dumps({"card": card, "training": train, "parity": parity,
                      "boosting": boosting, "general": general,
                      "lambdarank": ranking, "objectives": objectives,
                      "multiclass": multiclass, "efb": efb,
                      "categorical": categorical, "prediction": prediction,
                      "serving": serving, "api": api, "phase_s": phase_s},
                     default=str))
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failure as exc:
        print("chip_smoke: FAILED: %s" % exc, file=sys.stderr)
        sys.exit(1)
