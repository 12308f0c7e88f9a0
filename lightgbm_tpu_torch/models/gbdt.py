"""GBDT boosting driver of the port's main path.

Port of lightgbm_tpu/models/gbdt.py `_train_one_iter_impl` (:496-687):
gradients on the device, optionally quantized to int8 codes
(`tpu_quantized_grad`), k trees an iteration (one a class for the
multiclass objectives, else one) grown by the partition or the label
engine, shrinkage and boost-from-average, and the trees' host fetch:
deferred wherever nothing reads the host tree within the round, one a tree
otherwise; then prediction (:1672-1858) on the device (ops/predict.py,
KP1) or, asked for, the host walk.  The model text is the reference v2
format, so models load in both packages.

The tree engine is chosen once, as `_setup_tree_engine` (:1209-1345) does
for the serial learner: the partition engine (ops/grow_partition.py) where
it applies and its arena fits the device, the label engine
(ops/grow.grow_tree_label) otherwise or when `tpu_tree_engine=label` asks
for it.  The label engine trains unquantized, as in JAX, and runs every
iteration on the eager path below.

Which path an iteration runs follows the JAX rule (:518-550):

- on the partition engine with no bagging, no validation set and no
  training metric, the fused paths (:533), where every row is in the bag
  and the grower's K4 adds each row's shrunk leaf value to the score
  (emit="score"):
  - carried (`_run_fused_iter_carried`, :904-1016), where `_carried_ok`
    (:847-869, with the objective's `carry_fields` gate) allows it: the
    tree roots at one of two arena slots holding every row in the order
    the previous tree left them, and K6 compacts the finished tree into
    the other slot.  The JAX arena also carries the score and label planes,
    because a TPU cannot cheaply scatter by row id (:838-845); here the
    score stays in row order and K4 updates it, and each tree's gradients,
    computed in row order, are gathered into the slot's order by its row
    ids before they are quantized.  The codes, histograms and carried row
    order equal JAX's;
  - non-carried (`_build_fused_iter`, :719-836): the tree roots at the
    pristine block, for weighted objectives and the other configurations
    `_carried_ok` refuses;
- otherwise the eager path (:593-687), which every round of L1, quantile
  and MAPE takes (their leaves are refit to percentiles of the residuals
  in the round, :519-524, :1568-1589): the bag is drawn (`_bagging`,
  :419-433), the tree grows with per-row leaf ids (the partition engine at
  the pristine root, bagged by K3 in pred mode, quantized under the
  iteration's key unfolded, :1385-1387; or the label engine over the bag
  mask), and the training score adds each row's leaf value, the
  out-of-bag rows' by the binned tree walk KP2 (ops/predict_kernel.
  walk_binned) in the same launch; validation scores follow by KP2's add
  mode, and metrics are evaluated on the host.

The carried arena is entered at the first iteration that may run it and
left for good at the first that may not (:542-550); the score is kept in
row order throughout, so leaving needs no materialization, and the eager
tree's work region may overwrite the carry slots.

On the card a round's device work, from the score to the packed tree, is
one CUDA graph replay (ops/graphs.py; `jit` of `_build_fused_iter` in
JAX): the gradients, the carried gather, the quantization under the
round's key, the grower with its kernels and, on the fused paths, K4's
score update and K6's compaction.  The round's host inputs, the feature
mask and the quantization key, reach the graph through one device buffer
(`_round_inp`), copied from pinned memory before each replay.  The first
round of a path runs eagerly; the first of each graph key (the carried
slot, the path) captures.  The CPU runs the same rounds eagerly.

With k > 1 the training score and every validation score are class-major
[k, n], and every class's gradients come from the score at the round's
start, as JAX computes them once (:595, :740) before it adds any tree
(:777): on the card one graph computes them into the booster's
static [k, n] buffers (`_grad`, `_hess`, `_run_gradients`), then one graph
a class, keyed by the class, grows that class's tree from its row (and on
the fused path K4 adds it into score[kk]).  Each trained class draws its
own feature mask, in class order (:797, :1393); the quantization key is
folded with the class on the fused path (:756) and the same unfolded key
serves every class on the eager path (:1383-1388).  An iteration in which a
class needs no training runs the eager path, as `_fused_eligible`
(:695-702) requires every class; the bag is drawn once an iteration.

Wherever no validation set or training metric reads the host tree within
the round (`deferred_ok`, :520-524), each tree's fetch is deferred as JAX
defers it (`_inflight`, :161-165, :561-572, :623-641): on the fused paths,
and on the eager path's bagged runs and label-engine runs, whose round
ends in its graph with the score updated from the device tree (the
device leaf values times the f32 shrinkage, `_update_train_score_device`,
:1095-1111: over the bag's K4 leaf ids and KP2's walk of the out-of-bag
rows in one masked-add launch, or the label engine's leaf ids and a
gather).  The packed tree is copied to a pinned host buffer behind an
event and a placeholder takes its model slot; every _DRAIN_EVERY rounds,
and at every point that reads the model (`_sync_model`, :1642-1647),
`_drain_inflight` (:1113-1168) unpacks the pending trees and rolls a
degenerate stop back.  The valid-set runs fetch each tree in their round,
as JAX does: the scores add the host tree's f64-shrunk leaf values, the
validation sets' by KP2's add mode on the round's device tree.

The boosting modes subclass this driver on the JAX package's hooks
(models/goss.py, rf.py, dart.py; gbdt.py:419-433, :520, :701, :1515-1517,
:1613-1620): GOSS samples the rows inside the gradients' graph
(`_sample_gradients`) and its sample takes the bag's place (`_bagging`),
so it never runs the fused paths; DART changes old trees every iteration,
so it never defers (`_allow_deferred`); RF drives its own iteration over
gradients taken once.  Where the rounds read held gradients (k > 1, GOSS,
RF), they sit in the booster's `_grad` and `_hess`.

The general grower's options (gbdt.py:340-360, :1170-1208, :1281-1305):
CEGB's coupled penalties live in a device vector of the features used so
far (`_cegb_used`), which each round's grower reads and updates in place,
so the rounds stay deferred and fused (JAX fetches every tree of a CEGB
booster in its round, :520-524, and marks the features on the host,
:653-655: the same vector at every tree); a drain's rollback rebuilds it
from the model that remains.  Forced splits are a static plan of
(leaf, feature, threshold bin, default left) entries mapped on the host,
part of the round graphs' key.  Histogram pooling bounds the partition
engine's cache (`_hist_slots`).  `tpu_double_precision` runs the label
engine in f64: scores, gradients, histograms (K7's f64 payload), scans,
trees and the walks' adds (KP2's f64 scores); the partition engine stays
f32, as in JAX (:1216-1219).  `model_to_if_else` is models/codegen.py's.

The public API's booster surface (gbdt.py:449-605, :1823-2190): custom
gradients (`train_one_iter(gradients, hessians)`, a booster of
objective=none or an fobj), staged from the host into the held `_grad` and
`_hess` and grown on the eager path with no boost-from-average; the
learning rate as the device scalar `_shrink_dev`, which the round graphs
read at replay (K4's add takes a pointer to it), so a schedule captures no
new graph, and each deferred tree keeps the rate of its own round for its
drain (the JAX package shrinks a deferred tree by the rate of its drain,
ROADMAP.md queue 3); `reset_config` for any other parameter; rollback,
refit over KP1's leaf indices, model text, dumps and importances.

Configurations this slice does not run raise NotImplementedError naming the
ROADMAP.md item that will bring them; none is served by a substitute.
"""
from __future__ import annotations

from typing import Callable, Dict, Hashable, List, NamedTuple, Optional, \
    Sequence, Tuple

import json
import threading
from collections import deque

import numpy as np
import torch

from ..config import Config
from ..io.dataset import BinnedDataset
from ..metric import Metric
from ..objective import ObjectiveFunction, create_objective
from ..ops.grow import (BundleMaps, TreeArrays, grow_tree_label,
                        pack_tree_vector, unpack_tree_vector)
from ..ops import quantize as qz
from ..ops import threefry
from ..ops.graphs import RoundGraphs
from ..ops.predict import DeviceEnsemble
from ..ops.quantile import renew_leaf_percentiles
from ..ops.predict_kernel import walk_binned
from ..ops.grow_partition import grow_tree_partition
from ..ops.partition_kernel import (TILE, Arena, arena_bytes, init_pristine,
                                    pristine_work0, scatter_segments)
from ..ops.split import SplitParams
from ..ops.split_kernel import params_vector
from ..utils import log
from .tree import K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK, Tree

K_EPSILON = 1e-15
# rounds between bulk fetches of the fused paths' deferred trees
# (lightgbm_tpu/models/gbdt.py:40)
_DRAIN_EVERY = 48


class _DatasetState:
    """A validation set's device state (ScoreUpdater, score_updater.hpp;
    lightgbm_tpu/models/gbdt.py:52-104): its bins (group columns with EFB)
    and bundle maps for the tree walk and its raw scores, class-major
    [k, n] in row order (`score`: [n] for k = 1, as the GBDT's), in the
    booster's score type."""

    def __init__(self, ds: BinnedDataset, device, k: int,
                 dtype=torch.float32):
        self.bins = ds.device_bins(device)
        self.num_bins = torch.as_tensor(ds.feature_num_bins(), device=device)
        self.default_bins = torch.as_tensor(
            np.array([m.default_bin for m in ds.bin_mappers], np.int32),
            device=device)
        self.bundle = bundle_maps(ds, device)
        self.scores = init_score_matrix(ds, k, device, dtype)

    @property
    def score(self) -> torch.Tensor:
        return self.scores[0] if self.scores.shape[0] == 1 else self.scores

    def add_constant(self, val: float, class_id: int) -> None:
        self.scores[class_id].add_(val)


def check_supported(cfg: Config) -> None:
    """Raise NotImplementedError for a configuration this slice does not
    run, naming the ROADMAP.md item that brings it."""
    def no(what: str, item: str) -> None:
        raise NotImplementedError("%s is not ported yet (ROADMAP.md %s)"
                                  % (what, item))

    if cfg.tree_learner != "serial" or cfg.num_machines > 1:
        no("the %s tree learner" % cfg.tree_learner,
           "queue 1, item 12: parallel learners")


class Sample(NamedTuple):
    """An iteration's row sampling (`GBDT._sample_gradients`): what keys
    its graph, its threefry key (staged to the device with the round's
    inputs), and fn(grad, hess, key) -> (grad, hess), the device half run
    inside the gradients' graph, which also writes the sample's predicate
    into `_bag_pred`."""
    key: Hashable
    words: Tuple[int, int]
    fn: Callable


class GBDT:
    """The boosting driver (gbdt.h:24-470)."""

    sub_model_name = "tree"
    # a subclass that changes old trees within an iteration fetches every
    # tree in its round (DART; gbdt.py:520)
    _allow_deferred = True
    # rounds read the gradients from `_grad` and `_hess` (GOSS, RF; and
    # every booster of k > 1 trees an iteration)
    _holds_gradients = False

    def __init__(self, config: Config, train_set: Optional[BinnedDataset],
                 objective: Optional[ObjectiveFunction], device):
        self.config = config
        self.objective = objective
        self.device = torch.device(device)
        # the score, gradient and label-engine type (gbdt.py:155)
        self.dtype = (torch.float64 if config.tpu_double_precision
                      else torch.float32)
        self.models: List[Tree] = []
        self.iter = 0
        self.num_class = config.num_class
        self.num_tree_per_iteration = (
            objective.num_model_per_iteration if objective is not None
            else config.num_class)
        self.shrinkage_rate = config.learning_rate
        self.max_feature_idx = 0
        self.label_idx = 0
        self.feature_names: List[str] = []
        self.feature_infos: List[str] = []
        # a model of boosting=rf predicts the mean of its trees
        # (gbdt.py:1748-1751); loaded from model text, not trained here
        self.average_output = False
        # the device ensemble cached on (len(models), _model_gen): a load
        # and every drain bump the generation; the lock makes one model
        # state build one ensemble when several threads predict at once
        self._model_gen = 0
        self._dev_ens_cache: Optional[tuple] = None
        self._dev_ens_lock = threading.Lock()
        self._feat_rng = np.random.RandomState(config.feature_fraction_seed)
        # bagging (gbdt.py:159, :419-433): one RandomState per booster; the
        # bag as the JAX mask (int32 [n]: 0 in the bag, -1 out), its
        # predicate on the device (uint8 [n]) and its row count
        self._bag_rng = np.random.RandomState(config.bagging_seed)
        self._bag_mask: Optional[np.ndarray] = None
        self._bag_pred: Optional[torch.Tensor] = None
        self._bag_count: Optional[int] = None
        self.train_metrics: List[Metric] = []
        self.valid_states: List[Tuple[str, _DatasetState, List[Metric]]] = []
        self._truncation_warned = False
        self._quantized = False
        self._use_partition_engine = False
        self.arena: Optional[Arena] = None
        # None until the first iteration that may run the carried arena
        # decides (gbdt.py:548-551); False for good once it is left
        self._carried_active: Optional[bool] = None
        # the deferred pipeline (gbdt.py:161-165): pending fused rounds,
        # the stop a drain found, and the fetches made
        self._inflight: List[dict] = []
        self._deferred_stopped = False
        self._drains = 0
        self._tree_fetches = 0
        # pinned host buffers on the card, one entry per pending round:
        # its inputs, its k packed trees and the event of their copies
        self._ring: List[dict] = []
        if train_set is not None:
            self._setup_train(train_set)

    def _setup_train(self, ds: BinnedDataset) -> None:
        cfg = self.config
        check_supported(cfg)
        if ds.num_features == 0:
            raise ValueError("the dataset has no feature with more than one "
                             "bin")
        dev = self.device
        self.train_set = ds
        self.num_data = n = ds.num_data
        self.max_feature_idx = ds.num_total_features - 1
        self.feature_names = list(ds.feature_names)
        self.feature_infos = _feature_infos(ds)
        if self.objective is not None:
            self.objective.init(ds.metadata, n, dev)
        # bins per histogram column: the largest group's or feature's
        self.max_bin = ds.hist_max_bin()
        L = max(cfg.num_leaves, 2)
        self.split_params = split_params(cfg)
        self.num_bins = torch.as_tensor(ds.feature_num_bins(), device=dev)
        self.default_bins = torch.as_tensor(
            np.array([m.default_bin for m in ds.bin_mappers], np.int32),
            device=dev)
        self.missing_types = torch.as_tensor(
            np.array([m.missing_type for m in ds.bin_mappers], np.int32),
            device=dev)
        self.monotone = (None if ds.monotone_constraints is None else
                         torch.as_tensor(ds.monotone_constraints.astype(
                             np.int32), device=dev))
        self.penalty = (None if ds.feature_penalty is None else
                        torch.as_tensor(ds.feature_penalty.astype(np.float32),
                                        device=dev))
        # the EFB maps and the bin-type vector (gbdt.py:106-125, :330-336):
        # None when the dataset has no bundle or no categorical feature, so
        # the growers keep the numerical paths
        self.bundle = bundle_maps(ds, dev)
        cat = ds.is_categorical
        self.is_categorical = (torch.as_tensor(cat, device=dev)
                               if cat.any() else None)
        # the width of a tree's cat_mask
        self._cat_w = self.max_bin if self.is_categorical is not None else 0
        k = self.num_tree_per_iteration
        self.scores = init_score_matrix(ds, k, dev, self.dtype)
        # a booster of objective=none takes every round's gradients from
        # the host (a custom objective)
        self._held = False
        if k > 1 or self._holds_gradients or self.objective is None:
            self._hold_gradients()
        # the pinned staging of custom gradients and its copies' event
        self._grad_stage = self._grad_event = None
        self.max_leaves = L
        self._pvec = params_vector(self.split_params, dev)
        # the shrinkage in the score's type, for the device score updates
        self._shrink_dev = torch.tensor(self.shrinkage_rate,
                                        dtype=self.dtype, device=dev)
        # K4's shrinkage for the host trees' exact adds (s = 1)
        self._one = torch.ones((), dtype=torch.float32, device=dev)
        self._setup_cegb(ds)
        self._forced_splits = self._load_forced_splits()
        # the round's host inputs on the device, a row a class: the
        # quantization key's two words, then the feature mask (ops/graphs.py's
        # static inputs); a last row whose first two words are the sampling
        # key (GOSS)
        self._round_inp = torch.zeros((k + 1, 2 + ds.num_features),
                                      dtype=torch.int64, device=dev)
        self._graphs = RoundGraphs(dev)
        self._hist_slots = 0
        self._setup_tree_engine()
        self._quantized = bool(cfg.tpu_quantized_grad
                               and self._use_partition_engine)
        self._quant_seed = int(cfg.tpu_quantized_seed or cfg.seed)
        if cfg.tpu_quantized_grad and not self._quantized:
            log.warning("tpu_quantized_grad requires the partition engine; "
                        "training unquantized on the label engine")
        if self._quantized and not qz.overflow_safe(
                n, bits=cfg.tpu_quantized_bits):
            # gbdt.py:1346-1357: the JAX package sums codes in f32, which
            # rounds past this many rows in one bin; the port sums in int32
            log.warning(
                "tpu_quantized_grad: %d rows exceed the single-bin "
                "integer-exactness envelope of f32 code sums (%d rows/bin); "
                "the port's int32 histograms stay exact, the JAX package's "
                "may round if one bin captures more than that", n,
                qz.exact_rows(cfg.tpu_quantized_bits))
        if self._renews():
            # the residuals' raw label of the leaf refits (gbdt.py:1568-1589)
            self._renew_label = torch.as_tensor(
                np.asarray(ds.metadata.label), device=dev).to(self.dtype)
        if self._use_partition_engine:
            # pristine layout (gbdt.py:1281-1282): factor >= 4 covers the
            # pristine block, the redirected root copy and the bump region
            # the arena stores the group columns (gbdt.py:1274)
            self.arena = Arena(n, ds.num_groups, self._arena_factor(), dev,
                               quantized=self._quantized)
            init_pristine(self.arena, ds.device_bins(dev).t())

    def _hold_gradients(self) -> None:
        """From now on every round reads its gradients from the booster's
        [k, n] `_grad` and `_hess` (k > 1, GOSS, RF, custom gradients); a
        booster that held none drops its graphs, whose rounds computed
        them."""
        if self._held:
            return
        if hasattr(self, "_graphs"):
            self._graphs.reset()
        self._held = True
        shape = tuple(self.scores.shape)
        self._grad = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self._hess = torch.zeros(shape, dtype=self.dtype, device=self.device)

    def _renews(self) -> bool:
        """The objective refits leaves to percentiles (L1, quantile,
        MAPE); never without an objective."""
        return (self.objective is not None
                and self.objective.is_renew_tree_output())

    @property
    def score(self) -> torch.Tensor:
        """The training score in row order: [n] f32 for one tree an
        iteration, class-major [k, n] for k (JAX's `train_state.score[0]`
        and `.score`); a view of `scores`, [k, n] for every k."""
        return self.scores[0] if self.num_tree_per_iteration == 1 \
            else self.scores

    def set_learning_rate(self, rate: float) -> None:
        """The shrinkage of the next rounds (basic.py:491-499's cheap
        path): the device scalar the round graphs read at replay follows
        it, so no graph is captured anew; each pending deferred tree keeps
        its own round's rate."""
        self.shrinkage_rate = rate
        if hasattr(self, "_shrink_dev"):
            self._shrink_dev.fill_(rate)

    def reset_config(self, config: Config) -> None:
        """Any other parameter (basic.py:500-504): the model synced, the
        config, learning rate and split parameters (K1's vector) rebuilt,
        and the captured graphs dropped, since a capture bakes the split
        parameters in; the next round of each key captures anew."""
        self._sync_model()
        self.config = config
        self.set_learning_rate(config.learning_rate)
        if not hasattr(self, "train_set"):
            return
        self.split_params = split_params(config)
        self._pvec = params_vector(self.split_params, self.device)
        self._graphs.reset()

    def _arena_factor(self) -> int:
        return max(self.config.tpu_arena_factor, 4)

    def _setup_cegb(self, ds: BinnedDataset) -> None:
        """gbdt.py:340-359: the coupled penalties, given by raw feature,
        mapped to the used features and scaled by cegb_tradeoff, and the
        used-feature vector, which lives for the whole ensemble as the
        reference's SerialTreeLearner member (serial_tree_learner.cpp:
        534-536); on the device, read and updated by each round's grower.
        Saving it with the model is checkpointing's (ROADMAP.md queue 1,
        item 14).  The lazy penalty warns and is ignored, as in JAX."""
        cfg = self.config
        F = ds.num_features
        self._cegb_coupled = self._cegb_used = None
        coupled = cfg.cegb_penalty_feature_coupled
        if coupled:
            if len(coupled) != ds.num_total_features:
                log.fatal("cegb_penalty_feature_coupled size (%d) must equal "
                          "num_total_features (%d)"
                          % (len(coupled), ds.num_total_features))
            vec = np.array([coupled[ds.real_feature_index[f]]
                            for f in range(F)], np.float64)
            self._cegb_coupled = torch.as_tensor(
                cfg.cegb_tradeoff * vec, device=self.device).to(self.dtype)
            self._cegb_used = torch.zeros(F, dtype=torch.bool,
                                          device=self.device)
        if cfg.cegb_penalty_feature_lazy:
            log.warning("cegb_penalty_feature_lazy is not supported yet; "
                        "ignoring it")

    def _load_forced_splits(self) -> tuple:
        """forcedsplits_filename's JSON as the static BFS plan of (leaf,
        inner feature, threshold bin, default left) entries, thresholds
        mapped to bins by the feature's BinMapper (gbdt.py:1170-1208,
        ForceSplits, serial_tree_learner.cpp:593-751); a split on an
        unused feature warns and is skipped."""
        fname = self.config.forcedsplits_filename
        if not fname:
            return ()
        with open(fname) as f:
            root = json.load(f)
        if not root:
            return ()
        ds = self.train_set
        raw_to_inner = {raw: inner for inner, raw in
                        enumerate(ds.real_feature_index)}
        plan = []
        num_leaves = 1
        q = deque([(0, root)])
        while q:
            leaf, node = q.popleft()
            raw_f = int(node["feature"])
            if raw_f not in raw_to_inner:
                log.warning("forced split on unused feature %d skipped", raw_f)
                continue
            inner = raw_to_inner[raw_f]
            thr_bin = int(ds.bin_mappers[inner].value_to_bin(
                float(node["threshold"])))
            plan.append((leaf, inner, thr_bin,
                         bool(node.get("default_left", False))))
            right_leaf = num_leaves
            num_leaves += 1
            if node.get("left"):
                q.append((leaf, node["left"]))
            if node.get("right"):
                q.append((right_leaf, node["right"]))
        return tuple(plan)

    def _setup_tree_engine(self) -> None:
        """gbdt.py:1209-1345, the serial learner: the partition engine
        needs f32, max_bin <= 256, a feature and fewer than 2^24 rows;
        `partition` on an input it cannot take warns and takes the label
        engine; `auto` takes the partition engine where it applies and its
        arena fits the device's memory budget (the JAX package's TPU
        branch, with the card in the TPU's place and the VMEM terms, which
        exist only on a TPU, dropped).  The histogram cache is pooled
        (`_hist_slots`) by histogram_pool_size, or at a quarter of the
        budget when one slot a leaf would exceed it; forced splits need
        the dense cache and turn pooling off with a warning."""
        cfg = self.config
        base_ok = (self.dtype == torch.float32 and self.max_bin <= 256
                   and self.train_set.num_features > 0
                   and self.num_data < (1 << 24))
        budget = device_memory_budget(self.device)
        L = self.max_leaves
        entry_bytes = self.train_set.num_groups * max(self.max_bin, 2) * 12
        if cfg.histogram_pool_size > 0:
            slots = int(cfg.histogram_pool_size * (1 << 20)
                        / max(entry_bytes, 1))
        elif L * entry_bytes > 0.25 * budget:
            slots = int(0.25 * budget / max(entry_bytes, 1))
        else:
            slots = L
        hist_slots = 0 if slots >= L else max(4, slots)
        pooling_blocked = bool(self._forced_splits and hist_slots)
        if pooling_blocked:
            hist_slots = 0
        need = arena_bytes(self.num_data, self.train_set.num_groups,
                           self._arena_factor(), hist_slots or L,
                           self.max_bin, bool(cfg.tpu_quantized_grad))
        eng = choose_tree_engine(cfg.tpu_tree_engine, base_ok, need, budget)
        self._use_partition_engine = eng == "partition"
        if self._use_partition_engine:
            self._hist_slots = hist_slots
            # the splits whose parent missed the pool, summed over the run
            self._pool_misses = torch.zeros(1, dtype=torch.long,
                                            device=self.device)
            if pooling_blocked:
                log.warning("forced splits disable histogram pooling (dense "
                            "per-leaf cache required)")

    def _carried_ok(self) -> bool:
        """gbdt.py:847-869: one tree an iteration, the objective's carry
        gate, and a bump region past both root slots of at least 2
        align(n) columns."""
        if self.num_tree_per_iteration != 1 or not self.objective.carry_ok():
            return False
        n_al = -(-self.num_data // TILE) * TILE
        bump0 = pristine_work0(self.num_data) + 2 * (n_al + TILE)
        return self.arena.cap - bump0 >= 2 * n_al

    def _init_carried(self) -> None:
        """gbdt.py:871-902: two root slots past the pristine block, the bump
        region past both; slot 0 gets a copy of the pristine rows."""
        n = self.num_data
        n_al = -(-n // TILE) * TILE
        s0 = pristine_work0(n)
        self._carry_slots = (s0, s0 + n_al + TILE)
        self._carry_bump0 = self._carry_slots[1] + n_al + TILE
        self._carry_parity = 0
        a = self.arena
        a.bins[:, s0:s0 + n] = a.bins[:, :n]
        a.rid[s0:s0 + n] = a.rid[:n]

    # ------------------------------------------------------------------ #
    def _feature_sample(self) -> np.ndarray:
        frac = self.config.feature_fraction
        F = self.train_set.num_features
        mask = np.ones(F, bool)
        if frac < 1.0:
            used = max(1, int(round(F * frac)))
            idx = self._feat_rng.choice(F, used, replace=False)
            mask = np.zeros(F, bool)
            mask[idx] = True
        return mask

    def _slot(self) -> Optional[dict]:
        """The pinned ring entry of the next pending round on the card
        (None on the CPU): its inputs and one buffer a class for its
        packed trees.  A drain, which waits on every pending copy, frees
        them all."""
        if self.device.type != "cuda":
            return None
        i = len({ent["it"] for ent in self._inflight})
        while len(self._ring) <= i:
            self._ring.append(dict(
                inp=torch.empty(self._round_inp.shape, dtype=torch.int64,
                                pin_memory=True),
                out=[None] * self.num_tree_per_iteration,
                event=torch.cuda.Event()))
        return self._ring[i]

    def _stage_inputs(self, slot: Optional[dict], classes: Sequence[int],
                      keys: Sequence,
                      sample: Optional[Sample] = None) -> None:
        """The round's feature masks, one a trained class drawn in class
        order, and quantization keys into `_round_inp`'s rows of those
        classes, and the sample's key into its last row, through the slot's
        pinned buffer on the card."""
        vals = np.zeros(self._round_inp.shape, np.int64)
        for kk, key in zip(classes, keys):
            if key is not None:
                vals[kk, :2] = key
            vals[kk, 2:] = self._feature_sample()
        if sample is not None:
            vals[-1, :2] = sample.words
        if slot is None:
            self._round_inp.copy_(torch.from_numpy(vals))
            return
        slot["inp"].numpy()[:] = vals
        self._round_inp.copy_(slot["inp"], non_blocking=True)

    def _to_host(self, packed: torch.Tensor, slot: Optional[dict],
                 class_id: int):
        """Start a packed tree's copy to the host: (host tensor, event to
        wait on, recorded after this copy and so after the round's earlier
        ones).  On the CPU the round's own output is the host tensor, with
        no event."""
        if slot is None:
            return packed, None
        out = slot["out"]
        if out[class_id] is None:
            out[class_id] = torch.empty(packed.shape, dtype=packed.dtype,
                                        pin_memory=True)
        out[class_id].copy_(packed, non_blocking=True)
        slot["event"].record()
        return out[class_id], slot["event"]

    def _unpack(self, host: torch.Tensor) -> TreeArrays:
        """A fetched packed tree as host TreeArrays; warns once when the
        arena truncated it."""
        arrays, truncated = unpack_tree_vector(
            host.numpy(), self.max_leaves, self._cat_w,
            np.float64 if self.dtype == torch.float64 else np.float32)
        if truncated and not self._truncation_warned:
            self._truncation_warned = True
            log.warning("Tree growth truncated at %d leaves by partition-"
                        "arena overflow; raise tpu_arena_factor",
                        int(arrays.num_leaves))
        return arrays

    def _boost_from_average(self, class_id: int) -> float:
        """gbdt.py:1545-1566: the objective's init score of the class (a
        percentile of the labels for L1, quantile and MAPE, the log of the
        class prior for softmax) added to the class's scores before its
        first tree."""
        if (self.models or self.objective is None
                or self.train_set.metadata.init_score is not None):
            return 0.0
        if self.config.boost_from_average:
            init_score = self.objective.boost_from_score(class_id)
            if abs(init_score) > K_EPSILON:
                self._add_constant(init_score, class_id)
                log.info("Start training from score %f", init_score)
                return init_score
        elif self.objective.is_renew_tree_output():
            log.warning("Disabling boost_from_average in %s may cause the slow "
                        "convergence", self.objective.name)
        return 0.0

    def _renew_tree_output(self, tree: Tree, class_id: int,
                           leaf_ids: torch.Tensor) -> None:
        """The percentile leaf refits of L1, quantile and MAPE (gbdt.py:
        1568-1589, serial_tree_learner.cpp:850-928): each leaf's value
        becomes the (weighted) percentile of its rows' residuals against
        the baseline score (`_renew_baseline_score`), all leaves in one
        pass on the device (ops/quantile.py); rows out of the bag (leaf id
        -1) take no part."""
        residual = self._renew_label - self._renew_baseline_score(class_id)
        vals = renew_leaf_percentiles(
            residual, leaf_ids, self.objective.renew_alpha(),
            self.max_leaves, self.objective.renew_weights())
        nl = tree.num_leaves
        tree.leaf_value[:nl] = vals[:nl].double().cpu().numpy()

    def _renew_baseline_score(self, class_id: int) -> torch.Tensor:
        """The leaf refits' baseline (gbdt.py:1613-1620): the class's score
        before this tree; RF overrides it with its constant init score."""
        return self.scores[class_id]

    def _add_constant(self, val: float, class_id: int) -> None:
        """Add val to the class's training score and validation scores."""
        self.scores[class_id].add_(val)
        for _, vs, _m in self.valid_states:
            vs.add_constant(val, class_id)

    def _bagging(self, it: int) -> Optional[torch.Tensor]:
        """gbdt.py:419-433: every bagging_freq iterations a new bag of
        int(bagging_fraction * n) rows drawn without replacement by the
        booster's one RandomState; between draws the bag persists.  Returns
        the in-bag predicate (uint8 [n] on the device, one buffer that each
        draw rewrites: a graph's static input), or None without
        bagging."""
        cfg = self.config
        n = self.num_data
        if cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0 \
                and it % cfg.bagging_freq == 0:
            bag_cnt = int(cfg.bagging_fraction * n)
            idx = self._bag_rng.choice(n, bag_cnt, replace=False)
            mask = np.full(n, -1, np.int32)
            mask[idx] = 0
            self._bag_mask = mask
            pred = torch.from_numpy((mask == 0).astype(np.uint8))
            if self._bag_pred is None:
                self._bag_pred = torch.empty(n, dtype=torch.uint8,
                                             device=self.device)
            self._bag_pred.copy_(pred)
            self._bag_count = bag_cnt
        elif cfg.bagging_freq <= 0 or cfg.bagging_fraction >= 1.0:
            self._bag_mask = self._bag_pred = self._bag_count = None
        return self._bag_pred

    def _sample_gradients(self) -> Optional[Sample]:
        """The iteration's row sampling (gbdt.py:1515-1517), asked on the
        eager path before the gradients: None keeps every row; GOSS
        overrides it."""
        return None

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """One boosting iteration, k trees; True when training cannot
        continue (no class grew a tree).  On the deferred paths that is
        known when the iteration's trees are drained, so a later call
        returns True and the drain rolls the iterations from the
        degenerate one on back (gbdt.py:504-510).  gradients, hessians:
        the host's class-major [k*n] custom gradients (gbdt.py:514-515,
        :594-605), which skip boost-from-average and the fused paths; a
        booster of objective=none needs them."""
        k = self.num_tree_per_iteration
        if len(self._inflight) >= k * _DRAIN_EVERY:
            self._sync_model()
        if self._deferred_stopped:
            return True
        custom = gradients is not None and hessians is not None
        if not custom and self.objective is None:
            log.fatal("a booster of objective=none trains on custom "
                      "gradients: pass fobj to train() or update()")
        init_scores = ([0.0] * k if custom else
                       [self._boost_from_average(kk) for kk in range(k)])
        cfg = self.config
        classes = tuple(kk for kk in range(k)
                        if self.objective is None
                        or self.objective.class_need_train(kk))
        # gbdt.py:518-533, :695-702: the fused paths need every row in the
        # bag, every class trained, the objective's gradients and no host
        # tree within the iteration (no validation set or metric, no leaf
        # refit)
        deferred_ok = (self._allow_deferred and not self.valid_states
                       and not self.train_metrics and not self._renews())
        fused_ok = (deferred_ok and not custom
                    and self._use_partition_engine
                    and len(classes) == k
                    and (cfg.bagging_freq <= 0
                         or cfg.bagging_fraction >= 1.0)
                    and type(self)._sample_gradients
                    is GBDT._sample_gradients)
        if self._carried_active and not fused_ok:
            # left for good (gbdt.py:542-545): the score is in row order,
            # and this tree's work region may overwrite the carry slots
            self._carried_active = False
        if fused_ok and self._carried_active is None:
            self._carried_active = self._carried_ok()
            if self._carried_active:
                self._init_carried()
        keys = [None] * len(classes)
        if self._quantized:
            # the iteration's key: unfolded on the carried path, whose noise
            # follows arena positions (gbdt.py:947-951, :1000), and on the
            # eager path, for every class (:1383-1388); folded with the
            # class on the non-carried fused path (:755-756, :802)
            key = qz.quantize_key(self._quant_seed, self.iter)
            fold = fused_ok and not self._carried_active
            keys = [threefry.fold_in(key, kk) if fold else key
                    for kk in classes]
        sample = None if fused_ok else self._sample_gradients()
        slot = None
        if classes:
            slot = self._slot()
            self._stage_inputs(slot, classes, keys, sample)
        if custom:
            self._stage_gradients(gradients, hessians)
        if fused_ok:
            return self._fused_iter(slot, init_scores)
        return self._eager_iter(slot, init_scores, classes, deferred_ok,
                                sample, custom)

    def _stage_gradients(self, gradients, hessians) -> None:
        """The host's custom gradients (class-major [k*n], any float type)
        into `_grad` and `_hess` in the booster's type, on the card through
        pinned staging whose previous copies are waited for first."""
        self._hold_gradients()
        shape = tuple(self.scores.shape)
        np_type = np.float64 if self.dtype == torch.float64 else np.float32
        grad = np.asarray(gradients, np_type).reshape(shape)
        hess = np.asarray(hessians, np_type).reshape(shape)
        if self.device.type != "cuda":
            self._grad.copy_(torch.from_numpy(grad))
            self._hess.copy_(torch.from_numpy(hess))
            return
        if self._grad_stage is None:
            self._grad_stage = torch.empty((2,) + shape, dtype=self.dtype,
                                           pin_memory=True)
            self._grad_event = torch.cuda.Event()
        else:
            self._grad_event.synchronize()
        host = self._grad_stage.numpy()
        host[0], host[1] = grad, hess
        self._grad.copy_(self._grad_stage[0], non_blocking=True)
        self._hess.copy_(self._grad_stage[1], non_blocking=True)
        self._grad_event.record()

    def _gradients(self):
        """The objective's gradients and hessians of the score ([n] for
        k = 1), as [k, n] in the booster's type (gbdt.py:598-599)."""
        grad, hess = self.objective.get_gradients(self.score)
        return (grad.to(self.dtype).view(self.scores.shape),
                hess.to(self.dtype).view(self.scores.shape))

    def _run_gradients(self, sample: Optional[Sample] = None,
                       custom: bool = False) -> None:
        """Every class's gradients of the round's starting score (with
        `custom`, the staged ones) into the booster's static `_grad` and
        `_hess`, sampled by `sample` under the key in `_round_inp`'s last
        row; one graph on the card a sampling."""
        if custom and sample is None:
            return
        def fn():
            grad, hess = ((self._grad, self._hess) if custom
                          else self._gradients())
            if sample is not None:
                grad, hess = sample.fn(grad, hess, self._round_inp[-1, :2])
            self._grad.copy_(grad)
            self._hess.copy_(hess)
            return (self._grad, self._hess)
        key = ("gradients", tuple(self.scores.shape),
               None if sample is None else sample.key, custom)
        self._graphs.run(key, key, fn)

    def _round(self, parity: Optional[int], emit: str, bagged: bool,
               update: bool, class_id: int):
        """A tree's device work from its gradients to the packed tree: the
        function ops/graphs.py captures.  For k = 1 the round starts from
        the score, computing the objective's gradients itself; for k > 1
        it reads the class's row of `_grad` and `_hess`, which
        `_run_gradients` computed for every class before the first tree
        (and so for GOSS and RF at every k).
        The gradients, on a carried root gathered into its slot's order
        (JAX computes the same elementwise gradients from its carried score
        planes, gbdt.py:931-939), are quantized under the key in the
        class's row of `_round_inp`, and one tree grows under the feature
        mask there by the booster's engine.  The label engine grows over
        the bag mask (0 in the bag, -1 out) and never truncates.
        emit="score" adds the tree into the class's score by the grower's
        K4.  With `update` (the eager path's deferred rounds of a bag or
        the label engine) the round ends with the class's score updated
        from the device tree (gbdt.py:1095-1111): the device leaf values
        times the f32 shrinkage, added over the per-row leaf ids, the
        out-of-bag rows' walked by KP2 in the same masked-add launch.
        Returns (packed tree, the grower's `out`, the tree's device
        arrays...)."""
        cfg = self.config
        n = self.num_data
        dev = self.device
        inp = self._round_inp[class_id]
        mask = inp[2:] != 0
        if not self._held:
            grad, hess = (t[0] for t in self._gradients())
        else:
            grad, hess = self._grad[class_id], self._hess[class_id]
        common = dict(max_leaves=self.max_leaves, max_depth=cfg.max_depth,
                      max_bin=self.max_bin, pvec=self._pvec,
                      is_categorical=self.is_categorical, bundle=self.bundle,
                      max_cat_threshold=cfg.max_cat_threshold,
                      cegb_coupled=self._cegb_coupled,
                      cegb_used=self._cegb_used,
                      forced_splits=self._forced_splits)
        if not self._use_partition_engine:
            row_init = (self._bag_pred.to(torch.int32) - 1 if bagged else
                        torch.zeros(n, dtype=torch.int32, device=dev))
            tree, out = grow_tree_label(
                self.train_set.device_bins(dev), grad, hess, row_init, mask,
                self.num_bins, self.default_bins, self.missing_types,
                self.split_params, self.monotone, self.penalty,
                hist_impl=cfg.tpu_histogram_impl, **common)
            truncated = torch.zeros((), dtype=torch.bool, device=dev)
        else:
            kw = {}
            if parity is not None:
                root0 = self._carry_slots[parity]
                rid = self.arena.rid[root0:root0 + n].long()
                grad, hess = grad[rid], hess[rid]
                kw.update(carried_root=root0,
                          carried_bump0=self._carry_bump0,
                          carry_dst=self._carry_slots[1 - parity])
            if self._quantized:
                grad, hess, g_scale, h_scale = qz.quantize_gradients(
                    grad, hess, inp[:2])
                kw["quant_scales"] = (g_scale, h_scale)
            if emit == "score":
                kw.update(score=self.scores[class_id],
                          shrinkage=self._shrink_dev)
            if bagged:
                kw["in_bag"] = self._bag_pred
            if self._hist_slots:
                kw["pool_misses"] = self._pool_misses
            tree, out, truncated = grow_tree_partition(
                self.arena, grad, hess, mask, self.num_bins,
                self.default_bins, self.missing_types, self.split_params,
                self.monotone, self.penalty, emit=emit,
                hist_slots=self._hist_slots, **kw, **common)
        if update:
            lv = tree.leaf_value * self._shrink_dev
            self._add_leaf_values(lv, out, bagged, tree, class_id)
        return (pack_tree_vector(tree, truncated), out) + tuple(tree)

    def _add_leaf_values(self, lv: torch.Tensor, leaf_ids: torch.Tensor,
                         bagged: bool, tree: TreeArrays,
                         class_id: int) -> None:
        """The class's training score adds lv ([L], the score's type) at each row's
        leaf: over a bag (leaf ids -1 out of it) by KP2's masked add, which
        walks the out-of-bag rows; otherwise by a gather of every row's
        leaf id."""
        score = self.scores[class_id]
        if bagged:
            walk_binned(self.train_set.device_bins(self.device), tree,
                        self.num_bins, self.default_bins, lv=lv,
                        score=score, leaf_ids=leaf_ids, bundle=self.bundle)
        else:
            score.add_(lv[leaf_ids.long()])

    def _run_round(self, parity: Optional[int], emit: str, bagged: bool,
                   update: bool = False, class_id: int = 0):
        """`_round` through the booster's graphs, one a class: (packed
        tree, out, device TreeArrays), all the graph's own until the next
        call of any graph."""
        cfg = self.config
        key = (self._use_partition_engine, parity, emit, bagged, update,
               self._quantized, self.max_leaves, cfg.max_depth, self.max_bin,
               self.num_data, self.train_set.num_features,
               self._forced_splits, self._hist_slots, class_id)
        out = self._graphs.run(
            key, key[:1] + key[2:-1],
            lambda: self._round(parity, emit, bagged, update, class_id))
        return out[0], out[1], TreeArrays(*out[2:])

    def _fused_iter(self, slot, init_scores: List[float]) -> bool:
        """The fused paths' iteration (gbdt.py:719-1016, :561-572): every
        row in the bag, each class's score updated by the grower's K4 in
        add mode (`score += delta * shrink`, :777, without the delta),
        the trees' fetches deferred."""
        k = self.num_tree_per_iteration
        p = self._carry_parity if self._carried_active else None
        if self._held:
            self._run_gradients()
        for kk in range(k):
            packed, _, _ = self._run_round(p, "score", False, class_id=kk)
            self._defer(packed, slot, kk, init_scores[kk])
        if p is not None:
            self._carry_parity = 1 - p
        self.iter += 1
        return False

    def _defer(self, packed: torch.Tensor, slot, class_id: int,
               init_score: float) -> None:
        """Start the packed tree's copy to the host and leave a placeholder
        in its model slot until a drain (gbdt.py:561-572, :623-641).  The
        copy is queued before the next graph runs, which may reuse the
        packed tree's memory.  The entry keeps the round's learning rate,
        which its device score update used, for the drain's shrink."""
        host, event = self._to_host(packed, slot, class_id)
        self.models.append(None)            # placeholder; drained later
        self._inflight.append(dict(host=host, event=event, it=self.iter,
                                   init_score=init_score,
                                   shrink=self.shrinkage_rate,
                                   slot=len(self.models) - 1))

    def _eager_iter(self, slot, init_scores: List[float],
                    classes: Sequence[int], deferred_ok: bool,
                    sample: Optional[Sample], custom: bool = False) -> bool:
        """The eager path's iteration (gbdt.py:593-687, growing through
        `_grow_one_tree`, :1372-1417): the bag, drawn once for every class,
        the pristine root, per-row leaf ids (-1 out of the bag) or, on the
        partition engine without a bag, the leaves' segments.  With
        deferred_ok (no validation set, no training metric) the round
        updates the class's score from the device tree (K4's add in the
        grower without a bag on the partition engine, else
        `_add_leaf_values`) and its fetch is deferred (:623-641).
        Otherwise each tree is fetched in its round, its leaves refit for
        L1, quantile and MAPE (over row-order leaf ids, which the partition
        engine then emits in place of its segments), and the class's scores
        add its host leaf values (:1616-1630): the training score by K4's
        add mode over the segments (ROADMAP queue 1, item 7c), KP2's masked
        add over a bag, or a gather; each validation set's by KP2's add
        mode on the round's device tree.  A class that needs no training
        grows no tree: its first iteration keeps its prior as a constant
        tree (:656-679).  A GOSS sample is drawn with the gradients (the
        staged ones with `custom`) and grows the trees as a bag does
        (:609-610)."""
        k = self.num_tree_per_iteration
        in_bag = self._bagging(self.iter)
        bagged = in_bag is not None
        renew = self._renews()
        if not self._use_partition_engine:
            emit = "leaf_ids"
        elif deferred_ok and not bagged:
            emit = "score"
        else:
            emit = "segments" if not bagged and not renew else "leaf_ids"
        update = deferred_ok and emit != "score"
        if self._held and classes:
            self._run_gradients(sample, custom)
        should_continue = deferred_any = False
        for kk in range(k):
            new_tree, out, arrays = Tree(1), None, None
            if kk in classes:
                packed, out, arrays = self._run_round(None, emit, bagged,
                                                      update, kk)
                if deferred_ok:
                    self._defer(packed, slot, kk, init_scores[kk])
                    deferred_any = True
                    continue
                host_arrays = self._fetch(packed, slot, kk)
                if int(host_arrays.num_leaves) > 1:
                    new_tree = Tree.from_arrays(host_arrays, self.train_set)
            if new_tree.num_leaves > 1:
                should_continue = True
                self._add_host_tree(new_tree, kk, out, arrays, emit, bagged)
                if abs(init_scores[kk]) > K_EPSILON:
                    new_tree.add_bias(init_scores[kk])
            elif len(self.models) < k:
                # the first iteration keeps the class's prior as a constant
                output = (init_scores[kk] if kk in classes
                          else self.objective.boost_from_score(kk))
                new_tree.as_constant(output)
                self._add_constant(output, kk)
            self.models.append(new_tree)
        if deferred_any:
            # continuation decided when this iteration drains
            self.iter += 1
            return False
        if not should_continue:
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            if len(self.models) > k:
                del self.models[-k:]
            return True
        self.iter += 1
        return False

    def _fetch(self, packed: torch.Tensor, slot, class_id: int) -> TreeArrays:
        """The round's packed tree fetched to the host now, as TreeArrays."""
        host, event = self._to_host(packed, slot, class_id)
        if event is not None:
            event.synchronize()
        self._tree_fetches += 1
        return self._unpack(host)

    def _leaf_values(self, tree: Tree) -> torch.Tensor:
        """A host tree's leaf values as [max_leaves] on the device, in the
        score's type (gbdt.py:1623)."""
        host_lv = np.zeros(self.max_leaves,
                           np.float64 if self.dtype == torch.float64
                           else np.float32)
        host_lv[:tree.num_leaves] = tree.leaf_value[:tree.num_leaves]
        return torch.as_tensor(host_lv, device=self.device)

    def _add_host_tree(self, tree: Tree, class_id: int, out, arrays,
                       emit: str, bagged: bool) -> None:
        """A fetched tree of more than one leaf: its leaves refit (L1,
        quantile, MAPE), shrunk, and its host leaf values added to the
        class's scores (gbdt.py:1616-1630, :1623: the f64-shrunk values
        cast to f32)."""
        if self._renews():
            self._renew_tree_output(tree, class_id, out)
        tree.shrink(self.shrinkage_rate)
        lv = self._leaf_values(tree)
        if emit == "segments":
            # s = 1 adds each value exactly as `score += lv[leaf_ids]`
            scatter_segments(self.arena, out, lv, arrays.num_leaves.view(1),
                             self.scores[class_id], shrink=self._one)
        else:
            self._add_leaf_values(lv, out, bagged, arrays, class_id)
        for _, vs, _m in self.valid_states:
            walk_binned(vs.bins, arrays, vs.num_bins, vs.default_bins, lv=lv,
                        score=vs.scores[class_id], bundle=vs.bundle)

    def _drain_inflight(self) -> bool:
        """Materialize the pending deferred trees (gbdt.py:1113-1168),
        iteration by iteration: unpack each, shrink it and add its bias.
        True when a drained iteration was degenerate (no class grew a
        tree): it and every later pending iteration are removed and the
        iteration count rolled back to it, as the eager stop leaves them;
        a degenerate first iteration keeps every class's prior as a
        constant tree.  The training score is then rebuilt from the model
        that remains (`_rebuild_train_score`), as JAX rebuilds it: a
        degenerate iteration added its one leaf's zero value, but under a
        bag or quantized gradients a later pending iteration may still
        have grown a tree whose update the rollback removes."""
        if not self._inflight:
            return False
        pending, self._inflight = self._inflight, []
        self._drains += 1
        self._model_gen += 1
        for ent in pending:
            if ent["event"] is not None:
                ent["event"].synchronize()
        k = self.num_tree_per_iteration
        groups: Dict[int, List[dict]] = {}
        for ent in pending:
            groups.setdefault(ent["it"], []).append(ent)
        for it in sorted(groups):
            any_grew = False
            for ent in groups[it]:
                host_arrays = self._unpack(ent["host"])
                slot = ent["slot"]
                tree = Tree(1)
                if int(host_arrays.num_leaves) > 1:
                    tree = Tree.from_arrays(host_arrays, self.train_set)
                    tree.shrink(ent["shrink"])
                    if abs(ent["init_score"]) > K_EPSILON:
                        tree.add_bias(ent["init_score"])
                    any_grew = True
                elif slot < k:
                    tree.as_constant(ent["init_score"])
                    self._add_constant(ent["init_score"], slot % k)
                self.models[slot] = tree
            if not any_grew:
                log.warning("Stopped training because there are no more "
                            "leaves that meet the split requirements")
                first = min(e["slot"] for e in groups[it])
                # the very first iteration's constant trees are kept
                del self.models[max(first, k):]
                self.iter = it
                self._rebuild_train_score()
                self._rebuild_cegb_used()
                return True
        return False

    def _rebuild_cegb_used(self) -> None:
        """The CEGB used-feature vector of the model that remains after a
        rollback: the features its trees split on (JAX marks them as each
        tree is fetched, gbdt.py:653-655)."""
        if self._cegb_used is None:
            return
        used = np.zeros(self.train_set.num_features, bool)
        for tree in self.models:
            used[tree.split_feature_inner[:tree.num_leaves - 1]] = True
        self._cegb_used.copy_(torch.from_numpy(used))

    def _rebuild_train_score(self) -> None:
        """The training score recomputed from the model (gbdt.py:
        1047-1059): the init score, then every tree's host leaf values,
        tree i into class i % k, by KP2's add mode over the training
        bins."""
        k = self.num_tree_per_iteration
        self.scores.copy_(init_score_matrix(self.train_set, k, self.device,
                                            self.dtype))
        for i, tree in enumerate(self.models):
            self._add_train_tree_score(tree, i % k)

    def _add_train_tree_score(self, tree: Tree, class_id: int) -> None:
        """Add a host tree's output to the class's training score by KP2's
        add mode over the training bins."""
        _walk_add(self.train_set.device_bins(self.device), self.num_bins,
                  self.default_bins, self.scores[class_id], tree,
                  self.bundle, self.max_bin)

    def _sync_model(self) -> None:
        """Drain the pending trees before the model is read
        (gbdt.py:1642-1647); a stop found here ends training at the next
        round."""
        if self._drain_inflight():
            self._deferred_stopped = True

    # ------------------------------------------------------------------ #
    # validation sets and metrics (gbdt.py:398-414, :1649-1667, :2233-2243)
    # ------------------------------------------------------------------ #
    def add_valid(self, name: str, valid_set: BinnedDataset,
                  metrics: Sequence[Metric]) -> None:
        """Attach a validation set binned with the training set's mappers;
        the model so far is replayed onto its score, tree i into class
        i % k."""
        self._sync_model()
        k = self.num_tree_per_iteration
        state = _DatasetState(valid_set, self.device, k, self.dtype)
        for m in metrics:
            m.init(valid_set.metadata, valid_set.num_data)
        for i, tree in enumerate(self.models):
            self._add_tree_score(state, tree, i % k)
        self.valid_states.append((name, state, list(metrics)))

    def _add_tree_score(self, state: _DatasetState, tree: Tree,
                        class_id: int) -> None:
        """Add a host tree's output to a dataset's class score by KP2's add
        mode on the device (gbdt.py:2233-2243)."""
        _walk_add(state.bins, state.num_bins, state.default_bins,
                  state.scores[class_id], tree, state.bundle, self.max_bin)

    def eval_train(self) -> Dict[str, List[float]]:
        self._sync_model()
        return self._eval_state(self.scores, self.train_metrics)

    def eval_valid(self) -> Dict[str, Dict[str, List[float]]]:
        self._sync_model()
        return {name: self._eval_state(vs.scores, metrics)
                for name, vs, metrics in self.valid_states}

    def _eval_state(self, score: torch.Tensor,
                    metrics: Sequence[Metric]) -> Dict[str, List[float]]:
        """The metrics of a [k, n] score: the row for k = 1, the class-major
        [k*n] flattening for k > 1 (gbdt.py:1664)."""
        out = {}
        if not metrics:
            return out
        score = score[0] if score.shape[0] == 1 else score.reshape(-1)
        flat = None
        for m in metrics:
            # NDCG runs on the score's device; the rest on a host copy
            if getattr(m, "takes_tensor", False):
                out[m.name] = m.eval(score, self.objective)
                continue
            if flat is None:
                flat = score.cpu().numpy().astype(np.float64)
            out[m.name] = m.eval(flat, self.objective)
        return out

    @property
    def current_iteration(self) -> int:
        self._sync_model()
        return len(self.models) // max(self.num_tree_per_iteration, 1)

    def num_model_per_iteration(self) -> int:
        return self.num_tree_per_iteration

    def num_trees(self) -> int:
        self._sync_model()
        return len(self.models)

    # ------------------------------------------------------------------ #
    # prediction on raw features (gbdt.py:1672-1858)
    # ------------------------------------------------------------------ #
    def _check_features(self, X, float32: bool = False) -> np.ndarray:
        """X as a C-contiguous f64 matrix, or with float32 a float32 array
        kept float32 (the device walk widens each value to f64 where it
        compares it, which is exact); raises when it has too few
        features."""
        keep = float32 and isinstance(X, np.ndarray) and \
            X.dtype == np.float32
        X = np.ascontiguousarray(X if keep else np.asarray(X, np.float64))
        if X.ndim != 2 or X.shape[1] <= self.max_feature_idx:
            log.fatal("The number of features in data (%d) is not the same "
                      "as it was in training data (%d)"
                      % (X.shape[1] if X.ndim == 2 else 0,
                         self.max_feature_idx + 1))
        return X

    def _iterations(self, num_iteration: int) -> int:
        total = len(self.models) // max(self.num_tree_per_iteration, 1)
        return total if num_iteration <= 0 else min(num_iteration, total)

    def predict_raw(self, X, num_iteration: int = -1,
                    early_stop: bool = False, early_stop_freq: int = 10,
                    early_stop_margin: float = 10.0,
                    device: Optional[bool] = None) -> np.ndarray:
        """Raw scores of the first num_iteration iterations (all with
        num_iteration <= 0).  device: None or True walks the device
        ensemble (KP1 on the card; its plain version on a CPU booster),
        False the host trees one by one, as the JAX package lets serving
        pin it.  Both sum in f64 in tree order and agree bit for bit.
        early_stop: a row stops once its margin reaches early_stop_margin
        (2|score| for k = 1, the top score less the second for k > 1),
        checked at the first iteration after every early_stop_freq trees
        (prediction_early_stop.cpp; off for an averaged model).  scipy
        sparse input is densified in chunks."""
        self._sync_model()
        if _issparse(X):
            return _by_dense_chunks(X, lambda x: self.predict_raw(
                x, num_iteration, early_stop=early_stop,
                early_stop_freq=early_stop_freq,
                early_stop_margin=early_stop_margin, device=device))
        X = self._check_features(X, float32=device is not False)
        k = self.num_tree_per_iteration
        iters = self._iterations(num_iteration)
        use_es = early_stop and not self.average_output
        freq = max(early_stop_freq, 1)
        if device is False:
            out = self._predict_host(X, iters, use_es, freq,
                                     early_stop_margin)
        else:
            out = self._device_ensemble().predict_sum(
                X, iters, early_stop_freq=freq if use_es else 0,
                early_stop_margin=early_stop_margin)
        if self.average_output:
            # RF semantics survive model reload (rf.hpp averages outputs)
            out /= max(iters, 1)
        return out[0] if k == 1 else out.T  # [n] or [n, k]

    def _predict_host(self, X: np.ndarray, iters: int, use_es: bool,
                      freq: int, margin: float) -> np.ndarray:
        """[k, n] raw scores by the host walk of each tree, with the
        margin-based early stop of prediction_early_stop.cpp:14-89 (copied
        from lightgbm_tpu/models/gbdt.py:1715-1747): the reference counts
        trees between checks, k a step; the margin is 2|score| for k = 1,
        the top score less the second for k > 1."""
        k = self.num_tree_per_iteration
        n = X.shape[0]
        out = np.zeros((k, n), np.float64)
        active = np.ones(n, bool) if use_es else None
        es_counter = 0
        for it in range(iters):
            if use_es and es_counter >= freq and active.any():
                es_counter = 0
                if k == 1:
                    gap = 2.0 * np.abs(out[0])
                else:
                    part = np.partition(out, k - 2, axis=0)
                    gap = part[k - 1] - part[k - 2]      # top1 - top2
                active &= gap < margin
                if not active.any():
                    break
            rows = X[active] if use_es else X
            if rows.shape[0] == 0:
                break
            for kk in range(k):
                pred = self.models[it * k + kk].predict(rows)
                if use_es:
                    out[kk, active] += pred
                else:
                    out[kk] += pred
            es_counter += k
        return out

    def _device_ensemble(self) -> DeviceEnsemble:
        """The model's walk tables on the booster's device, cached on the
        model's length and generation (gbdt.py:1754-1768); built once per
        model state whatever the threads asking."""
        with self._dev_ens_lock:
            key = (len(self.models), self._model_gen)
            cache = self._dev_ens_cache
            if cache is None or cache[0] != key:
                cache = (key, DeviceEnsemble(
                    self.models, self.num_tree_per_iteration, self.device))
                self._dev_ens_cache = cache
            return cache[1]

    def predict(self, X, num_iteration: int = -1, raw_score: bool = False,
                early_stop: bool = False, early_stop_freq: int = 10,
                early_stop_margin: float = 10.0,
                device: Optional[bool] = None) -> np.ndarray:
        raw = self.predict_raw(X, num_iteration, early_stop=early_stop,
                               early_stop_freq=early_stop_freq,
                               early_stop_margin=early_stop_margin,
                               device=device)
        return self._convert_output(raw, raw_score)

    def _convert_output(self, raw: np.ndarray, raw_score: bool) -> np.ndarray:
        """The objective's link of raw scores ([n], or [n, k] through
        convert_output_multi, gbdt.py:1781-1786)."""
        if raw_score or self.objective is None:
            return raw
        if self.num_tree_per_iteration > 1:
            return np.asarray(self.objective.convert_output_multi(raw))
        return np.asarray(self.objective.convert_output(raw))

    def predict_bucketed(self, X, num_iteration: int = -1,
                         raw_score: bool = False, max_bucket: int = 1 << 20,
                         ensemble: Optional[DeviceEnsemble] = None
                         ) -> np.ndarray:
        """The serving path (gbdt.py:1795-1824): rows padded to the
        power-of-two bucket, each row's output equal to predict()'s device
        path.  `ensemble`: walk this DeviceEnsemble instead of the cached
        one (a serving fleet checks one out under its byte ledger)."""
        self._sync_model()
        X = self._check_features(X, float32=True)
        ens = ensemble if ensemble is not None else self._device_ensemble()
        k = self.num_tree_per_iteration
        iters = self._iterations(num_iteration)
        out = ens.predict_bucketed(X, iters, max_bucket=max_bucket)
        if self.average_output:
            out /= max(iters, 1)
        raw = out[0] if k == 1 else out.T
        return self._convert_output(raw, raw_score)

    def predict_leaf_index(self, X, num_iteration: int = -1,
                           device: Optional[bool] = None) -> np.ndarray:
        """int32 [n, iters*k]: each row's leaf in every tree, from the
        device ensemble (KP1's leaf mode) or, with device=False, the host
        walk (gbdt.py:1843-1853)."""
        self._sync_model()
        if _issparse(X):
            return _by_dense_chunks(X, lambda x: self.predict_leaf_index(
                x, num_iteration, device=device))
        X = self._check_features(X, float32=device is not False)
        iters = self._iterations(num_iteration)
        T = iters * self.num_tree_per_iteration
        if device is False:
            out = np.zeros((X.shape[0], T), np.int32)
            for i in range(T):
                out[:, i] = self.models[i].predict_leaf_index(X)
            return out
        return self._device_ensemble().predict_leaf(X, iters)

    def predict_contrib(self, X, num_iteration: int = -1) -> np.ndarray:
        """TreeSHAP contributions on the host, as the JAX package computes
        them (models/shap.py)."""
        self._sync_model()
        from .shap import predict_contrib as _shap
        if _issparse(X):
            return _by_dense_chunks(X, lambda x: _shap(self, x, num_iteration))
        return _shap(self, self._check_features(X), num_iteration)

    def feature_importance(self, importance_type: str = "split",
                           num_iteration: int = -1) -> np.ndarray:
        """Per raw feature, the splits on it ("split") or their summed
        positive gains (any other type), over the first num_iteration
        iterations (gbdt.py:1863-1877)."""
        self._sync_model()
        imp = np.zeros(self.max_feature_idx + 1, np.float64)
        for tree in self.models[:self._iterations(num_iteration)
                                * self.num_tree_per_iteration]:
            for node in range(tree.num_leaves - 1):
                if importance_type == "split":
                    imp[tree.split_feature[node]] += 1
                else:
                    imp[tree.split_feature[node]] += max(
                        tree.split_gain[node], 0)
        return imp

    def get_leaf_output(self, tree_id: int, leaf_id: int) -> float:
        """The raw output of one leaf (gbdt.py:1823-1834)."""
        self._sync_model()
        if not 0 <= tree_id < len(self.models):
            log.fatal("tree_id %d out of range [0, %d)" % (tree_id,
                                                           len(self.models)))
        tree = self.models[tree_id]
        if not 0 <= leaf_id < tree.num_leaves:
            log.fatal("leaf_id %d out of range [0, %d)" % (leaf_id,
                                                           tree.num_leaves))
        return float(tree.leaf_value[leaf_id])

    def dump_model(self, num_iteration: int = -1) -> dict:
        """The model as a JSON-style dict (gbdt.py:1879-1901, GBDT::DumpModel,
        gbdt_model_text.cpp:15-58)."""
        self._sync_model()
        k = self.num_tree_per_iteration
        return {
            "name": "tree",
            "version": "v2",
            "num_class": self.num_class,
            "num_tree_per_iteration": k,
            "label_index": self.label_idx,
            "max_feature_idx": self.max_feature_idx,
            "objective": (self.objective.to_string()
                          if self.objective is not None else "none"),
            "average_output": self.average_output,
            "feature_names": list(self.feature_names),
            "feature_infos": list(self.feature_infos),
            "tree_info": [self.models[i].to_json(i) for i in
                          range(self._iterations(num_iteration) * k)],
        }

    def raw_scores(self, name: str) -> np.ndarray:
        """A dataset's raw scores ("training" or a validation set's name),
        f64 in row order, flat class-major for k > 1, as a custom objective
        or eval function takes them (gbdt.py:2183-2190): one copy from the
        device."""
        if name == "training":
            scores = self.scores
        else:
            scores = next(vs.scores for nm, vs, _m in self.valid_states
                          if nm == name)
        out = scores.cpu().numpy().astype(np.float64)
        return out[0] if out.shape[0] == 1 else out.reshape(-1)

    def rollback_one_iter(self) -> None:
        """Remove the last iteration's k trees (gbdt.py:2162-2178): each
        negated tree is added into the training and validation scores by
        KP2's add over the bins, the carried arena is left for good (the
        rows' order there is the removed tree's), then the trees go."""
        self._sync_model()
        self._model_gen += 1
        if self.iter <= 0:
            return
        k = self.num_tree_per_iteration
        for kk in range(k):
            tree = self.models[-k + kk]
            tree.shrink(-1.0)
            self._add_train_tree_score(tree, kk)
            for _, vs, _m in self.valid_states:
                self._add_tree_score(vs, tree, kk)
            tree.shrink(-1.0)
        if self._carried_active:
            self._carried_active = False
        del self.models[-k:]
        self.iter -= 1
        self._deferred_stopped = False
        self._rebuild_cegb_used()

    def refit(self, X, label, weight=None, group=None) -> None:
        """New leaf values for every tree on (X, label), the structure
        kept (gbdt.py:2098-2122; GBDT::RefitTree, gbdt.cpp:263-286): each
        row's leaf in every tree from the device ensemble (KP1's leaf mode
        on the card, bit for bit the host walk's)."""
        self._sync_model()
        from ..io.metadata import Metadata
        if self.objective is None:
            log.fatal("Cannot refit without an objective")
        X = self._check_features(X, float32=True)
        n = len(X)
        meta = Metadata(n)
        meta.set_label(np.asarray(label))
        if weight is not None:
            meta.set_weights(np.asarray(weight))
        if group is not None:
            meta.set_query(np.asarray(group))
        self.objective.init(meta, n, self.device)
        leaf_preds = self._device_ensemble().predict_leaf(
            X, len(self.models) // self.num_tree_per_iteration)
        self.refit_with_leaf_preds(leaf_preds, n)

    def refit_with_leaf_preds(self, leaf_preds: np.ndarray, n: int) -> None:
        """Leaf values renewed from an [n, num_models] row-to-leaf map
        against the objective's labels (gbdt.py:2124-2153,
        FitByExistingTree, serial_tree_learner.cpp:235-265): iteration by
        iteration, the objective's gradients of the refit score, each
        leaf's sums in f64 in the host's row order, the leaf output blended
        by refit_decay_rate, and the score adding the new values."""
        from ..ops.split import calculate_splitted_leaf_output
        self._sync_model()
        self._model_gen += 1
        k = self.num_tree_per_iteration
        cfg = self.config
        decay = cfg.refit_decay_rate
        leaf_preds = np.asarray(leaf_preds)
        lp_dev = torch.as_tensor(leaf_preds.astype(np.int64),
                                 device=self.device)
        score = torch.zeros((k, n), dtype=self.dtype, device=self.device)
        for it in range(len(self.models) // k):
            grad, hess = self.objective.get_gradients(
                score if k > 1 else score[0])
            grad = grad.reshape(k, n).cpu().numpy()
            hess = hess.reshape(k, n).cpu().numpy()
            for kk in range(k):
                t = it * k + kk
                tree = self.models[t]
                lp = leaf_preds[:, t]
                nl = tree.num_leaves
                sum_g = np.bincount(lp, weights=grad[kk], minlength=nl)[:nl]
                sum_h = np.bincount(lp, weights=hess[kk],
                                    minlength=nl)[:nl] + K_EPSILON
                out = calculate_splitted_leaf_output(
                    torch.from_numpy(sum_g), torch.from_numpy(sum_h),
                    cfg.lambda_l1, cfg.lambda_l2, cfg.max_delta_step).numpy()
                tree.leaf_value[:nl] = (decay * tree.leaf_value[:nl]
                                        + (1.0 - decay) * out
                                        * tree.shrinkage)
                lv = torch.as_tensor(tree.leaf_value[:nl],
                                     device=self.device).to(self.dtype)
                score[kk] += lv[lp_dev[:, t]]

    def model_to_if_else(self) -> str:
        """Standalone C++ if-else prediction code of the model
        (ModelToIfElse, gbdt_model_text.cpp:60-242; gbdt.py:2155-2160)."""
        self._sync_model()
        from .codegen import model_to_if_else
        return model_to_if_else(self)

    def save_model_to_string(self, start_iteration: int = 0,
                             num_iteration: int = -1) -> str:
        """The model text of num_iteration iterations (all with <= 0) from
        start_iteration on (gbdt.py:1903-1939)."""
        self._sync_model()
        ss = [self.sub_model_name, "version=v2",
              "num_class=%d" % self.num_class,
              "num_tree_per_iteration=%d" % self.num_tree_per_iteration,
              "label_index=%d" % self.label_idx,
              "max_feature_idx=%d" % self.max_feature_idx]
        if self.objective is not None:
            ss.append("objective=%s" % self.objective.to_string())
        if self.average_output:
            ss.append("average_output")
        ss.append("feature_names=" + " ".join(self.feature_names))
        ss.append("feature_infos=" + " ".join(self.feature_infos))
        k = self.num_tree_per_iteration
        start_iteration = min(max(start_iteration, 0), len(self.models) // k)
        num_used = len(self.models)
        if num_iteration > 0:
            num_used = min((start_iteration + num_iteration) * k, num_used)
        start_model = start_iteration * k
        tree_strs = ["Tree=%d\n%s\n" % (i - start_model,
                                         self.models[i].to_string())
                     for i in range(start_model, num_used)]
        ss.append("tree_sizes=" + " ".join(str(len(s)) for s in tree_strs))
        ss.append("")
        body = "\n".join(ss) + "\n" + "".join(tree_strs) + "end of trees\n"
        imps = self.feature_importance("split", num_iteration)
        pairs = [(int(v), self.feature_names[i]) for i, v in enumerate(imps)
                 if v > 0]
        pairs.sort(key=lambda p: -p[0])
        body += "\nfeature importances:\n"
        body += "".join("%s=%d\n" % (nm, v) for v, nm in pairs)
        return body

    def save_model_to_file(self, filename: str, start_iteration: int = 0,
                           num_iteration: int = -1) -> None:
        """The model text written atomically (gbdt.py:1941-1948): a crash
        mid-save leaves the old file or the new one, never a part."""
        atomic_write_text(filename, self.save_model_to_string(
            start_iteration, num_iteration))
        log.info("Saved model to %s", filename)

    def load_model_from_string(self, text: str) -> None:
        """LoadModelFromString (gbdt_model_text.cpp:343+), k trees an
        iteration (tree i of class i % k); the bare `average_output` line
        marks a model whose prediction is the mean of its trees
        (gbdt.py:1955-1964)."""
        self._model_gen += 1
        header: Dict[str, str] = {}
        for line in text.split("\n"):
            line = line.strip()
            if line.startswith("Tree=") or line == "end of trees":
                break
            if "=" in line:
                k, v = line.split("=", 1)
                header[k.strip()] = v.strip()
            elif line == "average_output":
                header["average_output"] = "1"
        if header.get("version") != "v2":
            log.warning("Unknown model version %s", header.get("version"))
        self.num_class = int(header.get("num_class", "1"))
        self.num_tree_per_iteration = int(header.get(
            "num_tree_per_iteration", self.num_class))
        self.label_idx = int(header.get("label_index", "0"))
        self.max_feature_idx = int(header.get("max_feature_idx", "0"))
        self.average_output = "average_output" in header
        self.feature_names = header.get("feature_names", "").split()
        self.feature_infos = header.get("feature_infos", "").split()
        if "objective" in header and self.objective is None:
            tokens = header["objective"].split()
            params = dict(tok.split(":", 1) for tok in tokens[1:] if ":" in tok)
            params.setdefault("num_class", self.num_class)
            self.objective = create_objective(tokens[0], Config(params))
        self.models = []
        for blk in text.split("Tree=")[1:]:
            body = blk.split("\n\n")[0]
            body = body[body.index("\n") + 1:]
            if "end of trees" in body:
                body = body[:body.index("end of trees")]
            self.models.append(Tree.from_string(body))
        self.iter = len(self.models) // max(self.num_tree_per_iteration, 1)


def split_params(cfg: Config) -> SplitParams:
    """The growth-time split parameters of a config (gbdt.py:382-396
    `_refresh_split_params`)."""
    return SplitParams(
        lambda_l1=cfg.lambda_l1, lambda_l2=cfg.lambda_l2,
        max_delta_step=cfg.max_delta_step,
        min_data_in_leaf=cfg.min_data_in_leaf,
        min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf,
        min_gain_to_split=cfg.min_gain_to_split,
        cegb_split_penalty=cfg.cegb_tradeoff * cfg.cegb_penalty_split,
        max_cat_to_onehot=cfg.max_cat_to_onehot,
        cat_smooth=cfg.cat_smooth, cat_l2=cfg.cat_l2,
        min_data_per_group=cfg.min_data_per_group)


def choose_tree_engine(requested: str, base_ok: bool, arena_bytes: int,
                       budget: int) -> str:
    """The serial learner's engine (gbdt.py:1262-1332): "partition" or
    "label".  base_ok: the partition engine applies to the input;
    arena_bytes: what it would hold on the device; budget: the device's
    memory budget."""
    if requested not in ("auto", "label", "partition"):
        raise ValueError("tpu_tree_engine must be auto, label or partition, "
                         "got %r" % requested)
    if requested == "partition" and not base_ok:
        log.warning("tpu_tree_engine=partition not applicable here (needs "
                    "serial learner, f32, max_bin<=256); using label engine")
        return "label"
    if requested == "auto":
        return ("partition" if base_ok and arena_bytes < budget
                else "label")
    return requested


def device_memory_budget(device) -> int:
    """gbdt.py:2212-2222: 60% of the device's memory; 8 GB where the
    device reports none (the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory
                   * 0.6)
    return 8 << 30


def _feature_infos(ds: BinnedDataset) -> List[str]:
    """'[min:max]' per raw feature; 'none' for unused (dataset.cpp)."""
    out = []
    for raw in range(ds.num_total_features):
        inner = ds.used_feature_map[raw]
        if inner < 0:
            out.append("none")
            continue
        m = ds.bin_mappers[inner]
        if m.bin_type == 1:  # categorical
            out.append(":".join(str(c) for c in sorted(m.bin_2_categorical)))
        else:
            out.append("[%s:%s]" % (_repr_g(m.min_val), _repr_g(m.max_val)))
    return out


def _repr_g(v: float) -> str:
    return np.format_float_positional(v, precision=17, trim="-",
                                      fractional=False)


def bundle_maps(ds: BinnedDataset, device) -> Optional[BundleMaps]:
    """The dataset's EFB layout as device BundleMaps, or None without
    bundles (lightgbm_tpu/models/gbdt.py:106-125)."""
    info = ds.bundle
    if info is None:
        return None
    G = info.num_groups
    B = int(info.group_num_bins.max())
    nbf = ds.feature_num_bins()
    db = info.feature_default
    b = np.arange(B, dtype=np.int64)[None, :]
    g = info.feature_group.astype(np.int64)[:, None]
    shift = np.where(info.needs_fix, info.feature_shift, 0)[:, None]
    valid = b < nbf[:, None]
    is_def = info.needs_fix[:, None] & (b == db[:, None])
    idx = np.where(valid & ~is_def, g * B + b + shift, G * B)

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype), device=device)

    return BundleMaps(
        unbundle_idx=t(idx, np.int64), feat_col=t(info.feature_group,
                                                  np.int32),
        feat_lo=t(info.feature_lo, np.int32),
        feat_hi=t(info.feature_hi, np.int32),
        feat_shift=t(info.feature_shift, np.int32),
        needs_fix=t(info.needs_fix, bool))


def _tree_to_device(tree: Tree, device, max_bin: int) -> TreeArrays:
    """A host tree's node arrays on the device for KP2's walk
    (gbdt.py:2246-2310): `add_valid`'s replay of earlier trees and the
    rebuild of the training score.  A tree with categorical nodes has
    their bin bitsets as [N, max_bin] left-going masks."""
    nl = tree.num_leaves
    n = nl - 1
    dt = tree.decision_type[:n].astype(np.int32)
    W = max_bin if tree.num_cat > 0 else 0
    is_cat = (dt & K_CATEGORICAL_MASK) > 0
    cat_mask = np.zeros((n, W), bool)
    word, bit = np.arange(W) // 32, np.arange(W) % 32
    for node in np.flatnonzero(is_cat):
        ci = int(tree.threshold_in_bin[node])
        lo = tree.cat_boundaries_inner[ci]
        hi = tree.cat_boundaries_inner[ci + 1]
        bits = np.asarray(tree.cat_threshold_inner[lo:hi], np.uint32)
        if len(bits):
            cat_mask[node] = (word < len(bits)) & (
                (bits[np.minimum(word, len(bits) - 1)] >> bit) & 1
            ).astype(bool)

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype), device=device)

    zn = np.zeros(n)
    zl = np.zeros(nl)
    return TreeArrays(
        split_feature=t(tree.split_feature_inner[:n], np.int32),
        threshold_bin=t(tree.threshold_in_bin[:n], np.int32),
        default_left=t((dt & K_DEFAULT_LEFT_MASK) > 0, bool),
        missing_type=t((dt >> 2) & 3, np.int32),
        left_child=t(tree.left_child[:n], np.int32),
        right_child=t(tree.right_child[:n], np.int32),
        split_gain=t(zn, np.float32), internal_value=t(zn, np.float32),
        internal_count=t(zn, np.int32),
        leaf_value=t(tree.leaf_value[:nl], np.float32),
        leaf_count=t(zl, np.int32), leaf_parent=t(zl, np.int32),
        leaf_depth=t(zl, np.int32), num_leaves=t(nl, np.int32),
        is_cat=t(is_cat, bool), cat_mask=t(cat_mask, bool))


def init_score_matrix(ds: BinnedDataset, k: int, device,
                      dtype=torch.float32) -> torch.Tensor:
    """[k, n] in dtype (f32, or f64 with tpu_double_precision): the
    dataset's init score, class-major (a k*n vector, or an n vector every
    class shares: gbdt.py:2225 `_expand_init_score`), or zeros."""
    n = ds.num_data
    if ds.metadata.init_score is None:
        return torch.zeros((k, n), dtype=dtype, device=device)
    init = np.asarray(ds.metadata.init_score, np.float64)
    init = (init.reshape(k, n) if init.size == k * n
            else np.tile(init.reshape(1, -1), (k, 1)))
    if dtype == torch.float32:
        init = init.astype(np.float32)
    return torch.as_tensor(init, device=device)


def _walk_add(bins: torch.Tensor, num_bins: torch.Tensor,
              default_bins: torch.Tensor, score: torch.Tensor,
              tree: Tree, bundle: Optional[BundleMaps],
              max_bin: int) -> None:
    """score += the host tree's leaf value, in the score's type, at each
    row's leaf (a constant for a one-leaf tree), the rows walked by KP2's
    add mode."""
    if tree.num_leaves <= 1:
        score += float(tree.leaf_value[0])
        return
    lv = torch.as_tensor(tree.leaf_value[:tree.num_leaves],
                         device=score.device).to(score.dtype)
    walk_binned(bins, _tree_to_device(tree, score.device, max_bin), num_bins,
                default_bins, lv=lv, score=score, bundle=bundle)


# Copied from lightgbm_tpu/io/file_io.py:60-90 `atomic_write_text`, local
# paths only (the port has no remote file backends).
def atomic_write_text(path, text: str) -> None:
    """Write `text` to `path` so readers never observe a partial file: a
    temp file in the same directory, flushed and fsynced, then
    ``os.replace`` over the destination."""
    import os
    import tempfile
    path = str(path)
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(
        prefix=os.path.basename(path) + ".tmp.", dir=directory)
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _issparse(X) -> bool:
    """lightgbm_tpu/io/dataset.py:28: a scipy sparse matrix."""
    try:
        import scipy.sparse as sp
        return sp.issparse(X)
    except ImportError:
        return False


def _dense_matrix(X) -> np.ndarray:
    """The input conversion the verbatim models/shap.py imports: its rows
    arrive dense here (predict_contrib densifies sparse input in chunks)."""
    return np.asarray(X, np.float64)


def _by_dense_chunks(X, fn) -> np.ndarray:
    """fn over a scipy sparse X densified in chunks of about 2^24 values,
    joined by rows (lightgbm_tpu/models/gbdt.py:1681-1691)."""
    step = max(1, (1 << 24) // max(X.shape[1], 1))
    return np.concatenate([fn(np.asarray(X[i:i + step].todense()))
                           for i in range(0, X.shape[0], step)], axis=0)
