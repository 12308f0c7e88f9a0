"""GBDT boosting driver of the port's main path.

Port of the k=1 subset of lightgbm_tpu/models/gbdt.py `_train_one_iter_impl`
(:496-687) in the shape of its fused fast paths: gradients on the device,
optionally quantized to int8 codes (`tpu_quantized_grad`), one tree grown by
the partition engine with every row in the bag, the score updated from the
grower's per-row leaf values (emit="score"), shrinkage and
boost-from-average, and ONE packed host fetch per tree.  The model text is
the reference v2 format, so models load in both packages.

Two paths, chosen by the JAX rule (`_carried_ok`, gbdt.py:847-869, with the
objective's `carry_fields` gate):

- carried (`_run_fused_iter_carried`, :904-1016): the tree roots at one of
  two arena slots holding every row in the order the previous tree left
  them, and K6 compacts the finished tree into the other slot.  The JAX
  arena also carries the score and label planes, because a TPU cannot
  cheaply scatter by row id (:838-845); here the score stays in row order
  and K4 updates it, and each tree's gradients, computed in row order, are
  gathered into the slot's order by its row ids before they are quantized.
  The codes, histograms and carried row order equal JAX's;
- non-carried (`_build_fused_iter`, :719-836): the tree roots at the
  pristine block, for weighted objectives and the other configurations
  `_carried_ok` refuses.

Configurations this slice does not run raise NotImplementedError naming the
ROADMAP.md item that will bring them; none is served by a substitute.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..io.dataset import BinnedDataset
from ..objective import ObjectiveFunction, create_objective
from ..ops.grow import pack_tree_arrays, unpack_tree_vectors
from ..ops import quantize as qz
from ..ops import threefry
from ..ops.grow_partition import grow_tree_partition
from ..ops.partition_kernel import TILE, Arena, init_pristine, pristine_work0
from ..ops.split import SplitParams
from ..utils import log
from .tree import Tree

K_EPSILON = 1e-15


def check_supported(cfg: Config) -> None:
    """Raise NotImplementedError for a configuration this slice does not
    run, naming the ROADMAP.md item that brings it."""
    def no(what: str, item: str) -> None:
        raise NotImplementedError("%s is not ported yet (ROADMAP.md %s)"
                                  % (what, item))

    if cfg.tpu_tree_engine == "label":
        no("tpu_tree_engine=label", "queue 1, item 11: the label engine")
    if cfg.tpu_double_precision:
        no("tpu_double_precision", "queue 1, item 11: the label engine")
    if cfg.boosting == "goss":
        no("GOSS", "queue 1, item 11: boosting modes")
    if cfg.boosting != "gbdt":
        no("boosting=%s" % cfg.boosting, "queue 1, item 11: boosting modes")
    if cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0:
        no("bagging", "queue 1, item 11: bagging")
    if cfg.num_class > 1:
        no("multiclass", "queue 1, item 11: objectives")
    if cfg.forcedsplits_filename:
        no("forced splits", "queue 1, item 11: forced splits")
    if cfg.tree_learner != "serial" or cfg.num_machines > 1:
        no("the %s tree learner" % cfg.tree_learner,
           "queue 1, item 12: parallel learners")
    if cfg.cegb_penalty_feature_coupled or cfg.cegb_penalty_feature_lazy:
        no("CEGB feature penalties", "queue 1, item 11: CEGB")
    if cfg.histogram_pool_size > 0:
        no("histogram pooling (histogram_pool_size)",
           "queue 1, item 11: histogram pooling")


class GBDT:
    """The boosting driver (gbdt.h:24-470) for one model per iteration."""

    sub_model_name = "tree"

    def __init__(self, config: Config, train_set: Optional[BinnedDataset],
                 objective: Optional[ObjectiveFunction], device):
        self.config = config
        self.objective = objective
        self.device = torch.device(device)
        self.models: List[Tree] = []
        self.iter = 0
        self.num_class = 1
        self.num_tree_per_iteration = 1
        self.shrinkage_rate = config.learning_rate
        self.max_feature_idx = 0
        self.label_idx = 0
        self.feature_names: List[str] = []
        self.feature_infos: List[str] = []
        self._feat_rng = np.random.RandomState(config.feature_fraction_seed)
        self._truncation_warned = False
        self._quantized = False
        self._carried_active = False
        if train_set is not None:
            self._setup_train(train_set)

    def _setup_train(self, ds: BinnedDataset) -> None:
        cfg = self.config
        check_supported(cfg)
        if self.objective is None:
            raise NotImplementedError(
                "custom objectives are not ported yet (ROADMAP.md queue 1, "
                "item 11)")
        if ds.num_features == 0:
            raise ValueError("the dataset has no feature with more than one "
                             "bin")
        dev = self.device
        self.train_set = ds
        self.num_data = n = ds.num_data
        self.max_feature_idx = ds.num_total_features - 1
        self.feature_names = list(ds.feature_names)
        self.feature_infos = _feature_infos(ds)
        self.objective.init(ds.metadata, n, dev)
        # bins per histogram column: the largest feature's bin count
        self.max_bin = int(ds.feature_num_bins().max())
        L = max(cfg.num_leaves, 2)
        self.split_params = SplitParams(
            lambda_l1=cfg.lambda_l1, lambda_l2=cfg.lambda_l2,
            max_delta_step=cfg.max_delta_step,
            min_data_in_leaf=cfg.min_data_in_leaf,
            min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf,
            min_gain_to_split=cfg.min_gain_to_split,
            cegb_split_penalty=cfg.cegb_tradeoff * cfg.cegb_penalty_split)
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
        self.score = torch.zeros(n, dtype=torch.float32, device=dev)
        if ds.metadata.init_score is not None:
            self.score += torch.as_tensor(
                np.asarray(ds.metadata.init_score, np.float32).reshape(-1),
                device=dev)
        self._quantized = bool(cfg.tpu_quantized_grad)
        self._quant_seed = int(cfg.tpu_quantized_seed or cfg.seed)
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
        # pristine layout (gbdt.py:1281-1282): factor >= 4 covers the
        # pristine block, the redirected root copy and the bump region
        self.arena = Arena(n, ds.num_features, max(cfg.tpu_arena_factor, 4),
                           dev, quantized=self._quantized)
        init_pristine(self.arena, ds.device_bins(dev).t())
        self.max_leaves = L
        self._carried_active = self._carried_ok()
        if self._carried_active:
            self._init_carried()

    def _carried_ok(self) -> bool:
        """gbdt.py:847-869: the objective's carry gate, and a bump region
        past both root slots of at least 2 align(n) columns."""
        if not self.objective.carry_ok():
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
    def _feature_sample(self) -> torch.Tensor:
        frac = self.config.feature_fraction
        F = self.train_set.num_features
        mask = np.ones(F, bool)
        if frac < 1.0:
            used = max(1, int(round(F * frac)))
            idx = self._feat_rng.choice(F, used, replace=False)
            mask = np.zeros(F, bool)
            mask[idx] = True
        return torch.as_tensor(mask, device=self.device)

    def _boost_from_average(self) -> float:
        if self.models or self.train_set.metadata.init_score is not None:
            return 0.0
        if self.config.boost_from_average:
            init_score = self.objective.boost_from_score(0)
            if abs(init_score) > K_EPSILON:
                self.score += init_score
                log.info("Start training from score %f", init_score)
                return init_score
        return 0.0

    def train_one_iter(self) -> bool:
        """One boosting round; True when training cannot continue (no leaf
        meets the split requirements)."""
        init_score = self._boost_from_average()
        cfg = self.config
        if not self.objective.class_need_train(0):
            new_tree = Tree(1)
            if not self.models:
                output = self.objective.boost_from_score(0)
                new_tree.as_constant(output)
                self.score += output
            self.models.append(new_tree)
            self.iter += 1
            return False
        grad, hess = self.objective.get_gradients(self.score)
        grad, hess = grad.to(torch.float32), hess.to(torch.float32)
        kw = {}
        if self._carried_active:
            p = self._carry_parity
            root0 = self._carry_slots[p]
            # the carried root's order: JAX computes the same elementwise
            # gradients from its carried score planes (gbdt.py:931-939)
            rid = self.arena.rid[root0:root0 + self.num_data].long()
            grad, hess = grad[rid], hess[rid]
            kw = dict(carried_root=root0, carried_bump0=self._carry_bump0,
                      carry_dst=self._carry_slots[1 - p])
        if self._quantized:
            # the carried path draws its noise by arena position under the
            # iteration's key (gbdt.py:947-951, :1000); the non-carried one
            # by row under the key folded with the class (:755-756, :802)
            key = qz.quantize_key(self._quant_seed, self.iter)
            if not self._carried_active:
                key = threefry.fold_in(key, 0)
            grad, hess, g_scale, h_scale = qz.quantize_gradients(grad, hess,
                                                                 key)
            kw["quant_scales"] = (g_scale, h_scale)
        arrays, delta, truncated = grow_tree_partition(
            self.arena, grad, hess,
            self._feature_sample(), self.num_bins, self.default_bins,
            self.missing_types, self.split_params, self.monotone,
            self.penalty, max_leaves=self.max_leaves,
            max_depth=cfg.max_depth, max_bin=self.max_bin, emit="score",
            **kw)
        if self._carried_active:
            self._carry_parity = 1 - p
        self.score += delta * torch.tensor(self.shrinkage_rate,
                                           dtype=torch.float32)
        ivec, fvec = pack_tree_arrays(arrays)
        ivec = torch.cat([ivec, truncated.to(torch.int32).view(1)])
        # the one host fetch of the tree (ints and f32 are exact in f64)
        host = torch.cat([ivec.double(), fvec.double()]).cpu().numpy()
        ivec_h, fvec_h = host[:ivec.shape[0]], host[ivec.shape[0]:]
        host_arrays = unpack_tree_vectors(ivec_h, fvec_h.astype(np.float32),
                                          self.max_leaves, 0)
        if ivec_h[-1] and not self._truncation_warned:
            self._truncation_warned = True
            log.warning("Tree growth truncated at %d leaves by partition-"
                        "arena overflow; raise tpu_arena_factor",
                        int(host_arrays.num_leaves))
        new_tree = Tree(1)
        if int(host_arrays.num_leaves) > 1:
            new_tree = Tree.from_arrays(host_arrays, self.train_set)
            new_tree.shrink(self.shrinkage_rate)
            if abs(init_score) > K_EPSILON:
                new_tree.add_bias(init_score)
            self.models.append(new_tree)
            self.iter += 1
            return False
        if not self.models:
            # a degenerate first iteration keeps the prior as a constant
            new_tree.as_constant(init_score)
            self.score += init_score
            self.models.append(new_tree)
        log.warning("Stopped training because there are no more leaves that "
                    "meet the split requirements")
        return True

    # ------------------------------------------------------------------ #
    def predict_raw(self, X: np.ndarray, num_iteration: int = -1
                    ) -> np.ndarray:
        """Raw scores by the host walk of every tree (device prediction is
        ROADMAP.md queue 1, item 8)."""
        X = np.ascontiguousarray(np.asarray(X, np.float64))
        if X.ndim != 2 or X.shape[1] <= self.max_feature_idx:
            log.fatal("The number of features in data (%d) is not the same "
                      "as it was in training data (%d)"
                      % (X.shape[1] if X.ndim == 2 else 0,
                         self.max_feature_idx + 1))
        iters = len(self.models)
        if num_iteration > 0:
            iters = min(num_iteration, iters)
        out = np.zeros(X.shape[0], np.float64)
        for tree in self.models[:iters]:
            out += tree.predict(X)
        return out

    def predict(self, X: np.ndarray, num_iteration: int = -1,
                raw_score: bool = False) -> np.ndarray:
        raw = self.predict_raw(X, num_iteration)
        if raw_score or self.objective is None:
            return raw
        return np.asarray(self.objective.convert_output(raw))

    def feature_importance(self, num_iteration: int = -1) -> np.ndarray:
        """Split counts per raw feature."""
        imp = np.zeros(self.max_feature_idx + 1, np.float64)
        iters = len(self.models) if num_iteration <= 0 else num_iteration
        for tree in self.models[:iters]:
            for f in tree.split_feature[:tree.num_leaves - 1]:
                imp[f] += 1
        return imp

    def save_model_to_string(self, num_iteration: int = -1) -> str:
        ss = [self.sub_model_name, "version=v2",
              "num_class=%d" % self.num_class,
              "num_tree_per_iteration=%d" % self.num_tree_per_iteration,
              "label_index=%d" % self.label_idx,
              "max_feature_idx=%d" % self.max_feature_idx]
        if self.objective is not None:
            ss.append("objective=%s" % self.objective.to_string())
        ss.append("feature_names=" + " ".join(self.feature_names))
        ss.append("feature_infos=" + " ".join(self.feature_infos))
        num_used = len(self.models)
        if num_iteration > 0:
            num_used = min(num_iteration, num_used)
        tree_strs = ["Tree=%d\n%s\n" % (i, self.models[i].to_string())
                     for i in range(num_used)]
        ss.append("tree_sizes=" + " ".join(str(len(s)) for s in tree_strs))
        ss.append("")
        body = "\n".join(ss) + "\n" + "".join(tree_strs) + "end of trees\n"
        imps = self.feature_importance(num_iteration)
        pairs = [(int(v), self.feature_names[i]) for i, v in enumerate(imps)
                 if v > 0]
        pairs.sort(key=lambda p: -p[0])
        body += "\nfeature importances:\n"
        body += "".join("%s=%d\n" % (nm, v) for v, nm in pairs)
        return body

    def load_model_from_string(self, text: str) -> None:
        """LoadModelFromString (gbdt_model_text.cpp:343+), one tree per
        iteration."""
        header: Dict[str, str] = {}
        for line in text.split("\n"):
            line = line.strip()
            if line.startswith("Tree=") or line == "end of trees":
                break
            if "=" in line:
                k, v = line.split("=", 1)
                header[k.strip()] = v.strip()
        if header.get("version") != "v2":
            log.warning("Unknown model version %s", header.get("version"))
        if int(header.get("num_tree_per_iteration",
                          header.get("num_class", "1"))) != 1:
            raise NotImplementedError(
                "models with several trees per iteration are not ported yet "
                "(ROADMAP.md queue 1, item 11)")
        self.label_idx = int(header.get("label_index", "0"))
        self.max_feature_idx = int(header.get("max_feature_idx", "0"))
        self.feature_names = header.get("feature_names", "").split()
        self.feature_infos = header.get("feature_infos", "").split()
        if "objective" in header and self.objective is None:
            tokens = header["objective"].split()
            params = dict(tok.split(":", 1) for tok in tokens[1:] if ":" in tok)
            self.objective = create_objective(tokens[0], Config(params))
        self.models = []
        for blk in text.split("Tree=")[1:]:
            body = blk.split("\n\n")[0]
            body = body[body.index("\n") + 1:]
            if "end of trees" in body:
                body = body[:body.index("end of trees")]
            self.models.append(Tree.from_string(body))
        self.iter = len(self.models)


def _feature_infos(ds: BinnedDataset) -> List[str]:
    """'[min:max]' per raw feature; 'none' for unused (dataset.cpp)."""
    out = []
    for raw in range(ds.num_total_features):
        inner = ds.used_feature_map[raw]
        if inner < 0:
            out.append("none")
            continue
        m = ds.bin_mappers[inner]
        out.append("[%s:%s]" % (_repr_g(m.min_val), _repr_g(m.max_val)))
    return out


def _repr_g(v: float) -> str:
    return np.format_float_positional(v, precision=17, trim="-",
                                      fractional=False)
