# Copied from lightgbm_tpu/plotting.py.
"""Plotting utilities (reference python-package/lightgbm/plotting.py:1-456):
plot_importance, plot_metric, plot_tree / create_tree_digraph.  matplotlib
and graphviz are imported lazily so the core package has no hard
dependency on them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .basic import Booster
from .utils import log


def _check_not_tuple_of_2_elements(obj, obj_name):
    if not isinstance(obj, tuple) or len(obj) != 2:
        raise TypeError("%s must be a tuple of 2 elements." % obj_name)


def plot_importance(booster, ax=None, height=0.2, xlim=None, ylim=None,
                    title="Feature importance", xlabel="Feature importance",
                    ylabel="Features", importance_type="split",
                    max_num_features=None, ignore_zero=True, figsize=None,
                    grid=True, precision=3, **kwargs):
    """Horizontal bar chart of feature importances
    (plotting.py:20-143)."""
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        raise ImportError("You must install matplotlib to plot importance")

    if isinstance(booster, Booster):
        importance = booster.feature_importance(importance_type)
        feature_name = booster.feature_name()
    elif hasattr(booster, "booster_"):          # sklearn estimator
        importance = booster.booster_.feature_importance(importance_type)
        feature_name = booster.booster_.feature_name()
    else:
        raise TypeError("booster must be Booster or LGBMModel")

    tuples = sorted(zip(feature_name, importance), key=lambda x: x[1])
    if ignore_zero:
        tuples = [t for t in tuples if t[1] > 0]
    if not tuples:
        raise ValueError("Booster's feature_importance is empty")
    if max_num_features is not None and max_num_features > 0:
        tuples = tuples[-max_num_features:]
    labels, values = zip(*tuples)

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize)
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        ax.text(x + 1, y,
                ("%." + str(precision) + "f") % x if importance_type == "gain"
                else str(int(x)), va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
    else:
        xlim = (0, max(values) * 1.1)
    ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
    else:
        ylim = (-1, len(values))
    ax.set_ylim(ylim)
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_metric(booster, metric=None, dataset_names=None, ax=None,
                xlim=None, ylim=None, title="Metric during training",
                xlabel="Iterations", ylabel="auto", figsize=None, grid=True):
    """Plot one metric's history recorded by the record_evaluation callback
    (plotting.py:146-255).  `booster` is the eval-result dict or a Booster
    trained with evals_result."""
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        raise ImportError("You must install matplotlib to plot metric")

    if isinstance(booster, dict):
        eval_results = booster
    elif hasattr(booster, "evals_result_"):
        eval_results = booster.evals_result_
    else:
        raise TypeError("booster must be dict or LGBMModel with "
                        "evals_result_")
    if not eval_results:
        raise ValueError("eval results cannot be empty")

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize)

    names = dataset_names or list(eval_results.keys())
    msg = None
    for name in names:
        metrics = eval_results[name]
        if metric is None:
            metric = next(iter(metrics))
        if metric not in metrics:
            raise ValueError("Specified metric %s not found" % metric)
        results = metrics[metric]
        ax.plot(range(len(results)), results, label=name)
        msg = metric
    ax.legend(loc="best")
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
        ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
        ax.set_ylim(ylim)
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    ax.set_ylabel(msg if ylabel == "auto" else ylabel)
    ax.grid(grid)
    return ax


def create_tree_digraph(booster, tree_index=0, show_info=None,
                        precision=3, **kwargs):
    """Graphviz Digraph of one tree (plotting.py:258-378)."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise ImportError("You must install graphviz to plot tree")

    if hasattr(booster, "booster_"):
        booster = booster.booster_
    if not isinstance(booster, Booster):
        raise TypeError("booster must be Booster or LGBMModel")
    model = booster.dump_model()
    tree_infos = model["tree_info"]
    feature_names = model.get("feature_names")
    if tree_index >= len(tree_infos):
        raise IndexError("tree_index is out of range")
    tree_info = tree_infos[tree_index]
    show_info = show_info or []

    graph = Digraph(**kwargs)

    def add(node, parent=None, decision=None):
        if "split_index" in node:
            name = "split%d" % node["split_index"]
            feat = node["split_feature"]
            if feature_names:
                feat = feature_names[feat]
            label = "split_feature_name: %s" % feat
            label += r"\nthreshold: %s" % round(node["threshold"], precision) \
                if not isinstance(node["threshold"], int) \
                else r"\nthreshold: %s" % node["threshold"]
            for info in ("split_gain", "internal_value", "internal_count"):
                if info in show_info:
                    label += r"\n%s: %s" % (info,
                                            round(node[info], precision))
            graph.node(name, label=label)
            add(node["left_child"], name, "yes")
            add(node["right_child"], name, "no")
        else:
            name = "leaf%d" % node.get("leaf_index", 0)
            label = "leaf_index: %d" % node.get("leaf_index", 0)
            label += r"\nleaf_value: %s" % round(node["leaf_value"], precision)
            if "leaf_count" in show_info and "leaf_count" in node:
                label += r"\nleaf_count: %d" % node["leaf_count"]
            graph.node(name, label=label)
        if parent is not None:
            graph.edge(parent, name, decision)

    add(tree_info["tree_structure"])
    return graph


def plot_tree(booster, ax=None, tree_index=0, figsize=None,
              show_info=None, precision=3, **kwargs):
    """Render one tree via graphviz into a matplotlib axis
    (plotting.py:381-456)."""
    try:
        import matplotlib.image as mpimg
        import matplotlib.pyplot as plt
    except ImportError:
        raise ImportError("You must install matplotlib to plot tree")
    from io import BytesIO

    graph = create_tree_digraph(booster, tree_index=tree_index,
                                show_info=show_info, precision=precision,
                                **kwargs)
    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize)
    s = BytesIO(graph.pipe(format="png"))
    ax.imshow(mpimg.imread(s))
    ax.axis("off")
    return ax
