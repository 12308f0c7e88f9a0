"""Model -> standalone C++ if-else prediction code.

The convert_model path (ModelToIfElse, src/boosting/gbdt_model_text.cpp:
60-242): emits one PredictTreeN function per tree plus aggregate Predict /
PredictRaw entry points, so a trained model compiles into dependency-free
C++ whose outputs match the interpreter (the tests/cpp_test oracle of the
reference CI, .ci/test.sh:52-58).

Copied from lightgbm_tpu/models/codegen.py, host code, so that both
packages emit the same text for the same model.
"""
from __future__ import annotations

from typing import List

from .tree import (K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK, MISSING_NAN,
                   MISSING_ZERO, Tree)

_HEADER = """\
#include <cmath>
#include <cstdint>
#include <vector>

// Generated by lightgbm_tpu convert_model (ModelToIfElse analogue,
// gbdt_model_text.cpp:60-242).  One function per tree; Predict() adds the
// objective transform.

static inline bool CatInBitset(const uint32_t* bits, int n, int pos) {
  int i = pos / 32;
  return i < n && ((bits[i] >> (pos % 32)) & 1);
}
"""


def _node_code(tree: Tree, node: int, indent: str, lines: List[str]) -> None:
    if node < 0:
        lines.append("%sreturn %.17g;" % (indent, tree.leaf_value[~node]))
        return
    feat = int(tree.split_feature[node])
    dt = int(tree.decision_type[node])
    mt = (dt >> 2) & 3
    default_left = bool(dt & K_DEFAULT_LEFT_MASK)
    fv = "arr[%d]" % feat
    if dt & K_CATEGORICAL_MASK:
        # the cat index lives in the REAL threshold slot — threshold_in_bin
        # is not populated on models loaded from text (tree.py:270)
        ci = int(tree.threshold[node])
        lo, hi = tree.cat_boundaries[ci], tree.cat_boundaries[ci + 1]
        words = ", ".join("%uu" % (w & 0xFFFFFFFF)
                          for w in tree.cat_threshold[lo:hi]) or "0u"
        lines.append("%s{ static const uint32_t b[] = {%s};" % (indent, words))
        lines.append("%sif (!std::isnan(%s) && %s >= 0 && "
                     "CatInBitset(b, %d, (int)%s)) {"
                     % (indent, fv, fv, max(hi - lo, 1), fv))
    else:
        thr = "%.17g" % tree.threshold[node]
        if mt == MISSING_ZERO:
            miss = "(std::fabs(%s) <= 1e-35 || std::isnan(%s))" % (fv, fv)
            cond = "%s <= %s" % (fv, thr)
        elif mt == MISSING_NAN:
            miss = "std::isnan(%s)" % fv
            cond = "%s <= %s" % (fv, thr)
        else:
            # missing_type none: NaN is treated as 0.0 before the compare
            # (the interpreter rewrites NaN -> 0.0, tree.py predict)
            miss = None
            cond = "(std::isnan(%s) ? 0.0 : %s) <= %s" % (fv, fv, thr)
        if miss is not None:
            cond = ("(%s) || (!(%s) && (%s))" % (miss, miss, cond)
                    if default_left else "!(%s) && (%s)" % (miss, cond))
        lines.append("%sif (%s) {" % (indent, cond))
    _node_code(tree, int(tree.left_child[node]), indent + "  ", lines)
    lines.append("%s} else {" % indent)
    _node_code(tree, int(tree.right_child[node]), indent + "  ", lines)
    lines.append("%s}" % indent)
    if dt & K_CATEGORICAL_MASK:
        lines.append("%s}" % indent)


def model_to_if_else(gbdt) -> str:
    out = [_HEADER]
    num_trees = len(gbdt.models)
    k = max(gbdt.num_tree_per_iteration, 1)
    for i, tree in enumerate(gbdt.models):
        out.append("static double PredictTree%d(const double* arr) {" % i)
        if tree.num_leaves <= 1:
            out.append("  return %.17g;" % tree.leaf_value[0])
        else:
            lines: List[str] = []
            _node_code(tree, 0, "  ", lines)
            out.extend(lines)
        out.append("}")
        out.append("")

    out.append("static double (*kTreePredict[])(const double*) = {")
    out.append("  " + ", ".join("PredictTree%d" % i for i in range(num_trees)))
    out.append("};")
    out.append("")
    out.append("void PredictRaw(const double* arr, double* output) {")
    out.append("  for (int k = 0; k < %d; ++k) output[k] = 0.0;" % k)
    out.append("  for (int i = 0; i < %d; ++i)" % num_trees)
    out.append("    output[i %% %d] += kTreePredict[i](arr);" % k)
    out.append("}")
    out.append("")
    obj = getattr(gbdt, "objective", None)
    transform = obj.to_string().split(" ")[0] if obj is not None else "none"
    out.append("// objective: %s" % (obj.to_string() if obj else "none"))
    out.append("void Predict(const double* arr, double* output) {")
    out.append("  PredictRaw(arr, output);")
    if transform == "binary":
        sigmoid = getattr(obj, "sigmoid", 1.0)
        out.append("  output[0] = 1.0 / (1.0 + std::exp(-%.17g * output[0]));"
                   % sigmoid)
    elif transform in ("multiclass", "softmax"):
        out.append("  double m = output[0], s = 0.0;")
        out.append("  for (int i = 1; i < %d; ++i) if (output[i] > m) m = output[i];" % k)
        out.append("  for (int i = 0; i < %d; ++i) { output[i] = std::exp(output[i] - m); s += output[i]; }" % k)
        out.append("  for (int i = 0; i < %d; ++i) output[i] /= s;" % k)
    elif transform in ("poisson", "gamma", "tweedie"):
        out.append("  output[0] = std::exp(output[0]);")
    out.append("}")
    out.append("")
    out.append("int NumPredictOutputs() { return %d; }" % k)
    return "\n".join(out)
