"""Model -> standalone C++ source generation; the PyTorch port's copy of
lightgbm_tpu/models/model_codegen.py, whose text it reproduces byte for byte
(the prelude still names ``lightgbm_tpu``, as the JAX package writes it, and
the ``// model_fingerprint:`` header hashes the bare model text as
serve/packed.py does).

Counterpart of the reference's if-else code generation
(GBDT::SaveModelToIfElse, gbdt_model_text.cpp:100-248, Tree::ToIfElse,
src/io/tree.cpp): the ensemble compiles to a self-contained C++ translation
unit with no framework dependency:

    double Predict{Raw,}(const double* features, double* output);
    void PredictLeafIndex(const double* features, double* output);

Decision semantics mirror Tree::NumericalDecision / CategoricalDecision
(tree.h:216-271) exactly: missing-type dispatch, zero-threshold window,
default-left, so a g++-compiled model reproduces the port's predictions to
double precision. The CLI's ``convert_model`` task is not ported yet.
"""
from __future__ import annotations

from typing import List

_PRELUDE = """\
// Generated by lightgbm_tpu task=convert_model. Self-contained model source.
#include <cmath>
#include <cstring>

namespace lightgbm_tpu_model {

static const double kZeroThreshold = 1e-35;

static inline bool NumericalDecision(double fval, double threshold,
                                     int missing_type, bool default_left) {
  // Tree::NumericalDecision (tree.h:216-254)
  if (std::isnan(fval) && missing_type != 2) fval = 0.0;
  if ((missing_type == 1 && fval > -kZeroThreshold && fval <= kZeroThreshold) ||
      (missing_type == 2 && std::isnan(fval)))
    return default_left;
  return fval <= threshold;
}

static inline bool CategoricalDecision(double fval, double category) {
  // one-hot categorical (legacy pre-bitset models)
  if (std::isnan(fval)) return false;
  return static_cast<long long>(fval) == static_cast<long long>(category);
}

static inline bool CategoricalBitsetDecision(double fval, const unsigned int* bits,
                                             int n_words, int missing_type) {
  // Tree::CategoricalDecision + FindInBitset (tree.h:255-271, common.h:943).
  // Guard BEFORE the int cast: casting NaN or out-of-int-range doubles is UB.
  int iv;
  if (std::isnan(fval)) {
    if (missing_type == 2) return false;  // NaN is always right
    iv = 0;
  } else if (fval < 0.0) {
    return false;
  } else if (fval >= 2147483648.0) {
    return false;  // beyond any bitset width
  } else {
    iv = static_cast<int>(fval);
  }
  int w = iv / 32;
  if (w >= n_words) return false;
  return (bits[w] >> (iv % 32)) & 1u;
}
"""


def _tree_ifelse(tree, index: int, predict_leaf: bool) -> str:
    """One tree as an if-else chain (Tree::ToIfElse, tree.cpp)."""
    name = "PredictTree%d%s" % (index, "Leaf" if predict_leaf else "")
    lines: List[str] = []
    if tree.num_cat > 0 and not predict_leaf:
        # one bitset-word array per tree, shared by the Leaf variant
        lines.append(
            "static const unsigned int cat_threshold_%d[] = { %s };"
            % (index, ", ".join("%du" % int(v) for v in tree.cat_threshold))
        )
    lines.append("double %s(const double* arr) {" % name)
    if tree.num_leaves <= 1:
        ret = 0.0 if predict_leaf else float(tree.leaf_value[0])
        lines.append("  return %.17g;" % ret)
        lines.append("}")
        return "\n".join(lines)

    # explicit work stack, not recursion: a 255-leaf tree with unlimited depth
    # can chain ~num_leaves levels deep and blow the interpreter's recursion
    # limit mid-convert_model
    work: List = [("node", 0, 0)]
    while work:
        kind, item, depth = work.pop()
        if kind == "text":
            lines.append(item)
            continue
        node = item
        pad = "  " * (depth + 1)
        if node < 0:
            leaf = -(node + 1)
            val = float(leaf) if predict_leaf else float(tree.leaf_value[leaf])
            lines.append("%sreturn %.17g;" % (pad, val))
            continue
        f = int(tree.split_feature[node])
        thr = float(tree.threshold[node])
        miss = (int(tree.decision_type[node]) >> 2) & 3
        dl = bool(tree.decision_type[node] & 2)
        if tree.decision_type[node] & 1:
            if tree.num_cat > 0:
                cat_idx = int(thr)
                lo = int(tree.cat_boundaries[cat_idx])
                nwords = int(tree.cat_boundaries[cat_idx + 1]) - lo
                cond = "CategoricalBitsetDecision(arr[%d], cat_threshold_%d + %d, %d, %d)" % (
                    f, index, lo, nwords, miss,
                )
            else:
                cond = "CategoricalDecision(arr[%d], %.17g)" % (f, thr)
        else:
            cond = "NumericalDecision(arr[%d], %.17g, %d, %s)" % (
                f, thr, miss, "true" if dl else "false",
            )
        lines.append("%sif (%s) {" % (pad, cond))
        work.append(("text", "%s}" % pad, 0))
        work.append(("node", int(tree.right_child[node]), depth + 1))
        work.append(("text", "%s} else {" % pad, 0))
        work.append(("node", int(tree.left_child[node]), depth + 1))
    lines.append("}")
    return "\n".join(lines)


def _convert_output_code(objective_name: str, sigmoid: float, num_class: int) -> str:
    """ObjectiveFunction::ConvertOutput for the stored objective, generated."""
    if objective_name == "binary":
        return (
            "  output[0] = 1.0 / (1.0 + std::exp(-%.17g * output[0]));\n" % sigmoid
        )
    if objective_name in ("poisson", "gamma", "tweedie"):
        return "  output[0] = std::exp(output[0]);\n"
    if objective_name == "multiclass":
        return (
            "  double m = output[0], s = 0.0;\n"
            "  for (int k = 1; k < %d; ++k) if (output[k] > m) m = output[k];\n"
            "  for (int k = 0; k < %d; ++k) { output[k] = std::exp(output[k] - m); s += output[k]; }\n"
            "  for (int k = 0; k < %d; ++k) output[k] /= s;\n" % (num_class, num_class, num_class)
        )
    if objective_name == "multiclassova":
        return (
            "  for (int k = 0; k < %d; ++k)\n"
            "    output[k] = 1.0 / (1.0 + std::exp(-%.17g * output[k]));\n"
            % (num_class, sigmoid)
        )
    if objective_name in ("cross_entropy", "xentropy"):
        return "  output[0] = 1.0 / (1.0 + std::exp(-output[0]));\n"
    if objective_name in ("cross_entropy_lambda", "xentlambda"):
        return "  output[0] = std::log1p(std::exp(output[0]));\n"
    return ""  # identity (regression family, lambdarank)


def save_model_to_ifelse(gbdt, num_iteration: int = -1) -> str:
    """Generate the standalone C++ source for the first ``num_iteration``
    iterations (GBDT::SaveModelToIfElse, gbdt_model_text.cpp:223-248)."""
    trees = gbdt.trees()
    K = max(gbdt.num_tree_per_iteration, 1)
    use = len(trees)
    if num_iteration is not None and num_iteration > 0:
        use = min(use, num_iteration * K)
    obj = gbdt.objective
    obj_name = obj.name.split(" ")[0] if obj is not None else ""
    sigmoid = float(getattr(obj, "sigmoid", 1.0) or 1.0)
    average_output = bool(getattr(gbdt, "average_output", False))

    # provenance: the same sha1 the serving registry reports for this model
    # (model_text.model_fingerprint), so a deployed .cpp can be matched to
    # the model text it was generated from
    from .model_text import model_fingerprint, save_model_to_string

    fingerprint = model_fingerprint(save_model_to_string(gbdt, 0, num_iteration))
    parts: List[str] = [
        "// model_fingerprint: %s" % fingerprint,
        _PRELUDE,
    ]
    for i in range(use):
        parts.append(_tree_ifelse(trees[i], i, predict_leaf=False))
        parts.append("")
    parts.append(
        "double (*PredictTreePtr[])(const double*) = { %s };"
        % ", ".join("PredictTree%d" % i for i in range(use))
    )
    parts.append("")
    parts.append(
        "static const int num_tree_per_iteration_ = %d;\n"
        "static const int num_iteration_for_pred_ = %d;\n" % (K, use // K)
    )
    parts.append(
        "void PredictRaw(const double* features, double* output) {\n"
        "  std::memset(output, 0, sizeof(double) * num_tree_per_iteration_);\n"
        "  for (int i = 0; i < num_iteration_for_pred_; ++i)\n"
        "    for (int k = 0; k < num_tree_per_iteration_; ++k)\n"
        "      output[k] += (*PredictTreePtr[i * num_tree_per_iteration_ + k])(features);\n"
        + (
            "  for (int k = 0; k < num_tree_per_iteration_; ++k)\n"
            "    output[k] /= num_iteration_for_pred_;\n"
            if average_output
            else ""
        )
        + "}\n"
    )
    parts.append(
        "void Predict(const double* features, double* output) {\n"
        "  PredictRaw(features, output);\n"
        + _convert_output_code(obj_name, sigmoid, K)
        + "}\n"
    )
    for i in range(use):
        parts.append(_tree_ifelse(trees[i], i, predict_leaf=True))
        parts.append("")
    parts.append(
        "double (*PredictTreeLeafPtr[])(const double*) = { %s };"
        % ", ".join("PredictTree%dLeaf" % i for i in range(use))
    )
    parts.append(
        "\nvoid PredictLeafIndex(const double* features, double* output) {\n"
        "  for (int i = 0; i < num_iteration_for_pred_ * num_tree_per_iteration_; ++i)\n"
        "    output[i] = (*PredictTreeLeafPtr[i])(features);\n"
        "}\n"
    )
    parts.append("}  // namespace lightgbm_tpu_model")
    return "\n".join(parts) + "\n"
