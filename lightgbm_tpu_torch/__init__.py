"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

The port trains GBDT models for every objective of the JAX package
(binary, the regression family, cross-entropy, lambdarank over a
Dataset's `group=`, multiclass softmax and one-vs-all with k trees an
iteration) with the serial learner on the partition (arena) or
the label engine, with f32 or quantized int8 gradients
(`tpu_quantized_grad`), on the carried arena where the JAX package picks
it, with bagging, validation sets and early stopping, custom objectives
and eval functions, learning-rate schedules, continued training, `cv` and
the scikit-learn wrappers; its kernels are written by hand for Hopper
(csrc/*.cu).  It predicts on the card:

    booster = lightgbm_tpu_torch.train(
        params, lightgbm_tpu_torch.Dataset(X, y), num_boost_round=N,
        valid_sets=[lightgbm_tpu_torch.Dataset(Xv, yv)],
        early_stopping_rounds=10)
    booster.predict(X, num_iteration=booster.best_iteration)

Entry points run on the CUDA card unless the caller passes device="cpu";
on a CPU tensor every kernel wrapper runs its plain PyTorch version.  The
package imports torch and numpy, never jax or lightgbm_tpu.
"""
from . import callback
from .basic import Booster, Dataset, LightGBMError
from .callback import (EarlyStopException, early_stopping, print_evaluation,
                       record_evaluation, reset_parameter)
from .config import Config
from .engine import CVBooster, cv, train
from .plotting import (create_tree_digraph, plot_importance, plot_metric,
                       plot_tree)
from .sklearn import LGBMClassifier, LGBMModel, LGBMRanker, LGBMRegressor

__version__ = "0.1.0"
__all__ = ["Booster", "CVBooster", "Config", "Dataset", "EarlyStopException",
           "LGBMClassifier", "LGBMModel", "LGBMRanker", "LGBMRegressor",
           "LightGBMError", "callback", "create_tree_digraph", "cv",
           "early_stopping", "plot_importance", "plot_metric", "plot_tree",
           "print_evaluation", "record_evaluation", "reset_parameter",
           "train"]
