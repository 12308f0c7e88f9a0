"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

The port trains GBDT models for every objective of the JAX package
(binary, the regression family, cross-entropy, lambdarank over a
Dataset's `group=`, multiclass softmax and one-vs-all with k trees an
iteration) with the serial learner on the partition (arena) or
the label engine, with f32 or quantized int8 gradients
(`tpu_quantized_grad`), on the carried arena where the JAX package picks
it, with bagging, validation sets and early stopping; its kernels are
written by hand for Hopper (csrc/*.cu).  It predicts on the card:

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
                       record_evaluation)
from .config import Config
from .engine import cv, train

__version__ = "0.1.0"
__all__ = ["Booster", "Config", "Dataset", "EarlyStopException",
           "LightGBMError", "callback", "cv", "early_stopping",
           "print_evaluation", "record_evaluation", "train"]
