"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

The port trains binary (and L2 regression) GBDT models with the serial
learner on the partition (arena) engine, with f32 or quantized int8
gradients (`tpu_quantized_grad`), on the carried arena where the JAX package
picks it; its six kernels are written by hand for Hopper (csrc/*.cu).  It
predicts on the host:

    booster = lightgbm_tpu_torch.train(params,
                                       lightgbm_tpu_torch.Dataset(X, y),
                                       num_boost_round=N)
    booster.predict(X)

Entry points run on the CUDA card unless the caller passes device="cpu";
on a CPU tensor every kernel wrapper runs its plain PyTorch version.  The
package imports torch and numpy, never jax or lightgbm_tpu.
"""
from .basic import Booster, Dataset, LightGBMError
from .config import Config
from .engine import train

__version__ = "0.1.0"
__all__ = ["Booster", "Config", "Dataset", "LightGBMError", "train"]
