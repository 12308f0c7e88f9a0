"""EFB-bundled 3-class softmax at Covertype's one-hot layout against the
JAX package on the CPU (the fused pristine path, k trees a round through
the group columns), held as tests/test_torch_efb_paths.py holds its
runs."""
from test_torch_efb_paths import check_case


def test_training_matches_jax():
    check_case("multiclass")
