"""Multiclass training against the JAX package on the CPU, the cases of
tests/test_torch_multiclass.py's `CASES` beyond the fused f32 ones: softmax
and OVA quantized on the fused pristine path (each class's codes under the
iteration's key folded with the class), the eager path with a validation
set and multi_logloss / multi_error (each tree fetched in its round; the
metrics rtol 1e-6 of JAX's), and a bag drawn once an iteration and shared
by every class; each held as that file holds its cases."""
import pytest

from test_torch_multiclass import check_training_case

PATH_CASES = ("softmax-fused-quantized", "ova-fused-quantized",
              "softmax-valid", "softmax-bagged")


@pytest.mark.parametrize("case", PATH_CASES)
def test_training_matches_jax(case):
    check_training_case(case)
