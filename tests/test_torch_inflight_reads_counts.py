"""Reads in the middle of a fused run, as tests/test_torch_inflight_reads.py
checks them (`check_read`): num_trees and feature_importance drain first
and agree with the same read of a booster trained to that round by
`train`, and with the JAX booster's read at that round; training on after
the read ends where an unread run ends.
"""
import pytest

from test_torch_inflight_reads import check_read


@pytest.mark.parametrize("read", ["feature_importance", "num_trees"])
def test_read_in_training_drains_first(read):
    check_read(read)
