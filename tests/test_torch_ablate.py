"""K8, the stage ablation of K3 (ops/partition_kernel.partition_ablate),
on the CPU through its plain version:

- the full stage is K3: the same planes and counts as K3's plain version;
  the stages before it move no row and leave the arena as it was;
- the per-tile checksums of the read, decide, lookback and stage stages
  add up, over the tiles, to what their definitions give in closed form:
  every plane word summed once; plus one per stream-A row; plus each row's
  destination column; plus every plane word once more; and each tile's
  checksum is the same sum over its own rows;
- an unknown stage is refused.

The CUDA stages are held to these plain versions on the card
(tests/test_torch_gpu.py::test_partition_ablate_matches_plain).
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import partition_kernel as pk

N, G, B = 5000, 5, 40


def _arena(quantized, seed=3):
    rng = np.random.RandomState(seed)
    a = pk.Arena(N, G, 3, "cpu", quantized=quantized)
    pk.init_pristine(a, torch.from_numpy(
        rng.randint(0, B, (G, N)).astype(np.uint8)))
    if quantized:
        a.payload[:, :N] = torch.from_numpy(
            rng.randint(-127, 128, (2, N)).astype(np.int8))
    else:
        a.payload[:, :N] = torch.from_numpy(
            rng.randn(2, N).astype(np.float32))
    return a


def _sc(dst_b):
    return torch.tensor([0, N, 0, dst_b, 0, 0, 1, 0], dtype=torch.int32)


GOLEFT = (torch.arange(256) < B // 2).to(torch.uint8)
DST_B = pk.pristine_work0(N)


def _words(a, lo=0, hi=N):
    w = a.bins[:, lo:hi].numpy().astype(np.int64).sum(0)
    p = a.payload[:, lo:hi].numpy()
    w = w + (p.view(np.uint32) if p.dtype == np.float32
             else p.view(np.uint8)).astype(np.int64).sum(0)
    return w + a.rid[lo:hi].numpy().astype(np.int64)


def _checksum(a, stage):
    sc = _sc(DST_B)
    chk = pk.partition_ablate(a, sc, GOLEFT, stage)
    return chk.numpy().astype(np.int64), sc


@pytest.mark.parametrize("quantized", [False, True])
def test_full_and_scatter_stages_are_k3(quantized):
    """The full stage is K3; no stage before it (the scatter stage of the
    first K8 is now split into lookback, stage and the stores) moves a
    row."""
    want = _arena(quantized)
    sc_w = _sc(DST_B)
    pk.partition_segment_plain(want, sc_w, GOLEFT)
    full = _arena(quantized)
    sc = _sc(DST_B)
    assert pk.partition_ablate(full, sc, GOLEFT, "full") is None
    assert torch.equal(sc, sc_w)
    for x, y in ((full.bins, want.bins), (full.payload, want.payload),
                 (full.rid, want.rid)):
        assert torch.equal(x, y)
    for stage in pk.ABLATE_STAGES[:-1]:
        part, same = _arena(quantized), _arena(quantized)
        pk.partition_ablate(part, _sc(DST_B), GOLEFT, stage)
        for x, y in ((part.bins, same.bins), (part.payload, same.payload),
                     (part.rid, same.rid)):
            assert torch.equal(x, y), stage


@pytest.mark.parametrize("quantized", [False, True])
def test_checksum_stages_add_up(quantized):
    a = _arena(quantized)
    T = pk.partition_tile(G, quantized)
    words = _words(a)
    total = int(words.sum()) % (1 << 32)
    read, sc = _checksum(a, "read")
    assert len(read) == -(-N // T)
    assert int(read.sum()) % (1 << 32) == total
    for t in range(len(read)):
        assert (read[t] - int(words[t * T:(t + 1) * T].sum())) % (1 << 32) \
            == 0
    assert int(sc[pk.SC_CNT_A]) == 0          # read writes no count
    is_a = (GOLEFT[a.bins[1, :N].long()] != 0).numpy()
    n_a, n_b = int(is_a.sum()), N - int(is_a.sum())
    decide, sc = _checksum(a, "decide")
    assert int(decide.sum()) % (1 << 32) == (total + n_a) % (1 << 32)
    assert int(sc[pk.SC_CNT_A]) == 0          # nor does decide
    dests = n_a * (n_a - 1) // 2 + n_b * DST_B + n_b * (n_b - 1) // 2
    look, sc = _checksum(a, "lookback")
    assert int(look.sum()) % (1 << 32) == (total + n_a + dests) % (1 << 32)
    assert (int(sc[pk.SC_CNT_A]), int(sc[pk.SC_CNT_B])) == (n_a, n_b)
    staged, sc = _checksum(a, "stage")
    assert int(staged.sum()) % (1 << 32) \
        == (2 * total + n_a + dests) % (1 << 32)
    assert (int(sc[pk.SC_CNT_A]), int(sc[pk.SC_CNT_B])) == (n_a, n_b)


def test_unknown_stage_is_refused():
    a = _arena(False)
    with pytest.raises(ValueError, match="stage"):
        pk.partition_ablate(a, _sc(DST_B), GOLEFT, "matmul")
    assert pk.ABLATE_STAGES == ("read", "decide", "lookback", "stage", "full")
