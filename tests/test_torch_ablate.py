"""K8, the stage ablation of K3 (ops/partition_kernel.partition_ablate),
on the CPU through its plain version:

- the full stage is K3: the same planes and counts as K3's plain version;
- the scatter stage leaves stream B where K3 puts it and stream A in the
  scratch arena's first columns, in K3's order;
- the checksums of the read, decide and scan stages add up, over the
  blocks, to what their definitions give in closed form: every plane word
  summed once; plus one per stream-A row; plus each row's destination;
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


def _plane_total(a):
    words = [a.bins[:, :N].numpy().astype(np.int64).sum()]
    p = a.payload[:, :N].numpy()
    words.append((p.view(np.uint32) if p.dtype == np.float32
                  else p.view(np.uint8)).astype(np.int64).sum())
    words.append(a.rid[:N].numpy().astype(np.int64).sum())
    return sum(words)


def _checksum(a, stage):
    sc = _sc(DST_B)
    pk.partition_ablate(a, sc, GOLEFT, stage)
    return int(a.s_rid[:pk.PARTITION_BLOCKS].numpy().astype(np.int64)
               .sum()) % (1 << 32), sc


@pytest.mark.parametrize("quantized", [False, True])
def test_full_and_scatter_stages_are_k3(quantized):
    want = _arena(quantized)
    sc_w = _sc(DST_B)
    pk.partition_segment_plain(want, sc_w, GOLEFT)
    n_a = int(sc_w[pk.SC_CNT_A])
    full = _arena(quantized)
    sc = _sc(DST_B)
    pk.partition_ablate(full, sc, GOLEFT, "full")
    assert torch.equal(sc, sc_w)
    for x, y in ((full.bins, want.bins), (full.payload, want.payload),
                 (full.rid, want.rid)):
        assert torch.equal(x, y)
    part = _arena(quantized)
    sc = _sc(DST_B)
    pk.partition_ablate(part, sc, GOLEFT, "scatter")
    assert torch.equal(sc, sc_w)
    for x, y, s in ((part.bins, want.bins, part.s_bins),
                    (part.payload, want.payload, part.s_payload),
                    (part.rid[None], want.rid[None], part.s_rid[None])):
        assert torch.equal(x[:, DST_B:DST_B + N - n_a],
                           y[:, DST_B:DST_B + N - n_a])
        assert torch.equal(s[:, :n_a], y[:, :n_a])


@pytest.mark.parametrize("quantized", [False, True])
def test_checksum_stages_add_up(quantized):
    a = _arena(quantized)
    total = _plane_total(a) % (1 << 32)
    read, sc = _checksum(a, "read")
    assert read == total
    assert int(sc[pk.SC_CNT_A]) == 0          # read writes no count
    is_a = (GOLEFT[a.bins[1, :N].long()] != 0).numpy()
    n_a, n_b = int(is_a.sum()), N - int(is_a.sum())
    decide, _ = _checksum(a, "decide")
    assert decide == (total + n_a) % (1 << 32)
    scan, sc = _checksum(a, "scan")
    dests = n_a * (n_a - 1) // 2 + n_b * DST_B + n_b * (n_b - 1) // 2
    assert scan == (total + n_a + dests) % (1 << 32)
    assert (int(sc[pk.SC_CNT_A]), int(sc[pk.SC_CNT_B])) == (n_a, n_b)


def test_unknown_stage_is_refused():
    a = _arena(False)
    with pytest.raises(ValueError, match="stage"):
        pk.partition_ablate(a, _sc(DST_B), GOLEFT, "matmul")
    assert pk.ABLATE_STAGES == ("read", "decide", "scan", "scatter", "full")
