"""A numpy model of K3's tile schedule (csrc/partition.cuh, in place).

K3 partitions a segment in one launch: blocks claim tiles of T rows with
an atomic ticket; each tile decides its rows from the key plane and
publishes its A count in a status word; once its whole tile is in shared
memory it sets its staged flag, looks back over its predecessors' status
words for its A prefix, waits for the staged flags of the earlier tiles
whose columns its A run covers, and then writes its A rows at dst_a +
prefix and its B rows at dst_b + (t*T - prefix).  With the ring a block
claims the next tile, and publishes its count, before it finishes the
current one.  Stream A may land on the segment's own columns (dst_a ==
start) or before them.  The kernel's header argues that no tile then
writes a column of a tile that has not staged it.

The model runs that schedule with several blocks whose steps a random
scheduler interleaves (a tile reads its rows at the last moment the kernel
allows, just before its staged flag; its stores land a few columns at a
time), with and without the ring, on random decisions, tile sizes,
segment starts and dst_a <= start (equal, overlapping from before,
disjoint), and checks at every store that the column's tile has staged;
at the end the arena must hold the stable partition, and no schedule may
deadlock.  A dst_a past the start breaks the argument (the kernel waits
only for tiles before its own), and the model must catch it.
"""
import numpy as np
import pytest


class Violation(Exception):
    pass


def simulate(flags, T, start, dst_a, dst_b, nblocks, rng, cap, ring=True):
    """Run one random interleaving; returns the arena (each column holds
    the id of the row in it).  Raises Violation when a store hits a column
    of the segment whose tile has not staged its rows."""
    cnt = len(flags)
    arena = np.arange(cap)
    ntiles = -(-cnt // T)
    status = [None] * ntiles          # None, ("A", count) or ("I", prefix)
    staged = [False] * ntiles
    ticket = [0]
    blocks = [dict(state="claim") for _ in range(nblocks)]

    def check(col):
        if start <= col < start + cnt:
            t = (col - start) // T
            if not staged[t]:
                raise Violation("column %d of tile %d, not staged" % (col, t))

    def claim():
        t = ticket[0]
        ticket[0] += 1
        return t if t < ntiles else None

    def publish(t):
        """Decide tile t from its key plane and publish its count."""
        lo = t * T
        na = int(flags[lo:lo + T].sum())
        status[t] = ("I", na) if t == 0 else ("A", na)

    def step(b):
        """Advance block b by one action; False when it cannot move."""
        s = b["state"]
        if s == "claim":                      # the first tile, or no ring
            b["t"] = claim()
            b["state"] = "done" if b["t"] is None else "publish"
        elif s == "publish":
            publish(b["t"])
            b["state"] = "next" if ring else "stage"
        elif s == "next":                     # the ring: the next tile
            b["tn"] = claim()
            if b["tn"] is not None:
                publish(b["tn"])
            b["state"] = "stage"
        elif s == "stage":
            t = b["t"]
            lo = t * T
            b["rows"] = arena[start + lo:start + min(lo + T, cnt)].copy()
            b["flags"] = flags[lo:lo + len(b["rows"])]
            staged[t] = True
            b["state"] = "lookback"
        elif s == "lookback":
            t = b["t"]
            prefix = 0
            for j in range(t - 1, -1, -1):
                if status[j] is None:
                    return False              # spins on j
                prefix += status[j][1]
                if status[j][0] == "I":
                    break
            status[t] = ("I", prefix + int(b["flags"].sum()))
            b["prefix"] = prefix
            b["state"] = "wait"
        elif s == "wait":
            t, prefix, na = b["t"], b["prefix"], int(b["flags"].sum())
            lo, hi = max(dst_a + prefix, start), min(dst_a + prefix + na,
                                                     start + cnt)
            if lo < hi and not all(staged[u] for u in range(
                    (lo - start) // T, min((hi - 1 - start) // T, t - 1)
                    + 1)):
                return False                  # spins on a staged flag
            rows, f = b["rows"], b["flags"]
            b["stores"] = ([(dst_a + prefix + k, r)
                            for k, r in enumerate(rows[f])]
                           + [(dst_b + t * T - prefix + k, r)
                              for k, r in enumerate(rows[~f])])
            rng.shuffle(b["stores"])
            b["state"] = "write"
        elif s == "write":
            k = int(rng.randint(1, 5))
            for col, r in b["stores"][:k]:
                check(col)
                arena[col] = r
            del b["stores"][:k]
            if not b["stores"]:
                if not ring:
                    b["state"] = "claim"
                elif b["tn"] is None:
                    b["state"] = "done"
                else:
                    b["t"] = b["tn"]
                    b["state"] = "next"
        else:
            return False
        return True

    while any(b["state"] != "done" for b in blocks):
        order = rng.permutation(nblocks)
        if not any(step(blocks[i]) for i in order):
            raise AssertionError("no block can move: the schedule deadlocks")
    return arena


def _expected(flags, start, dst_a, dst_b, cap):
    arena = np.arange(cap)
    rows = arena[start:start + len(flags)].copy()
    na = int(flags.sum())
    arena[dst_a:dst_a + na] = rows[flags]
    arena[dst_b:dst_b + len(flags) - na] = rows[~flags]
    return arena


def _case(cnt, T, where, seed):
    rng = np.random.RandomState(seed)
    start = 3 * T + int(rng.randint(0, 2 * T)) + 7
    dst_a = {"in_place": start,
             "overlap_before": max(start - int(rng.randint(1, 2 * T)), 0),
             "disjoint_before": 0,
             "disjoint_after": start + cnt + 5}[where]
    if where == "disjoint_before":
        start = max(start, cnt + 1)
    dst_b = max(start, dst_a) + cnt + 11
    cap = dst_b + cnt + 16
    flags = rng.rand(cnt) < rng.choice([0.1, 0.5, 0.9])
    return flags, start, dst_a, dst_b, cap, rng


@pytest.mark.parametrize("ring", [True, False])
@pytest.mark.parametrize("where", ["in_place", "overlap_before",
                                   "disjoint_before", "disjoint_after"])
@pytest.mark.parametrize("T,cnt", [(16, 0), (16, 1), (16, 15), (16, 16),
                                   (16, 17), (4, 203), (16, 500), (64, 2000)])
def test_no_tile_writes_an_unstaged_tile(T, cnt, where, ring):
    for seed in range(6):
        flags, start, dst_a, dst_b, cap, rng = _case(cnt, T, where, seed)
        for nblocks in (1, 3, 8):
            got = simulate(flags, T, start, dst_a, dst_b, nblocks, rng, cap,
                           ring)
            want = _expected(flags, start, dst_a, dst_b, cap)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ring", [True, False])
def test_dst_a_past_the_start_is_caught(ring):
    """The model has teeth: with stream A written past the segment's start,
    some schedule stores into a later tile that has not staged its rows."""
    caught = 0
    for seed in range(20):
        rng = np.random.RandomState(seed)
        T, cnt, start = 16, 400, 64
        flags = rng.rand(cnt) < 0.9
        try:
            simulate(flags, T, start, start + 2 * T, start + cnt + 8, 6, rng,
                     start + 2 * cnt + 64, ring)
        except Violation:
            caught += 1
    assert caught > 0
