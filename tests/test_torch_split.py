"""Parity of the port's K1 plain version (ops/split_kernel.py) with the JAX
split scans: the Pallas kernel in interpret mode
(split_pallas.best_splits_pallas / best_split_rows_pallas) and the XLA scan
(ops/split.best_split_per_feature), on the cases of tests/test_split_pallas.py;
and of the port's vectorized scan (ops/split.py) with the JAX one."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu.ops import split_pallas as sp_pl
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops import split_kernel as sk

FIELDS = ("left_sum_gradient", "left_sum_hessian", "left_count",
          "left_output", "right_sum_gradient", "right_sum_hessian",
          "right_count", "right_output")


def _rand_hist(rng, F, B, n_rows=5000):
    cnt = rng.multinomial(n_rows, np.ones(F * B) / (F * B)).reshape(F, B)
    g = rng.standard_normal((F, B)) * np.sqrt(cnt + 1e-3)
    h = rng.random((F, B)) * cnt * 0.25 + cnt * 1e-3
    return np.stack([g, h, cnt.astype(np.float64)], axis=-1).astype(np.float32)


def _sums(hist2):
    return (hist2[..., 0].sum((1, 2)), hist2[..., 1].sum((1, 2)),
            hist2[..., 2].sum((1, 2)).astype(np.int32))


def _case(name):
    """(hist [CH, F, B, 3], statics, params dict, extras) per case."""
    if name.startswith("missing"):
        missing = name.split("_")[1]
        rng = np.random.default_rng(hash(missing) % 2**31)
        F, B = 9, 64
        hist2 = np.stack([_rand_hist(rng, F, B), _rand_hist(rng, F, B)])
        mt = (rng.integers(0, 3, F) if missing == "mixed"
              else np.full(F, int(missing)))
        return dict(hist=hist2, nb=rng.integers(3, B + 1, F),
                    db=rng.integers(0, 3, F), mt=mt,
                    params=dict(min_data_in_leaf=20))
    if name == "regularization_monotone":
        rng = np.random.default_rng(5)
        F, B = 7, 32
        hist2 = np.stack([_rand_hist(rng, F, B), _rand_hist(rng, F, B)])
        return dict(hist=hist2, nb=np.full(F, B), db=np.zeros(F),
                    mt=np.full(F, 1),
                    params=dict(lambda_l1=0.5, lambda_l2=2.0,
                                max_delta_step=0.4, min_data_in_leaf=50,
                                min_sum_hessian_in_leaf=1.0,
                                min_gain_to_split=0.1),
                    monotone=rng.integers(-1, 2, F),
                    minc=np.array([-0.2, -np.inf]),
                    maxc=np.array([0.2, np.inf]))
    if name == "penalties_mask":
        rng = np.random.default_rng(9)
        F, B = 6, 16
        return dict(hist=np.stack([_rand_hist(rng, F, B)]), nb=np.full(F, B),
                    db=np.zeros(F), mt=np.zeros(F),
                    params=dict(min_data_in_leaf=5, cegb_split_penalty=1e-6),
                    penalty=rng.random(F).astype(np.float32) + 0.5,
                    fmask=rng.random(F) > 0.3,
                    cegb=rng.random(F).astype(np.float32) * 0.1)
    if name == "degenerate":
        F, B = 4, 8
        hist = np.zeros((1, F, B, 3), np.float32)
        hist[..., 2] = 10.0
        hist[..., 1] = 2.5
        return dict(hist=hist, nb=np.full(F, B), db=np.zeros(F),
                    mt=np.zeros(F), params=dict(min_data_in_leaf=1))
    if name == "asymmetric":
        rng = np.random.default_rng(3)
        F, B = 5, 16
        bad = np.zeros((F, B, 3), np.float32)
        bad[:, 0, 0], bad[:, 0, 1], bad[:, 0, 2] = 3.0, 5.0, 100.0
        return dict(hist=np.stack([_rand_hist(rng, F, B), bad]),
                    nb=np.full(F, B), db=np.zeros(F), mt=np.zeros(F),
                    params=dict(min_data_in_leaf=5))
    raise KeyError(name)


CASES = ["missing_0", "missing_1", "missing_2", "missing_mixed",
         "regularization_monotone", "penalties_mask", "degenerate",
         "asymmetric"]


def _port_fvec(c, CH):
    def t(v, dt=torch.int32):
        return None if v is None else torch.as_tensor(np.asarray(v)).to(dt)
    return sk.build_feature_statics(
        t(c["nb"]), t(c["db"]), t(c["mt"]), monotone=t(c.get("monotone")),
        penalty=t(c.get("penalty"), torch.float32),
        feature_mask=t(c.get("fmask"), torch.bool),
        cegb_feature_penalty=t(c.get("cegb"), torch.float32), children=CH)


def _jax_fvec(c, CH):
    def j(v, dt=jnp.int32):
        return None if v is None else jnp.asarray(np.asarray(v), dt)
    return sp_pl.build_feature_statics(
        j(c["nb"]), j(c["db"]), j(c["mt"]), monotone=j(c.get("monotone")),
        penalty=j(c.get("penalty"), jnp.float32),
        feature_mask=j(c.get("fmask"), bool),
        cegb_feature_penalty=j(c.get("cegb"), jnp.float32), children=CH)


def _port_pf(c):
    hist = c["hist"]
    sg, sh, nd = _sums(hist)
    return sk.best_splits(
        torch.from_numpy(hist), torch.from_numpy(sg), torch.from_numpy(sh),
        torch.from_numpy(nd), _port_fvec(c, hist.shape[0]),
        tsplit.SplitParams(**c["params"]),
        min_constraints=c.get("minc"), max_constraints=c.get("maxc"))


def _jax_pallas_pf(c):
    hist = c["hist"]
    sg, sh, nd = _sums(hist)
    minc, maxc = c.get("minc"), c.get("maxc")
    return sp_pl.best_splits_pallas(
        jnp.asarray(hist), jnp.asarray(sg), jnp.asarray(sh), jnp.asarray(nd),
        _jax_fvec(c, hist.shape[0]), jsplit.SplitParams(**c["params"]),
        min_constraints=None if minc is None else jnp.asarray(minc),
        max_constraints=None if maxc is None else jnp.asarray(maxc),
        interpret=True)


def _jax_xla_pf(c, i):
    hist = c["hist"]
    sg, sh, nd = _sums(hist)
    F = hist.shape[1]

    def j(v, dt=jnp.int32):
        return None if v is None else jnp.asarray(np.asarray(v), dt)
    minc, maxc = c.get("minc"), c.get("maxc")
    return jsplit.best_split_per_feature(
        jnp.asarray(hist[i]), jnp.asarray(sg[i]), jnp.asarray(sh[i]),
        jnp.asarray(nd[i]), j(c["nb"]), j(c["db"]), j(c["mt"]),
        jsplit.SplitParams(**c["params"]), monotone=j(c.get("monotone")),
        penalty=j(c.get("penalty"), jnp.float32),
        min_constraints=None if minc is None else jnp.full(F, minc[i]),
        max_constraints=None if maxc is None else jnp.full(F, maxc[i]),
        feature_mask=j(c.get("fmask"), bool),
        cegb_feature_penalty=j(c.get("cegb"), jnp.float32))


def _np(v):
    return np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)


def _close(a, b, rtol, what):
    """rtol against the field's largest magnitude: gains, right-hand sums
    and outputs are differences of parent totals, so their rounding error
    scales with those totals, not with the (possibly small) difference."""
    scale = float(np.abs(b).max()) if b.size else 0.0
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


def _assert_pf_equal(got, want, rtol):
    g_got, g_want = _np(got.gain), _np(want.gain)
    valid = g_got > -np.inf
    np.testing.assert_array_equal(valid, g_want > -np.inf)
    _close(g_got[valid], g_want[valid], rtol, "gain")
    np.testing.assert_array_equal(_np(got.threshold)[valid],
                                  _np(want.threshold)[valid])
    np.testing.assert_array_equal(_np(got.default_left)[valid],
                                  _np(want.default_left)[valid])
    for f in FIELDS:
        a, b = _np(getattr(got, f))[valid], _np(getattr(want, f))[valid]
        if f.endswith("count"):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            _close(a, b, rtol, f)


@pytest.mark.parametrize("name", CASES)
def test_plain_scan_matches_pallas(name):
    c = _case(name)
    _assert_pf_equal(_port_pf(c), _jax_pallas_pf(c), rtol=1e-5)


@pytest.mark.parametrize("name", CASES)
def test_plain_scan_matches_xla_scan(name):
    c = _case(name)
    got = _port_pf(c)
    for i in range(c["hist"].shape[0]):
        one = type(got)(*[v[i] for v in got])
        _assert_pf_equal(one, _jax_xla_pf(c, i), rtol=1e-5)


@pytest.mark.parametrize("name", CASES)
def test_selected_rows_match_pallas(name):
    c = _case(name)
    hist = c["hist"]
    sg, sh, nd = _sums(hist)
    params = c["params"]
    minc, maxc = c.get("minc"), c.get("maxc")
    got = sk.best_split_rows(
        torch.from_numpy(hist), torch.from_numpy(sg), torch.from_numpy(sh),
        torch.from_numpy(nd), _port_fvec(c, hist.shape[0]),
        tsplit.SplitParams(**params), min_constraints=minc,
        max_constraints=maxc).numpy()
    want = np.asarray(sp_pl.best_split_rows_pallas(
        jnp.asarray(hist), jnp.asarray(sg), jnp.asarray(sh), jnp.asarray(nd),
        _jax_fvec(c, hist.shape[0]), jsplit.SplitParams(**params),
        min_constraints=None if minc is None else jnp.asarray(minc),
        max_constraints=None if maxc is None else jnp.asarray(maxc),
        interpret=True))[:, :sk.ROW_W]
    for i in range(hist.shape[0]):
        assert int(got[i, sk._OF]) == int(want[i, sk._OF])
        if int(want[i, sk._OF]) < 0:
            assert got[i, sk._OG] <= sk.NEG_GATE
            continue
        assert int(got[i, sk._OT]) == int(want[i, sk._OT])
        assert got[i, sk._ODL] == want[i, sk._ODL]
        assert got[i, sk._OLC] == want[i, sk._OLC]
        _close(got[i], want[i], 1e-5, "selected row")


def test_vectorized_scan_matches_jax():
    """ops/split.py (the port's twin of the XLA scan) against JAX's."""
    c = _case("missing_mixed")
    hist = c["hist"]
    sg, sh, nd = _sums(hist)
    want = _jax_xla_pf(c, 0)
    got = tsplit.best_split_per_feature(
        torch.from_numpy(hist[0]), float(sg[0]), float(sh[0]), int(nd[0]),
        torch.as_tensor(c["nb"]), torch.as_tensor(c["db"]),
        torch.as_tensor(c["mt"]), tsplit.SplitParams(**c["params"]))
    _assert_pf_equal(got, want, rtol=1e-5)
    res_t = tsplit.select_best_feature(got)
    res_j = jsplit.select_best_feature(want)
    assert int(res_t.feature) == int(res_j.feature)
    assert int(res_t.threshold) == int(res_j.threshold)
    np.testing.assert_allclose(float(res_t.left_sum_hessian),
                               float(res_j.left_sum_hessian), rtol=1e-5)


def test_no_valid_split_row():
    c = _case("degenerate")
    hist = c["hist"]
    row = sk.best_split_rows(
        torch.from_numpy(hist), torch.zeros(1), torch.tensor([100.0]),
        torch.tensor([320]), _port_fvec(c, 1),
        tsplit.SplitParams(min_data_in_leaf=1))[0]
    assert int(row[sk._OF]) == -1 and float(row[sk._OG]) <= sk.NEG_GATE


def test_split_scan_checks_inputs():
    c = _case("degenerate")
    hist = torch.from_numpy(c["hist"])
    fvec = _port_fvec(c, 1)
    svec = sk.child_vector(torch.zeros(1), torch.ones(1), torch.ones(1))
    pvec = sk.params_vector(tsplit.SplitParams(), "cpu")
    with pytest.raises(ValueError):
        sk.split_scan(hist, fvec[:2], svec, pvec)
    with pytest.raises(TypeError):
        sk.split_scan(hist.double(), fvec, svec, pvec)
    with pytest.raises(ValueError):
        sk.split_scan(hist.to("meta"), fvec.to("meta"), svec.to("meta"),
                      pvec.to("meta"))
