"""Learning-rate schedules and `reset_parameter` on the partition engine in
the port against the JAX package, on the CPU (its Pallas kernels in
interpret mode).

tests/test_torch_schedule.py's 6 rounds of binary 7-leaf trees on 2,000
rows (`max_bin` 63) with a validation set, its `learning_rates` and
`callback.reset_parameter` of `lambda_l2` and `min_data_in_leaf`, with
bagging on from the first round and `bagging_fraction` cut from 0.8 to 0.6
mid-run (the label engine's run switches bagging on; one bagged schedule
keeps the JAX package to one compilation of its bagged partition rounds).
Equal bags, trees as tests/test_torch_bagging.py's `_assert_models_match`
holds them, shrinkages equal, predictions within its rtol 1e-4, atol 1e-6
and evals_result within 1e-6.  The seed holds no exact tie between two
thresholds with no in-bag row between them (ROADMAP.md queue 3).
"""
import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from test_torch_goss import data
from test_torch_schedule import _train, check_schedule_matches_jax

SCHEDULE = dict(lambda_l2=[0.0, 1.0, 1.0, 5.0, 5.0, 0.5],
                min_data_in_leaf=[20, 20, 40, 40, 10, 10],
                bagging_fraction=[0.8, 0.8, 0.8, 0.6, 0.6, 0.6],
                bagging_freq=[1, 1, 1, 1, 1, 1])


def test_schedule_matches_jax_eager_on_the_partition_engine():
    X, y = data("binary", n=2000, seed=4)
    jm, tm = [], []
    c = dict(X=X, jm=jm, tm=tm,
             port=_train(tlgb, "partition", X, y, True, tm,
                         schedule=SCHEDULE, device="cpu"),
             jax=_train(jlgb, "partition", X, y, True, jm,
                        schedule=SCHEDULE))
    assert c["port"][0]._gbdt._use_partition_engine
    check_schedule_matches_jax(c, SCHEDULE)
