"""PyTorch port: the lane fleet run as a whole against the JAX package, on
the CPU, in f64, at the size of tests/test_torch_batch.py (4 lanes, n_max
32, 3 steps, 2 episodes, the lane SQP at n_safe 2, 2 outer x 2 inner, 8
fit steps):

  * ``run_experiment`` on ``pendulum_batch_sqp``, fed the JAX CLI's draws
    rebuilt from its key splits: each episode of
    ``run_batched_episodes_lanes`` (feasible flags and violations equal,
    trajectories at 1e-8, the applied controls and states at 1e-6), the
    ``run_batched_learning`` series and final per-lane model at 1e-8;
  * the CLI on ``--device cpu`` (JSON keys equal to JAX's);
  * the single-model entries raise on a stacked model.

The JAX fleet run is made once for the module.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu.runtime import batch as jbatch  # noqa: E402
from safe_exploration_tpu.runtime.main import (  # noqa: E402
    run_experiment as jax_run_experiment,
)
from safe_exploration_tpu_torch.models import gp as tgp  # noqa: E402
from safe_exploration_tpu_torch.models import gp_lanes as tgl  # noqa: E402
from safe_exploration_tpu_torch.models import ssm as tssm_mod  # noqa: E402
from safe_exploration_tpu_torch.runtime import batch as tbatch  # noqa: E402
from safe_exploration_tpu_torch.runtime.main import (  # noqa: E402
    _apply_overrides,
    main,
    run_experiment,
)
from test_torch_batch import (  # noqa: E402
    B,
    CFG,
    F64,
    KT,
    SET,
    _assert_lane_gp,
    _jcfg,
    _np,
    _rel,
    _t,
)
from test_torch_bridge import (  # noqa: E402,F401
    jax_batch_draws,
    one_torch_thread,
)


@pytest.fixture(scope="module")
def stacked():
    """A stacked GP-SSM of B lanes with per-lane hyperparameters (a lane
    model unstacked), built by the port alone."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.0, 1.0, (12, 3)) * [0.3, 1.0, 1.0]
    y = 0.05 * np.sin(2.0 * x[:, :2])
    one = tssm_mod.make_gp_ssm(
        KT, _t(x[:, :2]), _t(x[:, 2:]), _t(y), n_max=32,
        l_mu=torch.full((2,), 0.5, dtype=torch.float64),
        l_sigma=torch.full((2,), 0.25, dtype=torch.float64))
    return tgl.lane_unstack_ssm(tgl.lane_stack_ssm(one, B))


@pytest.mark.parametrize("entry", ["gp_predict", "gp_predict_mean_jac",
                                   "gp_update_data", "gp_shrink_to_bucket",
                                   "ssm_update", "ssm_bucketed"])
def test_single_model_entries_raise_on_a_stacked_model(stacked, entry):
    """The entries that take one model raise on the stacked GP (they would
    read the lane axis as the buffer's), naming where per-lane models
    predict and append."""
    z, y = torch.zeros((2, 3), dtype=torch.float64), torch.zeros(
        (2, 2), dtype=torch.float64)
    calls = {
        "gp_predict": lambda: tgp.gp_predict(stacked.gp, z),
        "gp_predict_mean_jac": lambda: tgp.gp_predict_mean_jac(stacked.gp, z),
        "gp_update_data": lambda: tgp.gp_update_data(stacked.gp, z, y),
        "gp_shrink_to_bucket": lambda: tgp.gp_shrink_to_bucket(stacked.gp),
        "ssm_update": lambda: tssm_mod.ssm_update(stacked, z[:, :2],
                                                  z[:, 2:], y),
        "ssm_bucketed": lambda: tssm_mod.ssm_bucketed(stacked),
    }
    with pytest.raises(ValueError, match="gp_lanes"):
        calls[entry]()


def _jax_batch_draws(cfg, lanes_, dtype=F64) -> dict:
    """The JAX CLI's batch-task draws (``jax_batch_draws``) as tensors."""
    return {k: _t(v) for k, v in jax_batch_draws(cfg, lanes_, dtype).items()}


def _recorder(monkeypatch, mod, name, store):
    fn = getattr(mod, name)

    def recorded(*args, **kwargs):
        out = fn(*args, **kwargs)
        store.append(out)
        return out

    monkeypatch.setattr(mod, name, recorded)


@pytest.fixture(scope="module")
def fleet():
    """run_experiment on pendulum_batch_sqp (tiny) by both packages, the
    port on the JAX run's draws; each episode's (traj, model) and the
    learning run's result recorded on both sides."""
    rec = {k: [] for k in ("j_ep", "t_ep", "j_run", "t_run")}
    with pytest.MonkeyPatch.context() as mp:
        _recorder(mp, jbatch, "run_batched_episodes_lanes", rec["j_ep"])
        _recorder(mp, jbatch, "run_batched_learning", rec["j_run"])
        _recorder(mp, tbatch, "run_batched_episodes_lanes", rec["t_ep"])
        _recorder(mp, tbatch, "run_batched_learning", rec["t_run"])
        ref = jax_run_experiment(_jcfg(), dtype=F64)
        out = run_experiment(CFG, dtype=torch.float64, device="cpu",
                             draws=_jax_batch_draws(CFG, B))
    return ref, out, rec


def test_run_batched_episodes_lanes_matches_jax_with_its_draws(fleet):
    """Each episode: feasible flags and violations equal, the lane model it
    hands back (3 appends) and the residuals, model errors and violations
    at 1e-8. The applied controls, and the states they drive, at 1e-6:
    on feasible steps they are the SQP's solutions, which agree with JAX's
    to ~1e-7 here (the lane-SQP gate of tests/test_torch_sqp_lanes.py is
    1e-4)."""
    _, _, rec = fleet
    assert len(rec["t_ep"]) == len(rec["j_ep"]) == CFG.n_ep
    for (tt, tm), (jt, jm) in zip(rec["t_ep"], rec["j_ep"]):
        np.testing.assert_array_equal(_np(tt["feasible"]), jt["feasible"])
        np.testing.assert_array_equal(_np(tt["constraint_ok"]),
                                      jt["constraint_ok"])
        assert tt["x"].shape == (B, CFG.n_steps, 2)
        for k, tol in (("x", 1e-6), ("u", 1e-6), ("resid", 1e-8),
                       ("model_err", 1e-8), ("violation", 1e-8)):
            assert _rel(_np(tt[k]), jt[k]) < tol, k
        _assert_lane_gp(tm.gp, jm.gp, 1e-8)


def test_run_batched_learning_matches_jax_with_its_draws(fleet):
    """The series (counts equal, floats at 1e-8) and the final per-lane
    model (hyperparameters, Lipschitz constants and factors) at 1e-8."""
    ref, out, rec = fleet
    rs, ts = ref["series"], out["series"]
    for k in ("violations", "feasibility_rate", "n_data", "lane_backend",
              "lanes"):
        assert ts[k] == rs[k], k
    assert rs["violations"] == [0, 0] and rs["n_data"] == [11, 14]
    print(rs["feasibility_rate"])
    for k in ("model_error", "mean_cost"):
        np.testing.assert_allclose(ts[k], rs[k], rtol=1e-8, atol=0)
    (tr,), (jr,) = rec["t_run"], rec["j_run"]
    tm, jm = tr["model"], jr["model"]
    assert tm.gp.per_lane_hypers
    _assert_lane_gp(tm.gp, jm.gp, 1e-8)
    for f in ("l_mu", "l_sigma"):
        assert _rel(_np(getattr(tm, f)), getattr(jm, f)) < 1e-8, f


def test_batch_cli_on_cpu_prints_jax_keys(fleet, capsys):
    """The CLI's summary keys and series keys equal the JAX CLI's, with 0
    violations; the single-episode branch gives JAX's n_ep = 1 keys."""
    ref, _, _ = fleet
    rc = main(["--config", "pendulum_batch_sqp", "--device", "cpu", "--set",
               *SET])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out)
    assert set(summary) == set(ref) - {"config"}
    assert set(summary["series"]) == set(ref["series"])
    assert summary["series"]["violations"] == [0, 0]
    one = run_experiment(_apply_overrides(CFG, ["n_ep=1", "n_steps=1"]),
                         dtype=torch.float64, device="cpu")["series"]
    assert set(one) == {"lane_backend", "violations", "feasibility_rate",
                        "model_error", "lanes", "steps_per_sec"}
    assert one["violations"] == [0] and one["lanes"] == [B]


