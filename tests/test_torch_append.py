"""PyTorch port: the stacked GP's online learning and the model-batched CEM
scorer against the JAX package, on the CPU, in f64, at a tiny size (3
lanes of distinct models, n_max 32, 8 samples a lane):

  * ``gp_append_point`` and ``ssm_append_point`` on one model and on a
    stacked one (3 lockstep appends of per-lane transitions), against JAX's
    (``jax.vmap``-ed for the stack) at 1e-10; the full-buffer no-op; the
    appended factors against a full refit of the same data;
  * the stacked ``ssm_predict`` / ``ssm_predict_jac`` at per-lane points
    against ``jax.vmap`` of JAX's at 1e-10;
  * the model-batched ``tube_score_plain`` (a different model per group of
    lanes) and the stacked ``multistep_reachability`` it stands beside,
    against JAX's portable CEM score (``cem_plan``'s ``score_one``: the tube,
    its violation and the tracking or exploration cost) vmapped over models
    and samples, at 1e-10.

Each JAX program is built once for the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu.models import gp as jgp  # noqa: E402
from safe_exploration_tpu.models import ssm as jssm_mod  # noqa: E402
from safe_exploration_tpu.reachability.onestep import (  # noqa: E402
    multistep_reachability as jax_multistep,
)
from safe_exploration_tpu.runtime import batch as jbatch  # noqa: E402
from safe_exploration_tpu.runtime.config import (  # noqa: E402
    ExperimentConfig as JaxConfig,
    build_experiment as jax_build,
)
from safe_exploration_tpu.solvers.cem import (  # noqa: E402
    tube_violation as jax_tube_violation,
)
from safe_exploration_tpu.solvers.costs import (  # noqa: E402
    exploration_cost as jax_exploration_cost,
)
from safe_exploration_tpu_torch.models import gp as tgp  # noqa: E402
from safe_exploration_tpu_torch.models import ssm as tssm_mod  # noqa: E402
from safe_exploration_tpu_torch.models.convert import gpssm_from_numpy  # noqa: E402
from safe_exploration_tpu_torch.ops.kernels import tube_score_plain  # noqa: E402
from safe_exploration_tpu_torch.reachability.onestep import (  # noqa: E402
    multistep_reachability,
)
from safe_exploration_tpu_torch.runtime import batch as tbatch  # noqa: E402
from safe_exploration_tpu_torch.runtime.config import (  # noqa: E402
    ExperimentConfig,
    build_experiment,
)
from safe_exploration_tpu_torch.solvers.cem import tube_violation  # noqa: E402
from test_torch_bridge import (  # noqa: E402,F401
    jax_gpssm_to_numpy,
    jit_once,
    one_torch_thread,
)

F64 = jnp.float64
KT = ("rbf", "rbf")
B, N_MAX, N0, M, T = 3, 32, 12, 8, 3
KW = dict(n_safe=T, n_max=N_MAX, l_mu=0.05, l_sigma=0.02, log_noise=-4.0)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _transitions(seed, n):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (n, 2)) * [0.3, 1.0]
    u = rng.uniform(-0.5, 0.5, (n, 1))
    y = 0.05 * np.sin(2.0 * x) + 0.01 * rng.standard_normal((n, 2))
    return x, u, y


def _distinct(stacked, refit, arr):
    """Per-lane signal, noise and constants on a stacked model, refitted."""
    lane = np.arange(B)
    gp = stacked.gp
    gp = gp.replace(
        params=tuple({**p, "log_sf": arr(-3.0 + 0.2 * lane)}
                     for p in gp.params),
        log_noise=arr(-4.5 - 0.1 * np.outer(lane, [1, 1])))
    l_mu = 0.04 * np.outer(1.0 + 0.3 * lane, [1, 1])
    return stacked.replace(gp=refit(gp), l_mu=arr(l_mu),
                           l_sigma=arr(0.5 * l_mu))


@pytest.fixture(scope="module")
def models():
    """One JAX model (12 points, n_max 32, z_scale), the port's from its
    arrays; both stacked into 3 lanes with per-lane hyperparameters and
    constants; then 3 lockstep appends of per-lane transitions on each
    side."""
    jexp = jax_build(JaxConfig(**KW), dtype=F64)
    texp = build_experiment(ExperimentConfig(**KW), dtype=torch.float64,
                            device="cpu")
    x, u, y = _transitions(0, N0)
    jm = jexp["make_ssm"](jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(u), jnp.asarray(y))
    tm = gpssm_from_numpy(jax_gpssm_to_numpy(jm), KT, device="cpu")
    js = _distinct(jbatch.stack_ssm(jm, B), jax.vmap(jgp.gp_refit),
                   jnp.asarray)
    ts = _distinct(tbatch.stack_ssm(tm, B), tgp.gp_refit, _t)
    append = jit_once(jax.vmap(jssm_mod.ssm_append_point), js,
                      *(jnp.zeros((B, k)) for k in (2, 1, 2)))
    j, t = {"single": jm, "stack": js}, {"single": tm, "stack": ts}
    for k in range(3):
        xs, us, ys = _transitions(10 + k, B)
        js = append(js, jnp.asarray(xs), jnp.asarray(us), jnp.asarray(ys))
        ts = tssm_mod.ssm_append_point(ts, _t(xs), _t(us), _t(ys))
    j["appended"], t["appended"] = js, ts
    return jexp, texp, j, t


def _assert_gp(tg, jg, tol, fields=("x", "y", "mask", "chol", "beta",
                                    "kinv")):
    for f in fields:
        assert _rel(_np(getattr(tg, f)), getattr(jg, f)) < tol, f
    assert tg.head == int(np.max(np.asarray(jg.head)))


def test_append_point_to_one_model_matches_jax(models):
    """One append to one model at 1e-10."""
    _, _, j, t = models
    x, u, y = (v[0] for v in _transitions(20, 1))
    jo = jax.jit(jssm_mod.ssm_append_point)(
        j["single"], jnp.asarray(x), jnp.asarray(u), jnp.asarray(y))
    to = tssm_mod.ssm_append_point(t["single"], _t(x), _t(u), _t(y))
    _assert_gp(to.gp, jo.gp, 1e-10)
    assert to.gp.head == N0 + 1


def test_lockstep_appends_to_the_stack_match_jax(models):
    """Three lockstep appends to the stacked model against JAX's vmapped
    ones at 1e-10: the shared mask and head advance, each lane learns its
    own points."""
    _, _, j, t = models
    ta, ja = t["appended"], j["appended"]
    _assert_gp(ta.gp, ja.gp, 1e-10)
    assert ta.gp.head == N0 + 3 and ta.gp.mask.shape == (N_MAX,)
    assert not torch.equal(ta.gp.x[0, N0:], ta.gp.x[1, N0:])


def test_append_to_a_full_buffer_is_a_noop(models):
    """A full buffer: the point is dropped and every factor stays, in both
    packages."""
    jexp, _, _, _ = models
    x, u, y = (v[0] for v in _transitions(20, 1))
    xs, us, ys = _transitions(7, N_MAX)
    jf = jexp["make_ssm"](jax.random.PRNGKey(0), jnp.asarray(xs),
                          jnp.asarray(us), jnp.asarray(ys))
    tf = gpssm_from_numpy(jax_gpssm_to_numpy(jf), KT, device="cpu")
    jn = jssm_mod.ssm_append_point(jf, jnp.asarray(x), jnp.asarray(u),
                                   jnp.asarray(y))
    tn = tssm_mod.ssm_append_point(tf, _t(x), _t(u), _t(y))
    assert tn.gp is tf.gp
    _assert_gp(tn.gp, jn.gp, 1e-12)
    _assert_gp(tn.gp, jf.gp, 1e-12)


def test_stacked_append_takes_one_point_per_lane(models):
    """An append to the stack that does not carry one point per lane
    raises, before any factor is touched."""
    _, _, _, t = models
    xs, us, ys = _transitions(7, 2)
    with pytest.raises(ValueError, match="one point per lane"):
        tssm_mod.ssm_append_point(t["stack"], _t(xs), _t(us), _t(ys))


def test_appends_match_a_full_refit(models):
    """The stacked model after 3 appends against the batched refit of its
    own data (JAX's test_incremental_factors_match_full_refit), in both
    packages: chol at 1e-9, beta and K^-1 at 1e-8 relative."""
    _, _, j, t = models
    ta, ja = t["appended"].gp, j["appended"].gp
    tr = tgp.gp_refit(ta)
    jr = jax.vmap(jgp.gp_refit)(ja)
    for f, tol in (("chol", 1e-9), ("beta", 1e-8), ("kinv", 1e-8)):
        assert _rel(_np(getattr(ta, f)), _np(getattr(tr, f))) < tol, f
        assert _rel(getattr(ja, f), getattr(jr, f)) < tol, f


def _jax_score(jexp, c_safety, cost_fn):
    """JAX's portable CEM score (cem_plan's score_one: the tube from x0
    under the sequence, its violation and the cost), vmapped over samples
    and over models."""
    spec = jexp["env"].spec
    k_fb_all = jnp.tile(jexp["k_fb"][None], (T, 1, 1))

    def one(ssm, x0, seq):
        p, q, v = jax_multistep(ssm, x0, seq, k_fb_all, jexp["a"],
                                jexp["b"], c_safety)
        viol = jax_tube_violation(p, q, spec.h_mat_obs, spec.h_obs,
                                  spec.h_mat_safe, spec.h_safe)
        return cost_fn(p, q, v, seq), viol, p

    return jax.vmap(jax.vmap(one, in_axes=(None, None, 0)))


def _lane_points(seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (B, 5, 2)) * [0.3, 1.0],
            rng.uniform(-0.5, 0.5, (B, 5, 1)))


def _score_inputs(seed):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-1, 1, (B, 2)) * [0.2, 0.5]
    x0[-1] *= 6.0                       # one lane past the boundary
    return x0, rng.uniform(-1, 1, (B, M, T, 1)) * 0.8


@pytest.fixture(scope="module")
def jax_refs(models):
    """JAX's predictions (vmapped over lanes and points: its entries take
    one point) and its score under each cost, each compiled once for both
    stacked models (they have the same shapes)."""
    jexp, _, j, _ = models

    def lanes(fn):
        return jax.vmap(jax.vmap(fn, in_axes=(None, 0, 0)))

    x, u = (jnp.asarray(v) for v in _lane_points(3))
    x0, seqs = (jnp.asarray(v) for v in _score_inputs(5))
    return {
        "predict": jit_once(lanes(jssm_mod.ssm_predict), j["stack"], x, u),
        "predict_jac": jit_once(lanes(jssm_mod.ssm_predict_jac), j["stack"],
                                x, u),
        **{f"score_{kind}": jit_once(
            _jax_score(jexp, JaxConfig(**KW).c_safety, cost_fn), j["stack"],
            x0, seqs) for kind, cost_fn in (
                ("tracking", jexp["cost_fn"]),
                ("exploration", jax_exploration_cost()))}}


@pytest.mark.parametrize("which", ["stack", "appended"])
def test_stacked_predict_matches_jax_vmapped(models, jax_refs, which):
    """ssm_predict and ssm_predict_jac of the stacked model at per-lane
    points (3, 5, n_s), against JAX's vmapped over lanes and points at
    1e-10; points without the lane axis in front raise."""
    _, _, j, t = models
    x, u = _lane_points(3)
    jo = jax_refs["predict"](j[which], jnp.asarray(x), jnp.asarray(u))
    to = tssm_mod.ssm_predict(t[which], _t(x), _t(u))
    jj = jax_refs["predict_jac"](j[which], jnp.asarray(x), jnp.asarray(u))
    tj = tssm_mod.ssm_predict_jac(t[which], _t(x), _t(u))
    for a, b_ in zip((*to, *tj), (*jo, *jj)):
        assert a.shape == b_.shape
        assert _rel(_np(a), b_) < 1e-10
    with pytest.raises(ValueError, match="gp_lanes"):
        tssm_mod.ssm_predict(t[which], _t(x[:2]), _t(u[:2]))


@pytest.mark.parametrize("cost_kind", ["tracking", "exploration"])
@pytest.mark.parametrize("which", ["stack", "appended"])
def test_model_batched_scores_match_jax(models, jax_refs, which, cost_kind):
    """The model-batched plain scorer (model b on lanes b M ... b M + M - 1)
    under the tracking and the exploration cost, and the stacked
    multistep_reachability, each against JAX's score_one vmapped over
    models and samples, at 1e-10: costs, violations (some samples
    feasible, some not) and the tube centres."""
    _, texp, j, t = models
    c = JaxConfig(**KW).c_safety
    x0, seqs = _score_inputs(5)
    jc, jv, jp = jax_refs[f"score_{cost_kind}"](
        j[which], jnp.asarray(x0), jnp.asarray(seqs))
    assert (np.asarray(jv) > 0).any() and (np.asarray(jv) == 0).any()
    spec = texp["env"].spec
    k_fb = texp["k_fb"]
    s_lift = torch.cat([torch.eye(2, dtype=torch.float64), k_fb])
    tc, tv = tube_score_plain(
        t[which], _t(seqs).reshape(B * M, T).T,
        _t(x0).repeat_interleave(M, dim=0).T, k_fb, texp["a"], texp["b"],
        s_lift.T @ s_lift, spec.h_mat_obs, spec.h_obs, spec.h_mat_safe,
        spec.h_safe, c, T, cost_kind,
        {"target": spec.target} if cost_kind == "tracking" else {})
    assert _rel(_np(tc).reshape(B, M), jc) < 1e-10
    assert _rel(_np(tv).reshape(B, M), jv) < 1e-10
    p, q, _ = multistep_reachability(
        t[which], _t(x0)[:, None].expand(B, M, 2), _t(seqs),
        k_fb.expand(T, 1, 2), texp["a"], texp["b"], c)
    assert _rel(_np(p), jp) < 1e-10
    viol = tube_violation(p, q, spec.h_mat_obs, spec.h_obs, spec.h_mat_safe,
                          spec.h_safe)
    assert _rel(_np(viol), jv) < 1e-10
