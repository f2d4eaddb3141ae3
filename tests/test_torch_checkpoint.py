"""PyTorch port: checkpoint / resume (``runtime/checkpoint.py`` and the
runners' ``ckpt_dir`` / ``resume``), on the CPU.

  * a state holding every model family (exact, sparse, MC-dropout plain and
    concrete, stacked, per-lane) and a generator's state round-trips
    exactly, readable by ``torch.load(weights_only=True)``;
    ``latest_checkpoint`` picks ``ckpt_10`` over ``ckpt_2``;
  * a resume is refused without a checkpoint directory or against a
    checkpoint of another configuration, warns where there is none, and a
    fresh run removes the checkpoints an earlier one left;
  * a run interrupted after episode 0 and resumed to 2 episodes equals the
    uninterrupted run bit for bit (``torch.equal``: the final model and
    every series but the wall times ``episode_time_s``), as the JAX
    package's own test asks of it: the fleet on both backends, and
    ``--out`` / ``--resume`` through the CLI (the episodic runner's, with a
    GP and with an MC-dropout network: tests/test_torch_mcdropout_episode.py,
    so that each file's test count, by which pytest-xdist hands files out,
    places it well in the tier-1 run's schedule).

Tiny sizes, f64.
"""

import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu_torch.models.gp_lanes import (  # noqa: E402
    lane_stack_ssm,
)
from safe_exploration_tpu_torch.runtime import batch as tbatch  # noqa: E402
from safe_exploration_tpu_torch.runtime import checkpoint as tck  # noqa: E402
from safe_exploration_tpu_torch.runtime.config import (  # noqa: E402
    CONFIGS,
    build_experiment,
)
from safe_exploration_tpu_torch.runtime.episode import first_model  # noqa: E402
from safe_exploration_tpu_torch.runtime.main import (  # noqa: E402
    _apply_overrides,
    main,
    run_experiment,
)
from test_torch_bridge import one_torch_thread  # noqa: E402,F401

F64 = torch.float64
SMALL = ["n_max=32", "n_init_samples=10", "hyp_iters=3", "cem_samples=8",
         "cem_elites=2", "cem_iterations=1", "mc_hidden=8,8",
         "mc_samples=2"]
EPISODIC = {
    "gp": ("pendulum_episode", []),
    "mc_dropout": ("pendulum_episode_mcdropout", []),
    "mc_dropout_concrete": ("pendulum_episode_concrete", []),
}
FLEET = {
    "lanes": ("pendulum_batch_sqp", ["batch_lanes=2", "sqp_outer=1",
                                     "sqp_inner=1", "n_safe=2"]),
    "stacked": ("pendulum_batch", ["batch_lanes=2", "n_safe=2"]),
}


def _tensors(obj, prefix=""):
    """Every tensor in a model / state tree, by its path."""
    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    if dataclasses.is_dataclass(obj):
        obj = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    out = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.update(_tensors(v, f"{prefix}.{k}"))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            out.update(_tensors(v, f"{prefix}[{i}]"))
    return out


def _assert_same(a, b):
    """Same structure, plain values equal, tensors equal bit for bit."""
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), k
    if dataclasses.is_dataclass(a):
        assert type(a) is type(b)
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if not isinstance(va, (torch.Tensor, tuple, list, dict)) and \
                    not dataclasses.is_dataclass(va):
                assert va == vb, f.name


def _cfg(name, sets):
    return _apply_overrides(CONFIGS[name], SMALL + sets)


def _model(family):
    name, sets = EPISODIC.get(family, ("pendulum_episode_sparse",
                                       ["n_inducing=8"]))
    cfg = _cfg(name, ["n_ep=1", "n_steps=1"] + sets)
    exp = build_experiment(cfg, dtype=F64, device="cpu")
    spec = exp["env"].spec
    draws = tbatch.batch_draws(
        torch.Generator().manual_seed(0), spec, batch=1, n_ep=0, n_steps=0,
        n_init=cfg.n_init_samples, n_region=8, dtype=F64)
    if exp["ssm_draw_shapes"]:
        draws.update({k: (torch.randn if kind == "normal" else torch.rand)(
            shape, dtype=F64) for k, (kind, shape)
            in exp["ssm_draw_shapes"].items()})
    return first_model(exp["env"], exp["a"], exp["b"], exp["k_fb"], draws,
                       exp["make_ssm"], n_init=cfg.n_init_samples,
                       hyp_iters=1, calibrate=False)


def test_checkpoint_round_trip_is_exact(tmp_path):
    gp = _model("gp")
    state = {
        "models": [gp, _model("sparse_gp"), _model("mc_dropout"),
                   _model("mc_dropout_concrete"), tbatch.stack_ssm(gp, 3),
                   lane_stack_ssm(gp, 3)],
        "episode": 4, "series": {"violations": [0, 1],
                                 "feasibility_rate": [0.5, 1.0]},
        "generator": torch.Generator().manual_seed(7).get_state(),
        "label": "run", "none": None,
    }
    path = tck.save_checkpoint(str(tmp_path / "a" / "ckpt_4.pt"), state)
    back = tck.load_checkpoint(path, map_location="cpu")
    for a, b in zip(state["models"], back["models"]):
        _assert_same(a, b)
    assert {k: v for k, v in back.items() if k not in ("models",
                                                       "generator")} == {
        k: v for k, v in state.items() if k not in ("models", "generator")}
    assert torch.equal(back["generator"], state["generator"])
    raw = torch.load(path, weights_only=True)          # no pickled classes
    assert raw["models"][2]["__family__"] == "McDropoutSSM"
    with pytest.raises(NotImplementedError, match="item 13"):
        tck.save_checkpoint(str(tmp_path / "b"), state, backend="orbax")
    with pytest.raises(NotImplementedError, match="item 13"):
        tck.load_checkpoint(str(tmp_path / "a"))


def test_latest_checkpoint_picks_the_highest_step(tmp_path):
    assert tck.latest_checkpoint(str(tmp_path / "missing")) is None
    for name in ("ckpt_2.pt", "ckpt_10.pt", "ckpt_x.pt", "other_99.pt",
                 "ckpt_11.pkl"):
        (tmp_path / name).write_bytes(b"")
    assert tck.latest_checkpoint(str(tmp_path)) == str(tmp_path /
                                                       "ckpt_10.pt")
    assert tck.checkpoint_path(str(tmp_path), 3) == str(tmp_path /
                                                        "ckpt_3.pt")


def test_resume_guards(tmp_path):
    """``restore``: a resume without a directory, or from a checkpoint
    whose configuration differs (``n_ep`` aside), raises; an empty
    directory warns and starts afresh; a fresh run removes an earlier
    run's checkpoints. The CLI and ``run_experiment`` refuse a resume
    without ``--out`` / ``out_dir``."""
    d = str(tmp_path / "run")
    with pytest.raises(ValueError, match="directory"):
        tck.restore(None, True)
    with pytest.warns(UserWarning, match="no checkpoint"):
        assert tck.restore(d, True, {"seed": 0}) is None
    for ep in (0, 5):
        tck.save_checkpoint(tck.checkpoint_path(d, ep),
                            {"episode": ep, "config": {"seed": 0, "n_ep": 6}})
    assert tck.restore(d, True, {"seed": 0, "n_ep": 9})["episode"] == 5
    with pytest.raises(ValueError, match="another configuration"):
        tck.restore(d, True, {"seed": 1, "n_ep": 6})
    assert tck.restore(d, False, {"seed": 0}) is None
    assert os.listdir(d) == []
    with pytest.raises(SystemExit):
        main(["--config", "pendulum_episode", "--device", "cpu",
              "--resume"])
    with pytest.raises(ValueError, match="out_dir"):
        run_experiment(CONFIGS["pendulum_episode"], device="cpu",
                       resume=True)


def _same_series(a, b, n_ep):
    assert a.keys() == b.keys()
    for k in a:
        assert len(a[k]) == len(b[k]) == n_ep, k
        if k != "episode_time_s":
            assert a[k] == b[k], k


@pytest.mark.parametrize("backend", list(FLEET))
def test_fleet_resume_is_bit_exact(tmp_path, backend):
    """run_batched_learning, n_ep 1 then resumed to 2, against the
    uninterrupted run; each run's draws from one seed (episode 0's the
    same whatever n_ep)."""
    name, sets = FLEET[backend]
    cfg = _cfg(name, ["n_steps=2"] + sets)
    exp = build_experiment(cfg, dtype=F64, device="cpu")
    spec = exp["env"].spec

    def draws(n_ep):
        return tbatch.batch_draws(
            torch.Generator().manual_seed(3), spec, batch=cfg.batch_lanes,
            n_ep=n_ep, n_steps=cfg.n_steps, n_init=cfg.n_init_samples,
            n_region=16, dtype=F64,
            plan_shape=None if backend == "lanes"
            else exp["batch_noise_shape"])

    d1, d2 = draws(1), draws(2)
    for k in d1:
        assert torch.equal(d1[k][:1] if k in ("reset", "step", "plan")
                           else d1[k], d2[k][:1] if k in ("reset", "step",
                                                          "plan") else d2[k])
    ssm = first_model(exp["env"], exp["a"], exp["b"], exp["k_fb"], d2,
                      exp["make_ssm"], n_init=cfg.n_init_samples,
                      hyp_iters=cfg.hyp_iters)

    def run(n_ep, d, ckpt_dir, resume=False):
        return tbatch.run_batched_learning(
            exp["env"], exp, ssm, cfg.batch_lanes, n_ep, cfg.n_steps,
            hyp_iters=cfg.hyp_iters, backend=backend, draws=d,
            ckpt_dir=str(ckpt_dir), resume=resume)

    full = run(2, d2, tmp_path / "full")
    run(1, d1, tmp_path / "part")
    resumed = run(2, d2, tmp_path / "part", resume=True)
    _same_series(full["series"], resumed["series"], 2)
    _assert_same(full["model"], resumed["model"])


@pytest.mark.parametrize("name,sets", [
    ("pendulum_episode_concrete", ["n_steps=2"]),
    ("pendulum_batch_sqp", ["n_steps=2"] + FLEET["lanes"][1])])
def test_cli_out_and_resume(tmp_path, capsys, name, sets):
    """``--out`` writes ``<out>/<config>.ckpt/ckpt_{ep}.pt`` after every
    episode; a 2-episode run cut after episode 0 (its ckpt_1 removed)
    and continued with ``--resume`` prints the uninterrupted run's
    series (the batch task checkpoints its n_ep > 1 runs, as the JAX
    CLI's)."""
    base = ["--config", name, "--device", "cpu", "--x64", "--set",
            *SMALL, *sets, "n_ep=2"]

    def series(out, *extra):
        assert main(base + ["--out", str(out), *extra]) == 0
        return json.loads(capsys.readouterr().out)["series"]

    full = series(tmp_path / "full")
    series(tmp_path / "part")
    ckpts = tmp_path / "part" / f"{name}.ckpt"
    assert sorted(os.listdir(ckpts)) == ["ckpt_0.pt", "ckpt_1.pt"]
    os.remove(ckpts / "ckpt_1.pt")
    resumed = series(tmp_path / "part", "--resume")
    assert sorted(os.listdir(ckpts)) == ["ckpt_0.pt", "ckpt_1.pt"]
    for k in full:
        if k not in ("episode_time_s", "steps_per_sec"):
            assert full[k] == resumed[k], k
