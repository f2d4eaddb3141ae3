"""CUDA-event and device times of the gram, gp_predict and cem_score
kernels as their paths call them, for the commit whose port comes first on
``sys.path``:

    PYTHONPATH=. python safe_exploration_tpu_torch/ops/kernels/path_times.py
    cd OTHER_CHECKOUT && PYTHONPATH=. python /path/to/this/path_times.py

so two commits compare on one card in one call (in turns: parent, change,
change, parent). f32, e = 2, on CUDA only.

  gram        ``rbf_gram_masked(*refit_inputs(gp)[0])``, the refit's call,
              at n_max 128 (the SQP path), 512 and 2048 (episodic runs (a)
              and (b)), n_max - 7 points
  gp_predict  n = 64, L = 256 (the CEM path's final passes) and 16,384
              ("pallas" wide pass), with the Jacobian: the path's call
              (``gp_predict_prepared`` on a posterior prepared once where
              the commit has it, else ``gp_predict_lanes`` on pre-masked
              arguments, as earlier commits timed it) and the call that
              starts from the model (``sqp_lanes._gp_predict_lanes`` with
              ``impl="pallas"``)
  cem_score   ``tube_score_prepared`` at the CEM path's shape (n = 64, H =
              5, L = 16,384, tracking cost), the model prepared once
  host        microseconds of host time per call of the parts of a
              wrapper's launch (the device checks, one ``torch.empty``,
              ``torch.cuda.device``, the current stream) and of a whole
              ``rbf_gram_masked`` call at n = 128 (enqueue only)

Each kernel entry has the CUDA-event ms per call (mean over back-to-back
calls) and the device ms per call by CUDA kernel (torch.profiler, 3
calls). One JSON line goes to stdout, with the card's name and power
limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch


def _time_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _device_ms(fn) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    total, count = {}, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU:
            continue
        name = e.key.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].split("<")[0].strip().split(" ")[-1]
        name = name.split("::")[-1] or e.key[:40]
        total[name] = total.get(name, 0.0) + e.self_device_time_total
        count[name] = count.get(name, 0) + e.count
    by = {k: total[k] / count[k] * max(1, round(count[k] / 3)) / 1e3
          for k in total if count[k]}
    return by


def _entry(fn, reps: int) -> dict:
    by = _device_ms(fn)
    return {"ms": _time_ms(fn, reps), "device_ms": sum(by.values()),
            "device_ms_by_kernel": by}


def _host_us(fn, reps: int = 2000) -> float:
    for _ in range(50):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def main() -> int:
    if not torch.cuda.is_available():
        print("path_times: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import safe_exploration_tpu_torch as port
    from safe_exploration_tpu_torch.models import gp as gp_mod
    from safe_exploration_tpu_torch.models import make_gp_ssm
    from safe_exploration_tpu_torch.envs import (
        linearize_discretize,
        make_pendulum,
    )
    from safe_exploration_tpu_torch.ops import kernels
    from safe_exploration_tpu_torch.ops.kernels import _common
    from safe_exploration_tpu_torch.ops.linalg import dlqr
    from safe_exploration_tpu_torch.solvers.sqp_lanes import _gp_predict_lanes

    dt, dev = torch.float32, "cuda"
    rng = np.random.default_rng(0)
    out = {"port": port.__file__, "device": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]}

    def t(v):
        return torch.tensor(v, dtype=dt, device=dev)

    for n in (128, 512, 2048):
        k = n - 7
        x = t(rng.uniform(-1.0, 1.0, (k, 3)))
        y = t(0.05 * rng.standard_normal((k, 2)))
        gp = gp_mod.gp_init(("rbf", "rbf"), x, y, n_max=n, log_noise=-4.0)
        args = gp_mod.refit_inputs(gp)[0]
        out[f"gram_n{n}"] = _entry(lambda: kernels.rbf_gram_masked(*args),
                                   {128: 200, 512: 100}.get(n, 50))
        if n == 128:
            x0 = args[0]

            def ctx():
                with torch.cuda.device(x0.device):
                    pass

            out["host_us"] = {
                "checks": _host_us(lambda: (_common.on_cuda(*args),
                                            _common.check("t", *args))),
                "empty": _host_us(lambda: torch.empty(
                    (2, n, n), dtype=dt, device=dev)),
                "device_context": _host_us(ctx),
                "stream": _host_us(lambda: _common.stream_ptr(x0)),
                "gram_call": _host_us(lambda: kernels.rbf_gram_masked(*args),
                                      500)}

    xs = t(rng.uniform(-1.0, 1.0, (57, 2)) * [0.3, 1.0])
    us = t(rng.uniform(-1.0, 1.0, (57, 1)))
    ys = t(0.02 * rng.standard_normal((57, 2)))
    ssm = make_gp_ssm(("rbf", "rbf"), xs, us, ys, n_max=64,
                      l_mu=torch.full((2,), 0.05, dtype=dt, device=dev),
                      l_sigma=torch.full((2,), 0.02, dtype=dt, device=dev),
                      log_noise=-4.0)
    gp = ssm.gp
    m = gp.mask
    raw = (gp.x, (gp.beta * m[None]).contiguous(),
           (gp.kinv * (m[None, :, None] * m[None, None, :])).contiguous(),
           torch.stack([p["log_lengthscales"] for p in gp.params]),
           torch.stack([p["log_sf"] for p in gp.params]))
    prepared = hasattr(kernels, "gp_predict_prepared")
    post = kernels.prepare_posterior(ssm) if prepared else None
    for L in (256, 16384):
        z = t(rng.uniform(-1.0, 1.0, (3, L)))
        if prepared:
            def call():
                return kernels.gp_predict_prepared(post, z, want_jac=True)
        else:
            def call():
                return kernels.gp_predict_lanes(*raw, z, want_jac=True)
        out[f"gp_predict_L{L}"] = _entry(call, 100)
        out[f"gp_predict_L{L}_from_model"] = _entry(
            lambda: _gp_predict_lanes(ssm, z, want_jac=True, impl="pallas"),
            100)

    env = make_pendulum(dtype=dt, device=dev)
    a, b = linearize_discretize(env)
    eye = torch.eye(2, dtype=dt, device=dev)
    k_fb = -dlqr(a, b, eye, torch.eye(1, dtype=dt, device=dev))[0]
    s_lift = torch.cat([eye, k_fb], 0)
    spec = env.spec
    prep = kernels.prepare_tube_score(
        ssm, k_fb, a, b, s_lift.T @ s_lift, spec.h_mat_obs, spec.h_obs,
        spec.h_mat_safe, spec.h_safe, 2.0, 5, "tracking",
        {"target": spec.target})
    u = t(0.4 * rng.standard_normal((5, 16384)))
    x0s = t(rng.uniform(-1.0, 1.0, (2, 16384)) * [[0.15], [0.4]])
    out["cem_score_L16384"] = _entry(
        lambda: kernels.tube_score_prepared(prep, u, x0s), 50)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
