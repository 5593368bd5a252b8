"""The port's samplers (vdx_torch.schedulers) against vdx's, on the CPU.

* Tables: every field of all six samplers' tables at 15, 25 and 50 steps
  (the ends of the reference grid's step counts), and at the other
  timestep spacings through a config override. Both sides build them with
  the same float64 numpy math and round once to fp32 or int32: exact.
* Trajectories: N steps of ``step`` / ``step_multistep`` per sampler, both
  sides fed the same numpy model outputs from the same start, every step's
  ``scale_model_input`` and latents compared. The same fp32 operations run
  in the same order; XLA and PyTorch may round a transcendental (sqrt,
  log, expm1) one ulp apart, so the bar is 2e-6 relative to the largest
  latent magnitude of the step (the EDM grid starts at sigma = 700).
* The registry: names, aliases, the multistep flag and the error text.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vdx.schedulers as J
import vdx_torch.schedulers as T

SAMPLERS = ("ddim", "euler", "dpm", "edm", "dpm_edm", "unipc")
STEP_COUNTS = (15, 25, 50)  # the grid's STEPS_VALUES ends and the default
REL_TOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file's tests run (the suite runs several
    workers side by side); restored afterwards for other files."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _assert_tables_equal(tt, jt, what):
    assert type(tt).__name__ == type(jt).__name__, what
    assert tt._fields == jt._fields, what
    for name in jt._fields:
        want, got = getattr(jt, name), getattr(tt, name)
        if name == "init_noise_sigma":
            assert got == want, (what, name)
            continue
        want = np.array(want)
        assert got.dtype == torch.from_numpy(want).dtype, (what, name)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{what} {name}")


def _config_overrides():
    """(sampler, vdx cfg, port cfg): the other timestep spacings."""
    from vdx.schedulers import ddim as JD, euler as JE
    from vdx_torch.schedulers import ddim as TD, euler as TE

    for spacing in ("leading", "trailing"):
        yield ("euler", JE.EulerConfig(timestep_spacing=spacing),
               TE.EulerConfig(timestep_spacing=spacing))
    for spacing in ("trailing", "linspace"):
        yield ("ddim", JD.DDIMConfig(timestep_spacing=spacing),
               TD.DDIMConfig(timestep_spacing=spacing))


def _trajectory(mod, name, n, outputs, x_start, multistep):
    """Run ``n`` steps of one sampler namespace on numpy-fed outputs;
    -> (per-step scaled inputs, per-step latents) as numpy."""
    is_jax = mod.__name__.startswith("vdx.")
    arr = jnp.asarray if is_jax else torch.from_numpy
    tables = mod.make_tables(n)
    x = arr(x_start * np.float32(tables.init_noise_sigma))
    state = mod.init_state(x) if multistep else None
    scaled, lat = [], []
    for i in range(n):
        scaled.append(np.asarray(mod.scale_model_input(x, i, tables)))
        out = arr(outputs[i])
        if multistep:
            x, state = mod.step_multistep(x, out, i, state, tables)
        else:
            x = mod.step(x, out, i, tables)
        lat.append(np.asarray(x))
    return scaled, lat


def test_sampler_tables_match_vdx():
    for name in SAMPLERS:
        for n in STEP_COUNTS:
            _assert_tables_equal(T.get_sampler(name).make_tables(n),
                                 J.get_sampler(name).make_tables(n),
                                 f"{name} n={n}")
    for name, jcfg, tcfg in _config_overrides():
        for n in STEP_COUNTS:
            _assert_tables_equal(T.make_tables_for(name, n, tcfg),
                                 J.make_tables_for(name, n, jcfg),
                                 f"{name} {tcfg} n={n}")


def test_sampler_trajectories_match_vdx():
    rng = np.random.default_rng(0)
    shape = (1, 2, 4, 6, 4)
    n = 12
    x_start = rng.standard_normal(shape).astype(np.float32)
    outputs = [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]
    for name in SAMPLERS:
        multistep = J.is_multistep(name)
        want = _trajectory(J.get_sampler(name), name, n, outputs, x_start, multistep)
        got = _trajectory(T.get_sampler(name), name, n, outputs, x_start, multistep)
        for kind, ws, gs in zip(("scale_model_input", "latents"), want, got):
            for i, (w, g) in enumerate(zip(ws, gs)):
                tol = REL_TOL * max(1.0, float(np.abs(w).max()))
                np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                           err_msg=f"{name} {kind} step {i}")
    # the stateless first-order fallbacks of the multistep samplers
    tables_j, tables_t = J.dpm.make_tables(n), T.dpm.make_tables(n)
    for name in ("dpm", "unipc"):
        w = np.asarray(J.get_sampler(name).step(jnp.asarray(x_start),
                                                jnp.asarray(outputs[3]), 3, tables_j))
        g = T.get_sampler(name).step(torch.from_numpy(x_start),
                                     torch.from_numpy(outputs[3]), 3, tables_t)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=REL_TOL * 4)


def test_sampler_registry_matches_vdx():
    names = sorted(J._SAMPLERS)
    assert sorted(T._SAMPLERS) == names
    for name in names + [n.upper() for n in names]:
        assert T.get_sampler(name).__name__.split(".")[-1] == \
            J.get_sampler(name).__name__.split(".")[-1]
        assert T.is_multistep(name) == J.is_multistep(name)
    with pytest.raises(ValueError) as jerr:
        J.get_sampler("heun")
    with pytest.raises(ValueError) as terr:
        T.get_sampler("heun")
    assert str(terr.value) == str(jerr.value)
    for name in SAMPLERS:  # the port's dataclass configs mirror vdx's fields
        jmod, tmod = J.get_sampler(name), T.get_sampler(name)
        jcfg = [v for v in vars(jmod).values() if dataclasses.is_dataclass(v)
                and v.__module__ == jmod.__name__]
        for cls in jcfg:
            tcls = getattr(tmod, cls.__name__)
            assert [f.name for f in dataclasses.fields(tcls)] == \
                [f.name for f in dataclasses.fields(cls)], cls.__name__
    assert T.make_tables_for("euler", 3, device="cpu").sigmas.device.type == "cpu"
