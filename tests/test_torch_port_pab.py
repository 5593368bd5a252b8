"""The port's Pyramid Attention Broadcast against vdx's, on the CPU (fp32,
tiny configs).

vdx compiles one PAB program here (at XLA optimisation level 0, as
tests/test_torch_port_requests.py): DDIM, 6 steps, spatial / temporal /
cross intervals 2 / 3 / 4, warm-up 1, cool-down 1, 4 frames at 64x64.
The port runs the same request from vdx's own initial noise (its
``initial_noise`` replaced by ``jax.random.normal`` of the program's key),
so the two differ only by the fp32 rounding of the tiny UNet's
arithmetic: the bar is the pipeline bar of tests/test_torch_port_requests
.py, 1e-3 on the latents per step, 6e-3 after 6 steps (measured: 1.9e-4
on latents up to 37). The plain loop lands more than 1.0 away, so the bar
sees the broadcast.

The port's own checks: dispatch segments equal the monolithic PAB call
bit for bit; the refresh steps of every attention type, read from the
attention modules' computations, equal an enumeration of vdx's rule; an
interval of 1 computes every step and keeps no cache; vdx's ValueErrors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_requests import compile_o0, load_from_vdx, tiny_port, vdx_params
from vdx.core.dtypes import FP32_POLICY as JP
from vdx.models.clip_text import CLIPTextConfig as JCC
from vdx.models.unet_motion import UNetMotionConfig as JUC
from vdx.models.vae import VAEConfig as JVC
from vdx.pipelines import AnimateDiffPipeline as JPipe
from vdx.pipelines import ContextConfig as JContext
from vdx.pipelines import PABConfig as JPAB
from vdx.pipelines import SkipConfig as JSkip
from vdx_torch.nn.attention import Attention
from vdx_torch.pipelines import ContextConfig, PABConfig, SkipConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SHAPE = (1, 4, 8, 8, 4)
N = 6
STEP_ATOL = 1e-3
INTERVALS = dict(spatial_interval=2, temporal_interval=3, cross_interval=4,
                 warmup_steps=1, cooldown_steps=1)
CALL = dict(num_frames=4, height=64, width=64, num_inference_steps=N, seed=3,
            output_type="latent")


@pytest.fixture(scope="module")
def pab_run():
    seed_pipe = tiny_port()
    seed_pipe.init_params(0)
    params = vdx_params(seed_pipe)
    jpipe = JPipe(unet_config=JUC.tiny(), vae_config=JVC.tiny(),
                  text_config=JCC.tiny(), policy=JP, scheduler="ddim",
                  params=params, pab=JPAB(**INTERVALS))
    cond = jpipe.encode_prompt("a fox", "")
    prog = jpipe._get_program(scheduler="ddim", guidance=True,
                              latent_shape=SHAPE, num_steps=N, chunk=None)
    key = jpipe._seed_keys(CALL["seed"], 1)
    args = (jpipe.params, key, cond, jnp.float32(7.5), jpipe._get_tables("ddim", N))
    latents = np.asarray(compile_o0(prog, args)(*args))
    noise = np.asarray(jax.random.normal(key, SHAPE, jnp.float32))
    return dict(jpipe=jpipe, params=params, latents=latents, noise=noise)


def _from_noise(pipe, noise):
    pipe.initial_noise = lambda shape, seed: torch.from_numpy(noise.copy())
    return pipe


def test_pab_program_matches_vdx(pab_run):
    tp = _from_noise(load_from_vdx(tiny_port(pab=PABConfig(**INTERVALS)),
                                   pab_run["params"]), pab_run["noise"])
    got = tp("a fox", **CALL).latents.numpy()
    want = pab_run["latents"]
    assert got.shape == want.shape == SHAPE
    np.testing.assert_allclose(got, want, atol=N * STEP_ATOL)
    plain = _from_noise(load_from_vdx(tiny_port(), pab_run["params"]),
                        pab_run["noise"])
    assert np.abs(plain("a fox", **CALL).latents.numpy() - want).max() > 1.0


def _site_type(key: str) -> str:
    if ".motion_modules." in key:
        return "temporal"
    return "spatial" if key.endswith("attn1") else "cross"


def _enumerate_refreshes(n, interval, warmup, cooldown) -> set:
    """vdx's rule written out step by step: the warm-up and cool-down
    steps, and every multiple of the interval."""
    steps = set(range(warmup)) | set(range(n - cooldown, n))
    return steps | set(range(0, n, interval))


def test_pab_segments_schedule_and_cache(pab_run):
    tp = load_from_vdx(tiny_port(pab=PABConfig(**INTERVALS)), pab_run["params"])
    whole = tp("a fox", **CALL)
    assert whole.n_evals is None
    for k in (1, 2, 4):
        assert torch.equal(tp("a fox", dispatch_steps=k, **CALL).latents,
                           whole.latents), k
    # the steps at which each attention type computed, per module
    step, seen = [0], {}
    compute = Attention._compute

    def counted(self, x, context, rope):
        seen.setdefault(self.pab_key, []).append(step[0])
        return compute(self, x, context, rope)

    hook = tp.unet.register_forward_hook(
        lambda m, a, o: step.__setitem__(0, step[0] + 1))
    progress = []
    tp.progress_callback = lambda i, n: progress.append(i)
    Attention._compute = counted
    try:
        tp("a fox", **CALL)
    finally:
        Attention._compute = compute
        hook.remove()
    assert not progress  # vdx's PAB program reports no progress
    keys = [n for n, m in tp.unet.named_modules() if isinstance(m, Attention)]
    assert sorted(seen) == sorted(keys)
    want = {t: _enumerate_refreshes(N, INTERVALS[f"{t}_interval"], 1, 1)
            for t in ("spatial", "cross", "temporal")}
    assert want == {"spatial": {0, 2, 4, 5}, "cross": {0, 4, 5},
                    "temporal": {0, 3, 5}}
    for key, steps in seen.items():
        assert steps == sorted(want[_site_type(key)]), (key, steps)
    # an interval of 1: every step computes and no cache is kept; all
    # intervals 1 is the plain loop, bit for bit
    model_in = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2,) + SHAPE[1:]).astype(np.float32))
    ctx = tp.encode_prompt("a fox")
    with torch.inference_mode():
        _, cache = tp.unet(model_in, torch.tensor([500, 500]), ctx,
                           pab_refresh={"spatial": None, "cross": True,
                                        "temporal": True})
    assert cache and not any(_site_type(k) == "spatial" for k in cache)
    assert {_site_type(k) for k in cache} == {"cross", "temporal"}
    exact = load_from_vdx(tiny_port(pab=PABConfig(1, 1, 1, 1)), pab_run["params"])
    plain = load_from_vdx(tiny_port(), pab_run["params"])
    assert torch.equal(exact("a fox", **CALL).latents, plain("a fox", **CALL).latents)


def test_pab_rejects_what_vdx_rejects(pab_run):
    jpipe = pab_run["jpipe"]
    tp = load_from_vdx(tiny_port(pab=PABConfig(**INTERVALS)), pab_run["params"])
    with pytest.raises(ValueError, match="ddim/euler/edm"):
        jpipe._get_program(scheduler="dpm", guidance=True, latent_shape=SHAPE,
                           num_steps=N, chunk=None)
    with pytest.raises(ValueError, match="ddim/euler/edm"):
        tp("a fox", scheduler="dpm", **CALL)
    clip = np.zeros((4, 64, 64, 3), np.uint8)
    for pipe in (jpipe, tp):
        with pytest.raises(ValueError, match="video2video does not compose with PAB"):
            pipe("a fox", video=clip, num_inference_steps=N)
    for make, pab, skip, ctx in ((JPipe, JPAB, JSkip, JContext),
                                 (tiny_port, PABConfig, SkipConfig, ContextConfig)):
        with pytest.raises(ValueError, match="pick one"):
            make(pab=pab(), skip=skip())
        with pytest.raises(ValueError, match="incompatible"):
            make(pab=pab(), context=ctx())
    # PAB turns variable_steps off: the padded tables are never built
    var = load_from_vdx(tiny_port(pab=PABConfig(**INTERVALS), variable_steps=8),
                        pab_run["params"])
    assert torch.equal(var("a fox", **CALL).latents, tp("a fox", **CALL).latents)
    assert all(key[2] == 0 for key in var._tables)
