"""vdx_torch.parallel.train against vdx.parallel.train on the CPU (fp32
tiny UNetMotion unless a case says bf16), the keyed draws and optax's
pieces, and the kernels' autograd Functions.

1. Three training steps through both packages from the same weights,
   batch and keys, on the tiny config cut to two levels (32 and 64
   channels, attention at the first: a third of vdx's compile), for each
   case: (a) the plain step under
   make_optimizer(warmup_steps=2, total_steps=6) with grad stats, (b)
   remat + grad_accum=2 + EMA 0.9, which must also equal the port's own
   plain step (vdx's tests/test_training.py pins the same), (c) bf16
   weights and compute with grad_accum=2, every optimizer moment staying
   bf16, (d) the LoRA step, gradients reaching the adapter only. vdx's
   step is jitted at XLA optimisation level 0 (about 30 s a case). Bars:
   fp32 loss rel 1e-5 at each step; fp32 parameters within 1e-5 (measured
   8.4e-7 against vdx after three steps, 5.0e-6 between the port's
   accumulated and plain steps) where vdx's first-step gradient reaches
   1e-6, and within 2 * lr * steps where it does not: those are 15 of
   390 tensors, biases feeding a GroupNorm that cancels them up to
   rounding, so their gradients are fp32 noise (~1e-9) and AdamW's
   g / (|g| + eps) takes either sign (measured up to 0.23 lr). bf16: loss
   rel 2e-2 (bf16 rounds at other points in XLA and PyTorch) and
   parameters within 2 * lr * steps plus one bf16 ulp (an Adam step is
   +-lr wherever the two gradients' signs agree).
2. rng.randint and bf16 rng.key_normal against jax.random bit for bit;
   the schedules against optax over 12 counts (fp32 rounding: rel 1e-6);
   the clip against optax.clip_by_global_norm on and below the limit.
3. GroupNormFn and the flash attention Functions on the CPU with their
   forward bound to the plain version: the backward against vdx's
   ``_gn_pallas_bwd`` (its XLA VJP) and jax.vjp of
   ``vdx.ops.attention._xla_attention`` within 2e-5, sliced into several
   (batch, head) pieces; the no-detach guard at every launch site.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_models import (_compile_o0, _jax_params,
                                    _load_through_port_converter)
from vdx.core import convert as VC
from vdx.core import lora as JL
from vdx.core.dtypes import FP32_POLICY as JP
from vdx.core.dtypes import Policy as JPolicy
from vdx.models.unet_motion import UNetMotion as JU
from vdx.models.unet_motion import UNetMotionConfig as JUC
from vdx.parallel import train as JT
from vdx_torch.core import lora as TL
from vdx_torch.core import rng
from vdx_torch.core.convert import params_from_jax
from vdx_torch.core.dtypes import BF16_POLICY as TBF
from vdx_torch.core.dtypes import FP32_POLICY as TP
from vdx_torch.models.unet_motion import UNetMotion as TU
from vdx_torch.models.unet_motion import UNetMotionConfig as TUC
from vdx_torch.parallel import train as TT

STEPS = 3
KEYS = (42, 43, 44)
LR = 1e-3
# the tiny config cut to two levels, in both packages
JC = dataclasses.replace(JUC.tiny(), block_out_channels=(32, 64),
                         down_block_has_attn=(True, False))
TC = dataclasses.replace(TUC.tiny(), block_out_channels=(32, 64),
                         down_block_has_attn=(True, False))
REAL_GRAD = 1e-6  # vdx's first-step max |g| above which a tensor is not noise


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file's tests run (the suite runs several
    workers side by side); restored afterwards for other files."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port_state(jparams):
    """vdx's UNet tree -> the port's state_dict (numpy)."""
    flat = {k: np.asarray(v, np.float32)
            for k, v in VC.flatten_params(jparams).items()}
    return {k: v.numpy() for k, v in params_from_jax(flat, "unet", JC).items()}


def _batch(dtype):
    r = np.random.default_rng(0)
    lat = (r.standard_normal((2, 2, 8, 8, 4)) * 0.5).astype(np.float32)
    ctx = r.standard_normal((2, 7, 64)).astype(np.float32)
    return {"latents": lat.astype(dtype), "context": ctx.astype(dtype)}


def _run_vdx(step, state, batch, extra=()):
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    key0 = jax.random.PRNGKey(KEYS[0])
    run = _compile_o0(step, state, batch, key0, *extra)
    losses, metrics = [], None
    for s in KEYS:
        state, m = run(state, batch, jax.random.PRNGKey(s), *extra)
        losses.append(float(m["loss"]))
        metrics = metrics or m
    return state, losses, metrics


def _run_port(step, state, batch):
    batch = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)
        for k, v in batch.items()}
    losses, metrics = [], None
    for s in KEYS:
        state, m = step(state, batch, rng.prng_key(s))
        losses.append(float(m["loss"]))
        metrics = metrics or m
    return state, losses, metrics


def _assert_close_params(got: dict, want: dict, atol, what: str):
    """Every tensor of ``want`` within its bar (``atol``: a number, or a
    function of the name)."""
    bar = atol if callable(atol) else (lambda name: atol)
    over = {k: d for k in want
            if (d := float(np.abs(got[k].float().numpy() - want[k]).max()))
            > bar(k)}
    assert not over, f"{what}: {len(over)} tensors over their bar: " \
        f"{sorted(over.items(), key=lambda kv: -kv[1])[:5]}"


def test_train_steps_match_vdx():
    tm = TU(TC, TP)
    rules = VC.unet_motion_rules(JC)
    jparams = _jax_params(tm, rules, 3)
    jm = JU(JC, policy=JP)
    batch = _batch(np.float32)
    to_hf = {p: hf for p, (hf, _) in rules.items()}

    def port_model(policy=TP):
        m = TU(TC, policy)
        _load_through_port_converter(m, jparams, "unet", JC)
        return m.to(policy.param_dtype)

    # (a) plain, warmup + cosine, grad stats
    jopt = JT.make_optimizer(LR, warmup_steps=2, total_steps=6)
    jstate, _ = JT.init_train_state(jm, jparams, optimizer=jopt)
    js, jl, jm_ = _run_vdx(JT.make_train_step(jm, jopt, with_grad_stats=True),
                           jstate, batch)
    m = port_model()
    topt = TT.make_optimizer(LR, warmup_steps=2, total_steps=6)
    tstate, _ = TT.init_train_state(m, optimizer=topt)
    ts, tl, tm_ = _run_port(TT.make_train_step(m, topt, with_grad_stats=True),
                            tstate, batch)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jabs = {to_hf["/".join(str(getattr(k, "key", k)) for k in path)
                  .removeprefix("params/")]: float(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                jm_["grad_absmax"])[0]}
    tabs = {n: float(v) for n, v in tm_["grad_absmax"].items()}
    assert set(tabs) == set(jabs) and all(v > 0 for v in tabs.values())
    real = sorted(n for n, v in jabs.items() if v > REAL_GRAD)
    np.testing.assert_allclose([tabs[n] for n in real], [jabs[n] for n in real],
                               rtol=1e-4)

    def fp32_atol(name):
        return 1e-5 if name in real else 2 * LR * STEPS

    _assert_close_params(m.state_dict(), _port_state(js.params), fp32_atol,
                         "plain")
    plain_port = {k: v.float().numpy() for k, v in m.state_dict().items()}

    # (b) remat + grad_accum 2 + EMA 0.9: vdx's, and the port's plain step
    jstate, _ = JT.init_train_state(jm, jparams, optimizer=jopt, ema=True)
    js, jl2, _ = _run_vdx(JT.make_train_step(jm, jopt, remat=True,
                                             grad_accum=2, ema_decay=0.9),
                          jstate, batch)
    m = port_model()
    tstate, _ = TT.init_train_state(m, optimizer=topt, ema=True)
    ts, tl2, _ = _run_port(TT.make_train_step(m, topt, remat=True,
                                              grad_accum=2, ema_decay=0.9),
                           tstate, batch)
    np.testing.assert_allclose(tl2, jl2, rtol=1e-5)
    np.testing.assert_allclose(tl2, tl, rtol=1e-5)
    _assert_close_params(m.state_dict(), _port_state(js.params), fp32_atol,
                         "remat+accum+ema")
    _assert_close_params(m.state_dict(), plain_port, fp32_atol,
                         "remat+accum+ema against the port's plain step")
    _assert_close_params(ts.ema_params, _port_state(js.ema_params), fp32_atol,
                         "ema")
    assert ts.step == STEPS

    # (c) bf16 weights and compute, grad_accum 2: dtypes kept
    jbf = JPolicy(param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16)
    jmb = JU(JC, policy=jbf)
    jpb = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jparams)
    bbatch = _batch(jnp.bfloat16)
    jopt_c = JT.make_optimizer(LR)
    jstate, _ = JT.init_train_state(jmb, jpb, optimizer=jopt_c)
    js, jl3, _ = _run_vdx(JT.make_train_step(jmb, jopt_c, grad_accum=2),
                          jstate, bbatch)
    m = port_model(TBF)
    topt_c = TT.make_optimizer(LR)
    tstate, _ = TT.init_train_state(m, optimizer=topt_c)
    ts, tl3, _ = _run_port(TT.make_train_step(m, topt_c, grad_accum=2),
                           tstate, bbatch)
    np.testing.assert_allclose(tl3, jl3, rtol=2e-2)
    assert all(p.dtype == torch.bfloat16 for p in m.parameters())
    assert all(t.dtype == torch.bfloat16 for mom in ("mu", "nu")
               for t in ts.opt_state[mom].values())
    want = _port_state(js.params)
    worst = max(float((np.abs(m.state_dict()[k].float().numpy() - w)
                       - 2.0 ** -8 * np.abs(w)).max()) for k, w in want.items())
    assert worst <= 2 * LR * STEPS, f"bf16: {worst:.3e} beyond one bf16 ulp"

    # (d) LoRA: only the adapter moves
    jad = JL.init_lora(jparams, rank=4, seed=0)
    jstate, _ = JT.init_train_state(jm, jad, optimizer=jopt_c)
    js, jl4, _ = _run_vdx(JT.make_lora_train_step(jm, jopt_c), jstate, batch,
                          (jparams,))
    m = port_model()
    before = {k: v.clone() for k, v in m.state_dict().items()}
    flat = TT.flatten_adapter(TL.init_lora(m.state_dict(), rank=4, seed=0,
                                           rules=rules))
    tstate, _ = TT.init_train_state(m, flat, optimizer=topt_c)
    ts, tl4, _ = _run_port(TT.make_lora_train_step(m, topt_c), tstate, batch)
    np.testing.assert_allclose(tl4, jl4, rtol=1e-5)
    assert all(torch.equal(v, before[k]) for k, v in m.state_dict().items())
    got = TT.unflatten_adapter(ts.params)
    for p, site in js.params.items():
        for w in ("a", "b"):
            _assert_close_params({"x": got[to_hf[p]][w].detach()},
                                 {"x": np.asarray(site[w])}, 5e-6,
                                 f"lora {p} {w}")
    assert any(got[to_hf[p]]["b"].abs().max() > 0 for p in js.params)


def test_draws_schedules_and_clip_match_jax_and_optax():
    for seed in (0, 7, 2 ** 31 + 5):
        key = jax.random.PRNGKey(seed)
        for shape, lo, hi in (((2,), 0, 1000), ((5, 3), -7, 2 ** 31 - 1),
                              ((17,), 3, 3), ((1000,), 0, 1000)):
            np.testing.assert_array_equal(
                rng.randint(rng.prng_key(seed), shape, lo, hi).numpy(),
                np.asarray(jax.random.randint(key, shape, lo, hi)))
        for shape in ((3, 5, 11), (2, 16, 8, 8, 4)):
            want = np.asarray(jax.random.normal(key, shape, jnp.bfloat16)
                              .astype(jnp.float32))
            got = rng.key_normal(rng.prng_key(seed), shape,
                                 dtype=torch.bfloat16)
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(), want)

    counts = range(12)
    for ours, theirs in (
            (TT.constant_schedule(3e-4), lambda c: 3e-4),
            (TT.linear_schedule(0.0, 1e-4, 4),
             optax.linear_schedule(0.0, 1e-4, 4)),
            (TT.warmup_cosine_decay_schedule(0.0, 1e-4, 3, 10),
             optax.warmup_cosine_decay_schedule(0.0, 1e-4, 3, 10))):
        np.testing.assert_allclose([ours(c) for c in counts],
                                   [float(theirs(c)) for c in counts],
                                   rtol=1e-6, atol=1e-12)
    # make_optimizer's schedule is the one optax's update uses at count n
    assert TT.make_optimizer(1e-4, warmup_steps=3).schedule(0) == 0.0

    r = np.random.default_rng(1)
    grads = {"a": r.standard_normal((4, 5)).astype(np.float32),
             "b": r.standard_normal((7,)).astype(np.float32)}
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                             for g in grads.values())))
    for max_norm in (norm / 2, norm * 2):
        clip = optax.clip_by_global_norm(max_norm)
        want, _ = clip.update({k: jnp.asarray(v) for k, v in grads.items()},
                              clip.init(None))
        got = TT.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in grads.items()}, max_norm)
        for k in grads:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)


def test_kernel_functions_backward_and_guard(monkeypatch):
    import vdx_torch.kernels.flash_attention as KA
    import vdx_torch.kernels.groupnorm as KG
    import vdx_torch.ops.groupnorm as G
    from vdx.ops.attention import _xla_attention
    from vdx.ops.groupnorm import _gn_pallas_bwd

    r = np.random.default_rng(2)
    # GroupNormFn, its forward bound to the plain version
    monkeypatch.setattr(
        G, "group_norm_silu_cuda",
        lambda x, ng, s, b, eps, silu: (G._group_norm_silu_plain if silu
                                        else G._group_norm_plain)(x, ng, s, b, eps))
    x = r.standard_normal((2, 3, 4, 4, 64)).astype(np.float32) + 0.5
    sc = (1 + 0.1 * r.standard_normal(64)).astype(np.float32)
    bi = (0.1 * r.standard_normal(64)).astype(np.float32)
    g = r.standard_normal(x.shape).astype(np.float32)
    for silu in (False, True):
        ins = [torch.from_numpy(a).requires_grad_() for a in (x, sc, bi)]
        before = G.GroupNormFn.backward_calls
        y = G.GroupNormFn.apply(*ins, 32, 1e-6, silu)
        got = torch.autograd.grad(y, ins, torch.from_numpy(g))
        assert G.GroupNormFn.backward_calls == before + 1
        want = _gn_pallas_bwd(32, 1e-6, silu, tuple(map(jnp.asarray, (x, sc, bi))),
                              jnp.asarray(g))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5,
                                       rtol=2e-5)

    # K1 (staticmax) and K4, forward bound to the plain version, backward
    # in slices of one head (VJP_SLICE_SCORES at one head's scores)
    B, S, H, D = 2, 96, 3, 16
    q, k, v = (r.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    g = r.standard_normal((B, S, H, D)).astype(np.float32)
    scale = D ** -0.5
    _, vjp = jax.vjp(lambda a, b, c: _xla_attention(a, b, c, scale, None),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    monkeypatch.setattr(KA, "VJP_SLICE_SCORES", S * S)
    monkeypatch.setattr(KA, "_flash_dt_cuda",
                        lambda a, b, c, sc_, e, bk: KA.flash_attention_dt_plain(
                            a, b, c, scale=sc_, exp_impl=e, block_k=bk))
    monkeypatch.setattr(KA, "_flash_cuda",
                        lambda a, b, c, sc_: KA.flash_attention_plain(a, b, c,
                                                                      scale=sc_))
    for fn, args in ((KA.FlashAttentionDtFn, (scale, "staticmax", 1024)),
                     (KA.FlashAttentionFn, (scale,))):
        ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        before = fn.backward_calls
        out = fn.apply(*ins, *args)
        got = torch.autograd.grad(out, ins, torch.from_numpy(g))
        assert fn.backward_calls == before + 1
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5,
                                       rtol=2e-5)

    # the guard: every ctypes launch site refuses inputs that require grad
    # under grad (meta tensors: past the CPU branch, before any launch)
    qm = torch.empty((1, 16, 1, 8), device="meta", requires_grad=True)
    xm = torch.empty((1, 16, 32), device="meta", requires_grad=True)
    sm = torch.ones(32, device="meta")
    launches = (
        lambda: KA._launch_sm90(qm, qm, qm, scale=1.0, exp_impl="staticmax",
                                kernel=KA.SM90, period=128, what="K1"),
        lambda: KA._launch_forms(qm, qm, qm, scale=1.0, exp_impl="exp",
                                 period=128),
        lambda: KA.launch_temporal("cp", "K9", qm, qm, qm, 1.0),
        lambda: KG.fused_group_norm(xm, sm, sm, num_groups=4),
        lambda: KG.fused_group_norm_2phase(xm, sm, sm, num_groups=4))
    for launch in launches:
        with pytest.raises(RuntimeError, match="silently detached"):
            launch()
        # without grad the guard lets the call through (to the device
        # check, or to the library's build, which has no nvcc here)
        with torch.no_grad(), pytest.raises((ValueError, RuntimeError)) as e:
            launch()
        assert "silently detached" not in str(e.value)
