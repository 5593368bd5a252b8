"""The tensor axis and the train step over a mesh, against vdx on the CPU
in fp32 (spawned ``gloo`` ranks as tests/test_torch_port_parallel.py's
``spawn`` starts them; vdx's programs at XLA O0 on the 8-device CPU
mesh).

1. ``param_sharding_rules`` against vdx's on every denoiser family's tiny
   parameters at ``tensor=2``, ``min_size=2**8`` (no process group): the
   same leaves split, vdx's axis mapped onto the torch weight's dim
   (a kernel's output axis is dim 0, a row split's input axis dim 1);
   everything replicated at ``tensor=1``; at vdx's default ``min_size``
   the column biases vdx splits beside a whole kernel are not cut (ROADMAP
   F22), and no bias is cut without its kernel. ``plan_tensor_parallel`` at
   every family's full width (on the meta device) at ``tensor=2`` and
   vdx's default ``min_size``: every split leaf has its execution, and
   the attentions at local heads are those whose heads divide the axis.
2. The tensor-parallel forward of UNetMotion, UNet3D, the SVD UNet, Latte
   and CogVideoX on a 1x1x2 mesh (2 ranks) against vdx's replicated
   forward at vdx's own bar, 2e-4 (tests/test_mesh_extra.py), on the same
   weights; ``gather_state_dict`` gives back the full state bit for bit;
   the shards laid out otherwise than vdx's contiguous split are exactly
   GEGLU's ``net.0.proj`` in its pairs (LAYOUT_DIFFERS: each of
   ``[hidden | gate]`` cut by the axis, ROADMAP F22).
3. One train step (make_optimizer(LR): clip 1.0 + AdamW; EMA 0.9) of the
   tiny UNetMotion cut to one level (32 channels: vdx's sharded step
   compiles in half the time of two levels), batch 4 x 4 frames, at 4
   ranks on make_mesh(1, 2, 2) (vdx's dry-run layout, ``__graft_entry__.py``)
   and make_mesh(2, 2, 1) = auto_mesh(4), and on the latter once more with
   remat and grad_accum=2, against vdx's step on the dry run's layout
   (its parameters by vdx's rule at min_size 2**10, the batch over (data,
   frames), the context over data; ``with_grad_stats``). Bars: the loss
   rel 1e-5; each gathered gradient within rel-L2 GRAD_REL of the port's
   single-device gradient (measured ~7e-6) and its max |g| within
   GRAD_REL of vdx's where that is not fp32 noise (>= 1e-6: a GroupNorm
   cancels the rest); updated parameters and EMA within 1e-5 of vdx's
   where the gradient element reaches 1e-6 and within 2 * LR everywhere
   (AdamW's first step is +-LR wherever a near-zero element's sign
   differs, as tests/test_torch_port_train.py); the remat + grad_accum
   step's loss and gradients as the plain step's; every rank holds the
   same replicated parameters, bit for bit.

The worker functions import no jax: the spawned ranks import this module.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from test_torch_port_parallel import spawn

ATOL = 2e-4  # tests/test_mesh_extra.py
FAMILIES = ("motion", "unet3d", "svd", "latte", "cog")
LR = 1e-3
KEY = 42
# the port's shards laid out otherwise than vdx's contiguous split
LAYOUT_DIFFERS = "GEGLU net.0.proj (weight and bias) in a column/row pair"
MESHES = ((1, 2, 2), (2, 2, 1))
EMA = 0.9
TRAIN_KW = dict(remat=True, grad_accum=2)
# each gradient against the single-device one, rel-L2 (measured ~7e-6;
# the sharded motion GroupNorms and the psums round otherwise)
GRAD_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _stand_in(tensor):
    """What param_sharding_rules reads of a mesh, without a process group."""
    return types.SimpleNamespace(shape={"data": 1, "frames": 1, "tensor": tensor})


def _port(kind, full=False):
    """The port denoiser of ``kind`` (tiny, or at its full width) and its
    config's class name."""
    from vdx_torch.core.dtypes import FP32_POLICY as P

    if kind == "motion":
        from vdx_torch.models.unet_motion import UNetMotion as M, UNetMotionConfig as C
    elif kind == "unet3d":
        from vdx_torch.models.unet3d import UNet3D as M, UNet3DConfig as C
    elif kind == "svd":
        from vdx_torch.models.svd_unet import SVDUNetConfig as C, UNetSpatioTemporal as M
    elif kind == "latte":
        from vdx_torch.models.dit import LatteConfig as C, LatteDiT as M
    else:
        from vdx_torch.models.cogvideox import CogVideoXConfig as C, CogVideoXDiT as M
    return M(C() if full else C.tiny(), P)


def _inputs(kind):
    """Seeded numpy inputs of vdx's tests/test_mesh_extra.py shapes."""
    r = np.random.default_rng(1)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    t = np.int32([500])
    if kind in ("motion", "unet3d"):
        return f(1, 4, 16, 16, 4), t, f(1, 7, 64)
    if kind == "svd":
        return f(1, 4, 16, 16, 8), np.float32([1.5]), f(1, 1, 64), \
            np.float32([[6, 127, 0.02]])
    if kind == "latte":
        return f(1, 4, 8, 8, 4), t, f(1, 7, 64)
    return f(1, 2, 8, 8, 16), t, f(1, 8, 64)


def _vdx(kind):
    from vdx.core.dtypes import FP32_POLICY as JP

    if kind == "motion":
        from vdx.models.unet_motion import UNetMotion as M, UNetMotionConfig as C
    elif kind == "unet3d":
        from vdx.models.unet3d import UNet3D as M, UNet3DConfig as C
    elif kind == "svd":
        from vdx.models.svd_unet import SVDUNetConfig as C, UNetSpatioTemporal as M
    elif kind == "latte":
        from vdx.models.dit import LatteConfig as C, LatteDiT as M
    else:
        from vdx.models.cogvideox import CogVideoXConfig as C, CogVideoXDiT as M
    return M(C.tiny(), policy=JP), C.tiny()


def _pairs(tmp_path):
    """Every family's tiny port module with random weights, saved for the
    ranks, and vdx's tree of them."""
    from test_torch_port_modelscope import whole_pair

    from vdx_torch.core import convert as TC

    out = {}
    for i, kind in enumerate(FAMILIES):
        model = _port(kind)
        jcfg = _vdx(kind)[1]
        out[kind] = (model, whole_pair(model, "unet", jcfg, TC.rules_for(model), 40 + i))
        torch.save(model.state_dict(), tmp_path / f"{kind}.pt")
    return out


def _geglu_pair_keys(model):
    from vdx_torch.nn.attention import FeedForward

    return {f"{n}.net.0.proj.{leaf}" for n, m in model.named_modules()
            if isinstance(m, FeedForward) for leaf in ("weight", "bias")}


def test_param_sharding_rules_match_vdx():
    from jax.sharding import PartitionSpec as P
    from test_torch_port_modelscope import flat
    from vdx.core import convert as VC
    from vdx.parallel.mesh import make_mesh, param_sharding_rules as vdx_rules

    from vdx_torch.core import convert as TC
    from vdx_torch.parallel.mesh import _vdx_axes, param_sharding_rules
    from vdx_torch.parallel.tensor_parallel import plan_tensor_parallel

    from test_torch_port_modelscope import whole_pair

    jmesh = make_mesh(1, 1, 2)
    for i, kind in enumerate(FAMILIES):
        model = _port(kind)
        rules = TC.rules_for(model)
        params = whole_pair(model, "unet", _vdx(kind)[1], rules, 40 + i)
        specs = VC.flatten_params(vdx_rules(params, jmesh, min_size=2**8))
        leaves = flat(params)
        want = {}
        for path, sharding in specs.items():
            spec = tuple(sharding.spec)
            if spec == tuple(P()):
                continue
            axis = spec.index("tensor") - leaves[path].ndim
            key, tr = rules[path]
            want[key] = _vdx_axes(tr, leaves[path].ndim)[axis]
        got = param_sharding_rules(model, _stand_in(2), min_size=2**8)
        assert set(got) == {k for k, _ in model.named_parameters()}, kind
        assert {k: d for k, d in got.items() if d is not None} == want, kind
        assert len(want) > 10, (kind, len(want))
        assert all(d is None for d in param_sharding_rules(
            model, _stand_in(1), min_size=2**8).values()), kind
        # at the default min_size vdx splits column biases whose kernels
        # stay whole; those layers run whole, their biases uncut
        rule = param_sharding_rules(model, _stand_in(2))
        plan = plan_tensor_parallel(model, _stand_in(2))
        cut = {k for m in plan.values() if "cut" in m for k in m["cut"]}
        whole = {k for k, d in rule.items() if d is not None and k.endswith(".bias")
                 and rule[k[:-4] + "weight"] is None}
        assert whole and not whole & cut, kind
        assert all(k[:-4] + "weight" in cut for k in cut if k.endswith(".bias")), kind
    # full width, the default min_size: every split leaf runs
    local = {"motion": True, "unet3d": False, "latte": True, "cog": True}
    for kind in FAMILIES:
        with torch.device("meta"):
            model = _port(kind, full=True)
        plan = plan_tensor_parallel(model, _stand_in(2))
        heads = plan["__heads__"]
        n_attn = sum(type(m).__name__ == "Attention" for m in model.modules())
        if kind == "svd":  # 5 / 10 / 20 heads: the 5-head level gathers
            assert 0 < len(heads) < n_attn, (kind, len(heads), n_attn)
        elif local[kind]:
            assert len(heads) == n_attn, (kind, len(heads), n_attn)
        else:  # ModelScope: 5 heads at L0, whole attention on every rank
            assert len(heads) < n_attn, (kind, len(heads), n_attn)
        assert len([k for k in plan if not k.startswith("__")]) > 50, kind


def _forward_worker(rank, tmp):
    from vdx_torch.parallel.mesh import make_mesh
    from vdx_torch.parallel.tensor_parallel import gather_state_dict, tensor_parallel

    mesh = make_mesh(1, 1, 2)
    out = {}
    for kind in FAMILIES:
        model = _port(kind).eval()
        full = torch.load(f"{tmp}/{kind}.pt")
        model.load_state_dict(full)
        tensor_parallel(model, mesh, min_size=2**8)
        with torch.no_grad(), mesh.bind():
            out[kind] = model(*map(torch.from_numpy, _inputs(kind))).numpy()
        back = gather_state_dict(model, mesh)
        assert all(torch.equal(back[k], full[k]) for k in full), kind
        halves = {k for k, (_, h) in model.tp_layout.items() if h}
        assert halves == _geglu_pair_keys(model), (kind, LAYOUT_DIFFERS)
    np.savez(f"{tmp}/forward_{rank}.npz", **out)


def test_tp_forward_matches_vdx_per_family(tmp_path):
    from test_torch_port_models import _compile_o0

    import jax.numpy as jnp

    pairs = _pairs(tmp_path)
    wait = spawn(_forward_worker, tmp_path, str(tmp_path), n=2)
    want = {}
    for kind in FAMILIES:  # vdx's replicated forward, while the ranks run
        jm = _vdx(kind)[0]
        args = (pairs[kind][1], *map(jnp.asarray, _inputs(kind)))
        want[kind] = np.asarray(_compile_o0(jm.apply, *args)(*args))
    wait()
    for rank in range(2):
        got = np.load(tmp_path / f"forward_{rank}.npz")
        for kind in FAMILIES:
            assert got[kind].shape == want[kind].shape, kind
            np.testing.assert_allclose(got[kind], want[kind], rtol=0, atol=ATOL,
                                       err_msg=f"{kind} rank {rank}")


# ----------------------------------------------------------------------
# one train step over the mesh
# ----------------------------------------------------------------------
def _train_cfg(pkg):
    if pkg == "vdx":
        from vdx.models.unet_motion import UNetMotionConfig as C
    else:
        from vdx_torch.models.unet_motion import UNetMotionConfig as C
    return dataclasses.replace(C.tiny(), block_out_channels=(32,),
                               down_block_has_attn=(True,))


def _train_batch():
    r = np.random.default_rng(0)
    return {"latents": (r.standard_normal((4, 4, 8, 8, 4)) * 0.5).astype(np.float32),
            "context": r.standard_normal((4, 7, 64)).astype(np.float32)}


def _gather(model, mesh, tensors):
    """This rank's shards of ``tensors`` (keyed as the module's
    parameters) -> the full numpy arrays, as gather_state_dict."""
    from vdx_torch.parallel.mesh import _all_gather_raw, _axis

    out = {}
    with mesh.bind():
        ax = _axis("tensor")
        for k, g in tensors.items():
            if k in model.tp_layout:
                dim, halves = model.tp_layout[k]
                parts = _all_gather_raw(g.contiguous(), ax, dim).chunk(ax.size, dim)
                if halves:
                    pairs = [p.chunk(2, dim) for p in parts]
                    parts = [a for a, _ in pairs] + [b for _, b in pairs]
                g = torch.cat(parts, dim)
            out[k] = g.detach().numpy()
    return out


def _single_device_grads(full, batch):
    """The port's single-device gradient of the step's objective and draw
    (parallel/train.py's ``draw`` and MSE)."""
    from vdx_torch.core import rng
    from vdx_torch.core.dtypes import FP32_POLICY as P
    from vdx_torch.models.unet_motion import UNetMotion
    from vdx_torch.parallel import train as TT

    model = UNetMotion(_train_cfg("port"), P)
    model.load_state_dict(full)
    acp = torch.as_tensor(TT.make_alphas_cumprod(TT.ScheduleConfig()))
    noisy, t, noise = TT.draw(acp, 1000, rng.prng_key(KEY), batch["latents"])
    loss = TT._mse(model(noisy, t, batch["context"]), noise)
    return {k: g.numpy() for k, g in
            TT._grads(loss, dict(model.named_parameters())).items()}


def _train_worker(rank, tmp):
    from vdx_torch.core import rng
    from vdx_torch.core.dtypes import FP32_POLICY as P
    from vdx_torch.models.unet_motion import UNetMotion
    from vdx_torch.parallel import train as TT
    from vdx_torch.parallel.mesh import make_mesh
    from vdx_torch.parallel.tensor_parallel import tensor_parallel

    full = torch.load(f"{tmp}/train.pt")
    batch = {k: torch.from_numpy(v) for k, v in _train_batch().items()}
    single = _single_device_grads(full, batch)
    for shape in MESHES:
        mesh = make_mesh(*shape)
        for flags in ({}, TRAIN_KW)[:1 + (shape == MESHES[1])]:
            model = UNetMotion(_train_cfg("port"), P)
            model.load_state_dict(full)
            tensor_parallel(model, mesh, min_size=2**10)
            state, opt = TT.init_train_state(
                model, optimizer=TT.make_optimizer(LR), ema=True)
            step = TT.make_mesh_train_step(model, opt, mesh, return_grads=True,
                                           **{"ema_decay": EMA, **flags})
            state, metrics = step(state, batch, rng.prng_key(KEY))
            grads = _gather(model, mesh, metrics["grads"])
            for k, g in grads.items():
                if np.linalg.norm(single[k]) > 1e-6:
                    rel = np.linalg.norm(g - single[k]) / np.linalg.norm(single[k])
                    assert rel <= GRAD_REL, (shape, flags, k, rel)
            rep = {k: p.detach().numpy() for k, p in model.named_parameters()
                   if k not in model.tp_layout}
            name = "x".join(map(str, shape)) + ("_flags" if flags else "")
            np.savez(f"{tmp}/train_{name}_{rank}.npz", loss=metrics["loss"].numpy(),
                     **{f"g/{k}": v for k, v in grads.items()},
                     **{f"p/{k}": v for k, v in _gather(
                         model, mesh, dict(model.named_parameters())).items()},
                     **{f"e/{k}": v for k, v in _gather(
                         model, mesh, state.ema_params).items()},
                     **{f"r/{k}": v for k, v in rep.items()})


def _vdx_step(jparams):
    """vdx's step (with its gradient statistics) on the dry run's layout:
    -> (loss, grad absmax, params, ema) as flat numpy dicts over vdx
    paths."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from test_torch_port_modelscope import flat
    from vdx.core.dtypes import FP32_POLICY as JP
    from vdx.models.unet_motion import UNetMotion
    from vdx.parallel.mesh import make_mesh, param_sharding_rules
    from vdx.parallel.train import TrainState, make_optimizer, make_train_step

    mesh = make_mesh(*MESHES[0])
    model = UNetMotion(_train_cfg("vdx"), policy=JP)
    params = jax.device_put(jparams, param_sharding_rules(jparams, mesh,
                                                          min_size=2**10))
    opt = make_optimizer(LR)
    state = TrainState(params, opt.init(params), jnp.zeros((), jnp.int32),
                       jax.tree.map(jnp.array, params))
    step = make_train_step(model, opt, with_grad_stats=True, ema_decay=EMA)
    b = _train_batch()
    batch = {"latents": jax.device_put(b["latents"], NamedSharding(mesh, P("data", "frames"))),
             "context": jax.device_put(b["context"], NamedSharding(mesh, P("data")))}
    key = jax.random.PRNGKey(KEY)
    with jax.set_mesh(mesh) if hasattr(jax, "set_mesh") else mesh:
        run = jax.jit(step).lower(state, batch, key).compile(
            compiler_options={"xla_backend_optimization_level": 0})
        new, metrics = run(state, batch, key)
    return (float(metrics["loss"]), flat(metrics["grad_absmax"]),
            flat(new.params), flat(new.ema_params))


def _close_params(got, want, real, what):
    """AdamW's first step moves an element by about +-LR whatever its
    gradient's size: within 1e-5 where the gradient is real (>= 1e-6),
    within 2 * LR where its sign may differ."""
    d = np.abs(got - want)
    assert np.all(d <= 2 * LR + 1e-6), (what, d.max())
    assert np.all(d[real] <= 1e-5), (what, d[real].max())


def test_mesh_train_step_matches_vdx(tmp_path):
    from test_torch_port_modelscope import whole_pair

    from vdx_torch.core import convert as TC
    from vdx_torch.core.dtypes import FP32_POLICY as P
    from vdx_torch.models.unet_motion import UNetMotion

    model = UNetMotion(_train_cfg("port"), P)
    rules = TC.rules_for(model)
    jparams = whole_pair(model, "unet", _train_cfg("vdx"), rules, 7)
    torch.save(model.state_dict(), tmp_path / "train.pt")
    wait = spawn(_train_worker, tmp_path, str(tmp_path))
    loss, absmax, new, ema = _vdx_step(jparams)  # while the ranks run
    wait()
    runs = {name: [np.load(tmp_path / f"train_{name}_{r}.npz") for r in range(4)]
            for name in ("1x2x2", "2x2x1", "2x2x1_flags")}
    for name, ranks in runs.items():
        got = ranks[0]
        assert abs(float(got["loss"]) - loss) <= 1e-5 * abs(loss), (name, loss)
        for path, (key, tr) in rules.items():
            if path not in new:  # a rule for a layer this config lacks
                continue
            g = tr(got[f"g/{key}"])
            m = float(absmax[path])
            if m >= 1e-6:  # not fp32 noise (a GroupNorm cancels the rest)
                assert abs(float(np.abs(g).max()) - m) <= GRAD_REL * m, (name, path)
            real = np.abs(g) >= 1e-6
            _close_params(tr(got[f"p/{key}"]), new[path], real, (name, "p", path))
            _close_params(tr(got[f"e/{key}"]), ema[path], real, (name, "e", path))
        for r in ranks[1:]:  # the replicated parameters on every rank
            for k in got.files:
                if k.startswith("r/"):
                    assert np.array_equal(r[k], got[k]), (name, k)
    # remat + grad_accum compose: the flagged step is the plain one
    plain, flagged = runs["2x2x1"][0], runs["2x2x1_flags"][0]
    assert abs(float(plain["loss"]) - float(flagged["loss"])) <= 1e-6 * abs(loss)
    for k in plain.files:
        if k.startswith("g/") and np.linalg.norm(plain[k]) > 1e-6:
            rel = np.linalg.norm(flagged[k] - plain[k]) / np.linalg.norm(plain[k])
            assert rel <= GRAD_REL, (k, rel)
