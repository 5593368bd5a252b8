"""vdx_torch's ``flash_attention_dt`` in all seven of vdx's ``exp_impl``
forms, on the CPU, against vdx.

* Each form's plain version (the CPU path of the wrapper) against vdx's
  Pallas ``flash_attention_dt`` in interpret mode with 128-key blocks, as
  tests/test_kernels.py runs it: fp32 [2, 300, 2, 40] (a masked tail over
  three key blocks, so noexp's -1e30 padding enters l), bf16
  [2, 256, 2, 40] (two full blocks) and fp32 [1, 256, 1, 160].
* The entry point and the ops: vdx's defaults, the staticmax dispatch of
  ``dot_product_attention(impl="flash")``, the eager
  ``_xla_attention_bf16probs_static``, head dims 128 and 160, and the
  raises.
* ``scripts/bench_attn_torch.py --device cpu`` at a tiny shape, every spec.

Inputs come from numpy with a seed and go to both sides. Tolerances: fp32
2e-5 at outputs of magnitude up to 1 (the vdx kernel tests' bar), scaled
by max|vdx| above it (mxu_only does not normalise: its outputs run to
tens here, where fp32 sums in another order differ by a few ulps); bf16
one bf16 ulp at max|vdx| (both sides compute in fp32 and round once at
the same points), and for the eager static bf16-probs path in both
dtypes, since it rounds p to bf16 for fp32 operands too. noexp's bar
scales with max|vdx| with no floor at 1: over a masked tail its padded
keys' -1e30 scores enter l and shrink every output to about 1e-30.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vdx.kernels.flash_attention import flash_attention_dt as jax_flash_dt
from vdx.ops import attention as JA
from vdx_torch.kernels import flash_attention as KA
from vdx_torch.ops import attention as TA

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORMS = ("exp", "exp2", "fastexp2", "staticmax", "staticaug", "noexp",
         "mxu_only")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file's tests run (the suite runs several
    workers side by side); restored afterwards for other files."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(seed, B, Sq, Skv, H, D, dtype):
    """numpy fp32 standard normals -> (jax arrays, torch tensors) in dtype."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for S in (Sq, Skv, Skv)]
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _tol(want: np.ndarray, dtype: str, form: str = "") -> float:
    top = float(np.abs(want).max())
    if form != "noexp":
        top = max(1.0, top)
    return (2e-5 if dtype == "fp32" else 2.0 ** -7) * top


def _vdx(jq, jk, jv, **kw) -> np.ndarray:
    with pltpu.force_tpu_interpret_mode():
        out = jax_flash_dt(jq, jk, jv, **kw)
    return np.asarray(out.astype(jnp.float32))


def test_each_form_plain_matches_vdx_pallas():
    """Every exp_impl, plain version against vdx's Pallas kernel in
    interpret mode (block_q = block_k = 128)."""
    cases = (("fp32", 2, 300, 300, 2, 40),
             ("bf16", 2, 256, 256, 2, 40),
             ("fp32", 1, 256, 256, 1, 160))
    for dtype, B, Sq, Skv, H, D in cases:
        (jq, jk, jv), (tq, tk, tv) = _inputs(11, B, Sq, Skv, H, D, dtype)
        scale = D ** -0.5
        for form in FORMS:
            want = _vdx(jq, jk, jv, scale=scale, block_q=128, block_k=128,
                        exp_impl=form)
            got = KA.flash_attention_dt(tq, tk, tv, scale=scale, block_q=128,
                                        block_k=128, exp_impl=form)
            assert got.dtype == tq.dtype and got.shape == tq.shape
            np.testing.assert_allclose(
                got.float().numpy(), want, atol=_tol(want, dtype, form),
                rtol=0,
                err_msg=f"{form} {dtype} {(B, Sq, Skv, H, D)}")
            if form == "noexp":  # the statistics period is part of it
                period = KA.flash_attention_dt(tq, tk, tv, scale=scale,
                                               block_k=1024, exp_impl=form)
                assert not torch.equal(period, got)


def test_entry_point_and_ops_match_vdx():
    (jq, jk, jv), (tq, tk, tv) = _inputs(12, 1, 300, 300, 2, 40, "fp32")
    # vdx's defaults: exp, blocks 1024
    want = _vdx(jq, jk, jv, scale=0.2)
    got = KA.flash_attention_dt(tq, tk, tv, scale=0.2)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    # impl="flash" is staticmax with vdx's blocks, bit-equal to its plain
    got = TA.dot_product_attention(tq, tk, tv, impl="flash")
    plain = KA.flash_attention_dt_plain(tq, tk, tv, scale=40 ** -0.5,
                                        exp_impl="staticmax")
    assert torch.equal(got, plain)
    # the eager static bf16-probs path, fp32 and bf16 operands: p is
    # rounded to bf16 for both, where a score a few fp32 ulps apart can
    # round the other way, so the bar is one bf16 ulp for both
    for dtype in ("fp32", "bf16"):
        (jq, jk, jv), (tq, tk, tv) = _inputs(13, 2, 96, 77, 2, 40, dtype)
        want = np.asarray(JA._xla_attention_bf16probs_static(jq, jk, jv, 0.3)
                          .astype(jnp.float32))
        got = TA._xla_attention_bf16probs_static(tq, tk, tv, 0.3)
        assert got.dtype == tq.dtype
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=_tol(want, "bf16"), rtol=0)
    # head dims 128 and 160: the repair (vdx asserts only D % 8 == 0)
    for D in (128, 160):
        (jq, jk, jv), (tq, tk, tv) = _inputs(14, 1, 130, 200, 1, D, "fp32")
        for form in ("staticmax", "exp"):
            want = _vdx(jq, jk, jv, scale=D ** -0.5, exp_impl=form)
            got = KA.flash_attention_dt(tq, tk, tv, scale=D ** -0.5,
                                        exp_impl=form)
            np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    t = torch.zeros(1, 64, 1, 20)
    with pytest.raises(ValueError, match="D % 8"):
        KA.flash_attention_dt(t, t, t, scale=1.0)
    with pytest.raises(ValueError, match="exp_impl"):
        KA.flash_attention_dt(tq, tk, tv, scale=1.0, exp_impl="exp3")
    with pytest.raises(ValueError, match="exp_impl"):
        KA.flash_attention_dt_plain(tq, tk, tv, scale=1.0, exp_impl="softmax")


def test_bench_script_runs_every_spec_on_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "bench_attn_torch", ROOT / "scripts" / "bench_attn_torch.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    specs = ["xla", "bf16p", "bf16ps", "packed", "dt:128:128"] + [
        f"dt:128:128:{form}" for form in FORMS]
    assert bench.main(["1,96,2,40,200", *specs, "--device", "cpu",
                       "--iters", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device=cpu shape=[1, 96, 2, 40] Skv=200")
    assert [ln.split("]")[0][1:] for ln in lines[1:]] == specs
    assert all("ms/attention" in ln and "finite=True" in ln
               for ln in lines[1:])
    # the loop is vdx's chain: K attentions feeding the next query
    q, k, v = bench.fresh((1, 64, 1, 8), 64, 0, torch.device("cpu"),
                          torch.float32)
    fn = bench.make_fn("dt:1024:1024:staticmax", 8 ** -0.5)
    c = q
    for _ in range(3):
        c = c + 0.01 * fn(c, k, v)
    assert torch.equal(bench.chain(fn, q, k, v, 3), c)
