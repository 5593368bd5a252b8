"""The port's metrics (vdx_torch.metrics) against vdx's on the CPU, fp32,
on seeded numpy clips.

Tolerances, each stated where it is used:
  * temporal metrics and the warp error: 1e-6 relative. Both sides take
    fp32 means over at most 32 * 48 * 3 elements in other summation
    orders (a few fp32 ulps); the warp is vdx's operator in vdx's order,
    so a warped pixel sits within ~2e-7 of vdx's (fused or unfused
    multiply-adds), checked at 1e-6 absolute on [0, 1] frames;
  * numpy flows: bit for bit (the port's farneback.py is vdx's code);
  * the native flow against the numpy one: 1e-4 px absolute at 64x64
    (``-ffast-math`` reorders the C++ sums; measured 7e-6 px);
  * LPIPS at 64x64: 1e-5 relative (five fp32 convolution stages in
    oneDNN's and XLA's orders; measured 1.2e-6);
  * measure_video's values and the JSON files: 1e-5 relative, the LPIPS
    bar (a std at 1e-5 of its mean, a variance at 1e-5 of its squared
    mean: a spread of nearly equal values cancels their agreeing bits);
    keys and their order identical.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdx.metrics import engine as JE
from vdx.metrics import farneback as JFB
from vdx.metrics import temporal as JT
from vdx.metrics import warp as JW
from vdx.metrics.flow import OpticalFlowEstimator as JFlow
from vdx.metrics.lpips import LPIPS as JLPIPS
from vdx.metrics.lpips import LPIPSMetric as JLPIPSMetric
from vdx.metrics.lpips import load_torch_weights
from vdx_torch.metrics import engine as TE
from vdx_torch.metrics import farneback as TFB
from vdx_torch.metrics import flow as TF
from vdx_torch.metrics import temporal as TT
from vdx_torch.metrics import warp as TW
from vdx_torch.metrics.lpips import LPIPSMetric, random_lpips_state_dict

REL = 1e-6
LPIPS_REL = 1e-5
NATIVE_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rel * max(1e-30, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _smooth_clip(rng, F, H, W, shift=1.5):
    """uint8 [F, H, W, 3]: a smooth pattern drifting by ``shift`` px a
    frame plus noise, so the flows and warps do real work."""
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    out = []
    for f in range(F):
        base = np.sin((x + shift * f) / 5.0) * np.cos((y - 0.5 * shift * f) / 7.0)
        chans = [127 + 80 * base * (0.7 + 0.1 * c) for c in range(3)]
        img = np.stack(chans, -1) + 20 * rng.random((H, W, 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(out)


def _check_temporal(rng):
    rand = rng.random((6, 32, 48, 3), np.float32)
    same = np.repeat(rand[:1], 4, axis=0)  # identical frames: PSNR 100
    two = rand[:2]  # F = 2: flicker 0
    for name, clip in (("random", rand), ("identical", same), ("F=2", two)):
        want = JT.basic_metrics(jnp.asarray(clip))
        got = TT.basic_metrics(torch.from_numpy(clip))
        for k in ("mse", "psnr", "flicker_index"):
            _close(got[k].numpy(), np.asarray(want[k]), REL, f"{name} {k}")
        lp = rng.random(clip.shape[0] - 1).astype(np.float32)
        _close(TT.temporal_consistency_score(got["mse"], torch.from_numpy(lp)),
               JT.temporal_consistency_score(want["mse"], jnp.asarray(lp)),
               REL, f"{name} score")
    assert (TT.basic_metrics(torch.from_numpy(same))["psnr"] == 100.0).all()
    assert float(TT.flicker_index(torch.from_numpy(two))) == 0.0
    # uint8 clips: divided by 255 as numpy divides the reference's PNGs
    u8 = (rand * 255).astype(np.uint8)
    np.testing.assert_array_equal(TT.unit_frames(torch.from_numpy(u8)).numpy(),
                                  u8.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(TT.unit_frames(u8).numpy(),
                                  u8.astype(np.float32) / 255.0)


def _check_warp(rng):
    frames = rng.random((5, 32, 48, 3), np.float32)
    flows = (rng.standard_normal((4, 32, 48, 2)) * 6).astype(np.float32)
    flows[0] += 1000.0  # every sample past the bottom-right corner
    flows[1, ..., 0] -= 700.0  # past the left edge
    flows[2, :8] = 0.0  # the identity on a band
    want = np.asarray(JW.warp_error_pairs(jnp.asarray(frames), jnp.asarray(flows)))
    got = TW.warp_error_pairs(torch.from_numpy(frames), torch.from_numpy(flows))
    _close(got.numpy(), want, REL, "warp error")
    for i in range(4):
        wf = np.asarray(JW.warp_frame(jnp.asarray(frames[i]), jnp.asarray(flows[i])))
        wt = TW.warp_frame(torch.from_numpy(frames[i]), torch.from_numpy(flows[i]))
        np.testing.assert_allclose(wt.numpy(), wf, rtol=0, atol=1e-6)
    # out of the frame: the edge pixel, as vdx's mode="nearest"
    np.testing.assert_allclose(
        TW.warp_frame(torch.from_numpy(frames[0]), torch.from_numpy(flows[0])).numpy(),
        np.broadcast_to(frames[0, -1, -1], frames[0].shape), rtol=0, atol=1e-6)


def _check_numpy_flows(rng):
    clip = _smooth_clip(rng, 3, 64, 64)
    gray = (clip.astype(np.float32) / 255.0).mean(-1)
    g = (gray * 255).astype(np.uint8)
    got = TFB.calc_flow(g[0], g[1])
    np.testing.assert_array_equal(got, JFB.calc_flow(g[0], g[1]))
    assert np.abs(got).max() > 0.5  # the drift was found
    f32 = clip.astype(np.float32) / 255.0
    t, j = TF.OpticalFlowEstimator("numpy"), JFlow("numpy")
    np.testing.assert_array_equal(t.compute_flow(f32[1], f32[2]),
                                  j.compute_flow(f32[1], f32[2]))
    assert t.compute_flow_stats(got) == j.compute_flow_stats(got)


def test_temporal_warp_and_flows_match_vdx():
    rng = np.random.default_rng(0)
    _check_temporal(rng)
    _check_warp(rng)
    _check_numpy_flows(rng)


def _random_state_dict(seed):
    """Seeded conv weights and lin heads of both signs (both sides take
    abs of the heads)."""
    sd = random_lpips_state_dict(seed)
    gen = torch.Generator().manual_seed(seed + 1)
    for k in sd:
        if k.startswith("lin"):
            sd[k] = torch.randn(sd[k].shape, generator=gen)
        elif k.endswith("bias"):
            sd[k] = 0.1 * torch.randn(sd[k].shape, generator=gen)
    return sd


def test_lpips_matches_vdx():
    rng = np.random.default_rng(1)
    sd = _random_state_dict(3)
    metric = LPIPSMetric(sd, device="cpu")
    params = load_torch_weights({k: v.numpy() for k, v in
                                 metric.model.state_dict().items()})
    jmetric = JLPIPSMetric(params=params)
    x = rng.random((3, 64, 64, 3), np.float32) * 2 - 1
    y = rng.random((3, 64, 64, 3), np.float32) * 2 - 1
    with torch.inference_mode():
        got = metric.model(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    _close(got, np.asarray(JLPIPS().apply(params, x, y)), LPIPS_REL, "forward")
    clip = rng.random((5, 64, 64, 3), np.float32)
    _close(metric.compute_pairs(clip).numpy(), jmetric.compute_pairs(clip),
           LPIPS_REL, "compute_pairs")
    _close(metric.compute(clip[0], clip[3]), jmetric.compute(clip[0], clip[3]),
           LPIPS_REL, "compute")
    # uint8 clips are / 255; the seeded default is deterministic in its seed
    u8 = (clip * 255).astype(np.uint8)
    np.testing.assert_array_equal(
        metric.compute_pairs(u8).numpy(),
        metric.compute_pairs(u8.astype(np.float32) / 255.0).numpy())
    a, b = (LPIPSMetric(seed=s, device="cpu").compute_pairs(clip) for s in (0, 0))
    assert torch.equal(a, b)
    assert not torch.equal(a, LPIPSMetric(seed=1, device="cpu").compute_pairs(clip))


def _ordered(path):
    with open(path) as f:
        return json.load(f, object_pairs_hook=lambda kv: kv)


def _spread_scales(record: dict) -> dict:
    """A spread of nearly equal values cancels their agreeing bits, so a
    std is held at LPIPS_REL of its mean and a variance at LPIPS_REL of
    its squared mean (the values themselves agree to ~1e-6)."""
    return {"std_mse": record["mean_mse"], "std_lpips": record["mean_lpips"],
            "warp_error_variance": record["mean_warp_error"] ** 2,
            "flow_magnitude_variance": record["mean_flow_magnitude"] ** 2}


def _same_json(got, want, what, scale=0.0):
    """Keys and their order identical, strings and ints equal, floats
    within LPIPS_REL of vdx's (of ``scale`` for a spread)."""
    if isinstance(want, list) and want and isinstance(want[0], tuple):
        assert [k for k, _ in got] == [k for k, _ in want], what
        scales = _spread_scales(dict(want)) if "mean_mse" in dict(want) else {}
        for (k, g), (_, w) in zip(got, want):
            _same_json(g, w, f"{what}.{k}", abs(scales.get(k, 0.0)))
    elif isinstance(want, list):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same_json(g, w, f"{what}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float), what
        tol = LPIPS_REL * max(abs(want), scale, 1e-12)
        assert abs(got - want) <= tol, (what, got, want)
    else:
        assert got == want and type(got) is type(want), (what, got, want)


def _check_measure_video_against_vdx(tmp_path, rng):
    sd = _random_state_dict(5)
    metric = LPIPSMetric(sd, device="cpu")
    jmetric = JLPIPSMetric(params=load_torch_weights(
        {k: v.numpy() for k, v in metric.model.state_dict().items()}))
    flow, jflow = TF.OpticalFlowEstimator("numpy"), JFlow("numpy")
    got_all, want_all = [], []
    for i, F in enumerate((5, 2)):
        clip = _smooth_clip(rng, F, 64, 64)
        f32 = clip.astype(np.float32) / 255.0
        cfg = {"guidance_scale": 7.5 + i, "num_inference_steps": 25,
               "phase": "cfg_ablation"}
        timings = {}
        got = TE.measure_video(clip, f"v{i}", f"exp{i}", cfg, metric, flow,
                               device="cpu", timings=timings)
        assert sorted(timings) == ["basic", "flow", "lpips", "warp"]
        want = JE.measure_video(f32, f"v{i}", f"exp{i}", cfg, jmetric, jflow)
        # the same clip as a float array and as a tensor: the same metrics
        for other in (f32, torch.from_numpy(clip)):
            again = TE.measure_video(other, f"v{i}", f"exp{i}", cfg, metric,
                                     flow, device="cpu")
            assert again == got
        TE.save_metrics(got, tmp_path / f"t{i}.json")
        JE.save_metrics(want, tmp_path / f"j{i}.json")
        _same_json(_ordered(tmp_path / f"t{i}.json"),
                   _ordered(tmp_path / f"j{i}.json"), f"metrics {i}")
        got_all.append(got)
        want_all.append(want)
    assert got_all[1].flicker_index == 0.0 and got_all[0].mean_flow_magnitude > 0.5
    TE.save_summary(got_all, tmp_path / "t_summary.json")
    JE.save_summary(want_all, tmp_path / "j_summary.json")
    _same_json(_ordered(tmp_path / "t_summary.json"),
               _ordered(tmp_path / "j_summary.json"), "summary")
    # PNG frames through load_frames: vdx's loader's arrays
    from PIL import Image

    for k, frame in enumerate(clip):
        Image.fromarray(frame).save(tmp_path / f"frame_{k:04d}.png")
    np.testing.assert_array_equal(TE.load_frames(tmp_path), JE.load_frames(tmp_path))


def _check_native_flow(monkeypatch, tmp_path, rng):
    """The native backend, built here with g++, against the numpy one;
    asked for by name without a compiler it raises, and "auto" falls back
    to numpy."""
    clip = _smooth_clip(rng, 2, 64, 64)
    g = ((clip.astype(np.float32) / 255.0).mean(-1) * 255).astype(np.uint8)
    native = TF.OpticalFlowEstimator("native")
    assert native.backend == "native"
    assert TF.OpticalFlowEstimator("auto").backend == "native"
    np.testing.assert_allclose(native.compute_flow_gray(g[0], g[1]),
                               TFB.calc_flow(g[0], g[1]), rtol=0, atol=NATIVE_ATOL)
    monkeypatch.setattr(TF, "BUILD_DIR", tmp_path / "no_build")
    monkeypatch.setattr(TF, "_native", None)
    monkeypatch.setattr(TF, "CXX", "no-such-compiler-g++")
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        TF.OpticalFlowEstimator("native")
    assert TF.OpticalFlowEstimator("auto").backend == "numpy"
    with pytest.raises(ValueError, match="unknown flow backend"):
        TF.OpticalFlowEstimator("opencv")


def _check_cuda_unless_asked_for_the_cpu(tmp_path):
    from vdx_torch.harness import measure_experiments

    clip = np.zeros((2, 8, 8, 3), np.float32)
    if torch.cuda.is_available():
        assert LPIPSMetric().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cpu"):
        LPIPSMetric()
    with pytest.raises(RuntimeError, match="cpu"):
        TE.measure_video(clip, "v", "e", {},
                         flow_estimator=TF.OpticalFlowEstimator("numpy"))
    with pytest.raises(RuntimeError, match="cpu"):
        measure_experiments(tmp_path, tmp_path / "out", log=lambda *a: None)
    assert LPIPSMetric(device="cpu").device.type == "cpu"


def _check_no_pillow_or_pandas_at_import():
    """The card's machine has neither: importing the study's modules must
    not need them (Pillow is imported where a file is written or read)."""
    import subprocess
    import sys

    code = ("import sys, vdx_torch.harness, vdx_torch.metrics, vdx_torch.io; "
            "bad = [m for m in ('PIL', 'pandas', 'jax', 'vdx') if m in sys.modules]; "
            "assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_measure_video_and_json_match_vdx(tmp_path, monkeypatch):
    rng = np.random.default_rng(2)
    _check_measure_video_against_vdx(tmp_path, rng)
    _check_native_flow(monkeypatch, tmp_path, rng)
    _check_cuda_unless_asked_for_the_cpu(tmp_path)
    _check_no_pillow_or_pandas_at_import()
