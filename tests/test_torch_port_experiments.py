"""The experiment CLIs of the port (vdx_torch.experiments) against vdx's, on
the CPU with ``--tiny --device cpu``:

1. 05 then 06: the port's grid CLI over the CFG phase of one video at the
   tiny size writes vdx's artifact tree ({id}/frames/frame_*.png,
   {id}/{id}.gif, {id}/config.json, manifest.json); each config.json is
   byte for byte what vdx's ExperimentConfig.save writes for vdx's own
   tiny plan (05:63-77), and manifest.json what vdx's generate_manifest
   writes over the same configs. The port's 06 CLI measures one
   experiment; its {id}_metrics.json and grid_search_results.json are
   byte for byte what vdx's save_metrics and save_summary write for the
   same values (vdx's key order; the values themselves are held against
   vdx's engine in tests/test_torch_port_harness.py). vdx's 05 compiles a
   pipeline program and vdx's 06 a metric program, so the vdx side here
   is the library functions the two CLIs wrap.
2. 07 and 08 over a 78-record results JSON: every CSV byte for byte
   against vdx's CLIs run in-process.
3. 01, 02 and 03: 01 writes the six videos (GIF and 3-digit frame PNGs)
   of direct port calls; 02's report equals vdx's CLI run in-process,
   line for line; 03's attention analysis (the spatial and temporal
   counts, the first temporal attention's input and its reading) equals
   what vdx's ForwardTracer at depth 3 gives on vdx's tiny UNet (traced
   under jax.eval_shape: vdx's 03 initialises and runs its UNet op by op,
   about 90 s of one core), and its trace files are written.
"""

import dataclasses
import io
import json
import runpy
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_port_tools import _module_pairs, _results
from vdx.core import convert as VC
from vdx.harness import grid as JG
from vdx.metrics import engine as JE
from vdx_torch.experiments import (exp01_baseline_generation,
                                   exp02_architecture_inspection,
                                   exp03_trace_forward_pass,
                                   exp05_grid_search_ablation,
                                   exp06_measure_grid_search,
                                   exp07_analyze_grid_search,
                                   exp08_analyze_comprehensive)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _vdx_cli(name: str, argv: list) -> str:
    """vdx's experiments/<name> run in-process as __main__; -> stdout."""
    saved = sys.argv
    sys.argv = [name] + argv
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            runpy.run_path(str(ROOT / "experiments" / name), run_name="__main__")
    finally:
        sys.argv = saved
    return buf.getvalue()


def _port_cli(module, argv: list) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        module.main(argv)
    return buf.getvalue()


def test_grid_and_measure_clis_match_vdx(tmp_path):
    grid = tmp_path / "grid"
    _port_cli(exp05_grid_search_ablation,
              ["--tiny", "--device", "cpu", "--phase", "cfg", "--video",
               "corgi", "--output", str(grid), "--yes"])
    plan = [dataclasses.replace(c, height=64, width=64, num_frames=4,
                                num_inference_steps=2)
            for c in JG.plan_grid_search("cfg", "corgi")]
    assert len(plan) == 6
    ids = sorted(c.experiment_id for c in plan)
    assert sorted(p.name for p in grid.iterdir()) == ids + ["manifest.json"]
    jtree = tmp_path / "vdx_configs"
    for c in plan:
        d = grid / c.experiment_id
        assert sorted(p.name for p in d.iterdir()) == [
            "config.json", f"{c.experiment_id}.gif", "frames"]
        frames = sorted((d / "frames").iterdir())
        assert [p.name for p in frames] == [f"frame_{i:04d}.png" for i in range(4)]
        assert np.asarray(Image.open(frames[0])).shape == (64, 64, 3)
        (jtree / c.experiment_id).mkdir(parents=True)
        c.save(jtree / c.experiment_id / "config.json")
        assert (d / "config.json").read_bytes() \
            == (jtree / c.experiment_id / "config.json").read_bytes()
    JG.generate_manifest(jtree)
    assert (grid / "manifest.json").read_bytes() \
        == (jtree / "manifest.json").read_bytes()

    out = tmp_path / "metrics"
    _port_cli(exp06_measure_grid_search,
              ["--input", str(grid), "--output", str(out), "--filter", "cfg5.0",
               "--device", "cpu"])
    (eid,) = [i for i in ids if "cfg5.0" in i]
    assert sorted(p.name for p in out.iterdir()) == [
        f"{eid}_metrics.json", "grid_search_results.json"]
    rec = json.loads((out / f"{eid}_metrics.json").read_text())
    pairs = [JE.FramePairMetrics(**fm) for fm in rec.pop("frame_metrics")]
    assert len(pairs) == 3
    m = JE.VideoMetrics(frame_metrics=pairs, **rec)
    JE.save_metrics(m, tmp_path / "vdx_metrics.json")
    JE.save_summary([m], tmp_path / "vdx_summary.json")
    assert (out / f"{eid}_metrics.json").read_bytes() \
        == (tmp_path / "vdx_metrics.json").read_bytes()
    assert (out / "grid_search_results.json").read_bytes() \
        == (tmp_path / "vdx_summary.json").read_bytes()


def test_analysis_clis_match_vdx(tmp_path):
    results = _results(tmp_path / "results.json")
    for name, module in (("07_analyze_grid_search.py", exp07_analyze_grid_search),
                         ("08_analyze_comprehensive.py",
                          exp08_analyze_comprehensive)):
        want, got = tmp_path / f"vdx_{name}", tmp_path / f"port_{name}"
        _vdx_cli(name, ["--input", str(results), "--output", str(want)])
        _port_cli(module, ["--input", str(results), "--output", str(got)])
        csvs = sorted(p.name for p in want.iterdir())
        assert csvs and all(c.endswith(".csv") for c in csvs)
        assert sorted(p.name for p in got.iterdir()) == csvs
        for c in csvs:
            assert (got / c).read_bytes() == (want / c).read_bytes(), (name, c)


def _vdx_attention_report() -> dict:
    """vdx's 03 analysis on vdx's tiny UNet, traced at depth 3 under
    jax.eval_shape."""
    from vdx.core.dtypes import FP32_POLICY as JP
    from vdx.models.unet_motion import UNetMotion, UNetMotionConfig
    from vdx.tracing.tracer import ForwardTracer

    cfg = UNetMotionConfig.tiny()
    model = UNetMotion(cfg, policy=JP)
    args = (jnp.zeros((1, 4, 16, 16, cfg.in_channels)), jnp.asarray([500]),
            jnp.zeros((1, 7, cfg.cross_attention_dim)))
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
    tracer = ForwardTracer(model, trace_depth=3)
    jax.eval_shape(tracer.trace, params, *args)
    spatial = [n for n, tr in tracer.traces.items()
               if tr.class_name == "Attention" and "motion" not in n]
    temporal = [(n, tr) for n, tr in tracer.traces.items()
                if tr.class_name == "Attention" and "motion" in n]
    return dict(spatial=len(spatial), temporal=len(temporal),
                first=temporal[0][0], shapes=temporal[0][1].input_shapes)


def test_report_clis_match_vdx(tmp_path):
    from vdx_torch.core.convert import unet_motion_rules
    from vdx_torch.models.unet_motion import UNetMotionConfig

    # 01: the six baseline videos, GIF and frames, at the tiny size
    base = tmp_path / "base"
    _port_cli(exp01_baseline_generation,
              ["--tiny", "--device", "cpu", "--output", str(base)])
    names = [n for n, _ in exp01_baseline_generation.TEST_PROMPTS]
    assert sorted(p.name for p in base.iterdir()) == sorted(
        [f"{n}.gif" for n in names] + [f"{n}_frames" for n in names])
    pipe = exp01_baseline_generation.load_pipeline(tiny=True, device="cpu")
    want = pipe(prompt=exp01_baseline_generation.TEST_PROMPTS[0][1],
                negative_prompt=exp01_baseline_generation.NEGATIVE_PROMPT,
                seed=42, output_type="np", **dict(
                    exp01_baseline_generation.DEFAULT_CONFIG, height=64,
                    width=64, num_frames=4, num_inference_steps=3)).frames[0]
    got = np.stack([np.asarray(Image.open(base / f"{names[0]}_frames"
                                          / f"frame_{i:03d}.png"))
                    for i in range(4)])
    np.testing.assert_array_equal(got, want)

    # 02: vdx's report, line for line
    assert _port_cli(exp02_architecture_inspection, ["--tiny"]) \
        == _vdx_cli("02_architecture_inspection.py", ["--tiny"])

    # 03: the attention analysis against vdx's tracer, the trace files
    out = tmp_path / "traces"
    report = _port_cli(exp03_trace_forward_pass,
                       ["--tiny", "--device", "cpu", "--output", str(out)])
    want = _vdx_attention_report()
    pairs = _module_pairs(unet_motion_rules(UNetMotionConfig.tiny()))
    B_HW, Fr, C = want["shapes"][0]
    for line in (f"Spatial attention modules:  {want['spatial']}",
                 f"Temporal attention modules: {want['temporal']}",
                 f"--- First temporal attention: {pairs[want['first']]}",
                 f"Input shape:  {want['shapes']}",
                 f"  Batch*Height*Width: {B_HW}", f"  Num frames:         {Fr}",
                 f"  Channels:           {C}"):
        assert line in report.splitlines(), line
    assert report.count("[TEMPORAL]") and report.count("[SPATIAL]") \
        and report.count("[RESNET]")
    assert sorted(p.name for p in out.iterdir()) == ["unet_trace.json",
                                                     "unet_trace.txt"]
    assert json.loads((out / "unet_trace.json").read_text())["num_modules"] > 100
