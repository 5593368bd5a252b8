"""The port's tools against vdx's on the CPU: the forward tracer
(vdx_torch.tracing), the analysis layer (vdx_torch.analysis) with the
JSON-lines event log (vdx_torch.utils), and the console commands
(vdx_torch.cli), plus the kernel loader under concurrent first use and
what the new packages import.

1. The tracer on the tiny UNet (fp32, the port's random weights carried
   into vdx's tree by vdx's rules), one forward each (vdx's under
   jax.eval_shape: its tracer reads shapes from the abstract values, and
   nothing compiles): vdx records a
   module's Flax path ("down_0_0_resnet/conv1"), the port its diffusers
   name ("down_blocks.0.resnets.0.conv1"); the two are joined through
   the conversion rules (a rule's parameter paths, less the leaf, and
   their parents while the last parts agree). Every joined module agrees
   in execution order, output shapes and dtypes, parameter count and
   shape change; the rules' modules that a trace misses are named
   (width-keeping resnets have no shortcut conv on either side; at one
   key token vdx calls the mid-block self-attention's to_q and to_k and
   drops them, the port skips them). AttentionTracer selects the same
   joined modules; to_dict has vdx's keys; a trace that raises leaves no
   hook behind; profile_trace writes a Chrome trace.
2. The analysis: a 78-record results JSON (the distinct experiments of
   plan_grid_search(), metric values drawn from a seed) through both
   packages' basic and comprehensive analyses: every CSV byte for byte.
   EventLog's JSON lines and echo lines agree but for the timestamps.
3. The commands: --help lists them; generate --tiny --device cpu writes
   the frames of a direct port call and its GIF; serve builds a batching
   service exactly when --batch-window-ms > 0; train and convert return
   2. lib() builds and loads once under eight concurrent first calls.
   Importing vdx_torch.serving, .tracing, .utils, .cli, the pipelines
   (the family base, ModelScope, SVD), their new models and the
   experiment CLIs loads no jax, flax, vdx, Pillow or pandas;
   vdx_torch.analysis and the analysis CLIs (07, 08) load pandas only.
"""

import io
import json
import re
import subprocess
import sys
import threading
import time
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vdx.analysis import basic as JB
from vdx.analysis import comprehensive as JC
from vdx.core import convert as VC
from vdx.core.dtypes import FP32_POLICY as JP
from vdx.models.unet_motion import UNetMotion as JU
from vdx.models.unet_motion import UNetMotionConfig as JUC
from vdx.tracing import tracer as JT
from vdx.utils.logging import EventLog as JEventLog
from vdx.utils.logging import timed as jtimed
from vdx_torch import cli
from vdx_torch.core.dtypes import FP32_POLICY as TP
from vdx_torch.harness import plan_grid_search
from vdx_torch.io import frames as TIO
from vdx_torch.kernels import _lib
from vdx_torch.models.clip_text import CLIPTextConfig as TCC
from vdx_torch.models.unet_motion import UNetMotion as TU
from vdx_torch.models.unet_motion import UNetMotionConfig as TUC
from vdx_torch.models.vae import VAEConfig as TVC
from vdx_torch.pipelines import AnimateDiffPipeline as TPipe
from vdx_torch.pipelines.base import random_init_
from vdx_torch.serving import BatchingGenerationService, GenerationService
from vdx_torch.tracing import tracer as TT
from vdx_torch.utils.logging import EventLog as TEventLog
from vdx_torch.utils.logging import timed as ttimed

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ----------------------------------------------------------------------
# 1. the tracer
# ----------------------------------------------------------------------
def _module_pairs(rules) -> dict:
    """vdx module path -> port module name, from a rule set: each weight's
    module (the parameter path less its leaf), then its parents while
    the two names' last parts agree."""
    pairs = {}
    for path, (hf, _) in rules.items():
        if path.rsplit("/", 1)[1] not in ("kernel", "bias", "scale", "embedding"):
            continue  # a parameter of the module itself (motion norm_scale)
        j, t = path.split("/")[:-1], hf.split(".")[:-1]
        while j and t:
            pairs.setdefault("/".join(j), ".".join(t))
            if j[-1] != t[-1]:
                break
            j, t = j[:-1], t[:-1]
    return pairs


def test_tracer_matches_vdx(tmp_path):
    cfg = TUC.tiny()
    tu = TU(cfg, TP).eval()
    random_init_(tu, torch.Generator().manual_seed(0))
    rules = VC.unet_motion_rules(JUC.tiny())
    sd = {k: v.detach().numpy() for k, v in tu.state_dict().items()}
    params = VC.unflatten_params(
        {p: tr(sd[hf]) for p, (hf, tr) in rules.items() if hf in sd})
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 8, 8, 4)).astype(np.float32)
    t = np.array([500.0, 500.0], np.float32)
    ctx = rng.standard_normal((2, 77, cfg.cross_attention_dim)).astype(np.float32)
    jargs = tuple(jnp.asarray(a) for a in (x, t, ctx))
    targs = tuple(torch.from_numpy(a) for a in (x, t, ctx))
    ju = JU(JUC.tiny(), JP)

    jt = JT.ForwardTracer(ju)
    jout = jax.eval_shape(jt.trace, params, *jargs)
    tt = TT.ForwardTracer(tu)
    with torch.inference_mode():
        tout = tt.trace(*targs)
    assert tuple(tout.shape) == jout.shape == x.shape

    pairs = _module_pairs(rules)
    joined = [(j, pairs[j]) for j in jt.execution_order
              if j in pairs and pairs[j] in tt.traces]
    missed = {j: (j in jt.traces, pairs[j] in tt.traces)
              for j in pairs if (j, pairs[j]) not in joined}
    want_missed = {j: (False, False) for j in pairs
                   if j.endswith("conv_shortcut") and j not in jt.traces}
    want_missed.update({f"mid_attn/blocks_0/attn1/{p}": (True, False)
                        for p in ("to_q", "to_k")})
    assert missed == want_missed, missed
    assert len(joined) > 500
    order = [tt.traces[h].execution_order for _, h in joined]
    assert order == sorted(order), "joined modules ran in another order"
    changed_j, changed_t = set(jt.find_shape_changes()), set(tt.find_shape_changes())
    for j, h in joined:
        a, b = jt.traces[j], tt.traces[h]
        assert a.output_shapes == b.output_shapes, (j, h)
        assert [s.replace("torch.", "") for s in b.output_dtypes] \
            == a.output_dtypes, (j, h)
        assert a.param_count == b.param_count, (j, h)
        assert (j in changed_j) == (h in changed_t), (j, h)
    assert tt.traces["(root)"].param_count == sum(p.numel() for p in tu.parameters())

    ja, ta = JT.AttentionTracer(ju), TT.AttentionTracer(tu)
    jax.eval_shape(ja.trace, params, *jargs)
    with torch.inference_mode():
        ta.trace(*targs)
    joined_t = {h for _, h in joined}
    sel_j = {pairs[j] for j in ja.traces if j in pairs and pairs[j] in joined_t}
    sel_t = set(ta.traces) & joined_t
    assert sel_j == sel_t and len(sel_t) > 100

    deep = TT.ForwardTracer(tu, trace_depth=2)
    with torch.inference_mode():
        deep.trace(*targs)
    assert deep.execution_order == [n for n in tt.execution_order
                                    if TT.module_depth(n.replace("(root)", "")) <= 2]

    dj, dt = jt.to_dict(), tt.to_dict()
    assert list(dj) == list(dt) and dt["num_modules"] == len(tt.traces)
    assert list(dj["traces"][jt.execution_order[0]]) \
        == list(dt["traces"][tt.execution_order[0]])
    assert tt.summary_lines()[:2] == [f"Forward trace: {type(tu).__name__}",
                                      f"Modules traced: {len(tt.traces)}"]

    full = list(tt.execution_order)
    with pytest.raises(RuntimeError), torch.inference_mode():
        tt.trace(targs[0], targs[1], targs[2][:, :, :5])  # a wrong width
    assert not any(m._forward_hooks for m in tu.modules())
    assert TT.trace_model(tu, *targs).execution_order == full

    out, log_dir = TT.profile_trace(lambda a: (a * 2).sum(), torch.ones(8),
                                    log_dir=tmp_path / "prof")
    assert float(out) == 16.0 and log_dir == tmp_path / "prof"
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert events["traceEvents"]


# ----------------------------------------------------------------------
# 2. the analysis layer and the event log
# ----------------------------------------------------------------------
METRIC_KEYS = ["mean_mse", "std_mse", "mean_lpips", "std_lpips",
               "mean_flow_magnitude", "flow_magnitude_variance",
               "mean_warp_error", "warp_error_variance",
               "temporal_consistency_score", "flicker_index"]


def _results(path: Path) -> Path:
    """78 records in save_summary's keys: the plan's distinct experiments,
    seeded metric values."""
    rng = np.random.default_rng(0)
    seen, records = set(), []
    for c in plan_grid_search():
        if c.experiment_id in seen:
            continue
        seen.add(c.experiment_id)
        records.append({"experiment_id": c.experiment_id,
                        "video_name": c.video_name,
                        "guidance_scale": c.guidance_scale,
                        "num_inference_steps": c.num_inference_steps,
                        "phase": c.phase,
                        **{k: float(rng.uniform(0.01, 1.0)) for k in METRIC_KEYS}})
    assert len(records) == 78
    path.write_text(json.dumps(records, indent=2))
    return path


def test_analysis_and_event_log_match_vdx(tmp_path, capsys):
    src = _results(tmp_path / "grid_search_results.json")
    out = {}
    for name, basic_main, comp_main in (
            ("vdx", JB.main, JC.main),
            ("port", lambda a: cli.main(["analyze", *a]),
             lambda a: cli.main(["analyze", "--comprehensive", *a]))):
        basic_main(["--input", str(src), "--output", str(tmp_path / name / "07")])
        comp_main(["--input", str(src), "--output", str(tmp_path / name / "08")])
        out[name] = {p.relative_to(tmp_path / name): p.read_bytes()
                     for p in sorted((tmp_path / name).rglob("*.csv"))}
    assert len(out["port"]) >= 11 + 6 * 3 + 3, sorted(out["port"])
    assert list(out["port"]) == list(out["vdx"])
    for f, data in out["vdx"].items():
        assert out["port"][f] == data, f
    printed = capsys.readouterr().out
    assert "cfg_wins_by_metric" in printed

    lines = {}
    for name, cls in (("vdx", JEventLog), ("port", TEventLog)):
        log = cls(tmp_path / name / "events.jsonl")
        buf = io.StringIO()
        with redirect_stdout(buf):
            log.log("step", i=3, loss=0.25, tag="x")
            with log.span("decode", chunk=2):
                pass
            quiet = cls(tmp_path / name / "quiet.jsonl", echo=False)
            quiet.log("q", n=1)
        sink = []
        with (jtimed if name == "vdx" else ttimed)("block", sink=sink.append):
            pass
        files = [json.loads(x) for p in ("events.jsonl", "quiet.jsonl")
                 for x in (tmp_path / name / p).read_text().splitlines()]
        for rec in files:
            assert isinstance(rec.pop("t"), float)
            rec.pop("seconds", None)
        echo = [re.sub(r"^\[\s*[\d.]+s\] ", "", x).split(" seconds=")[0]
                for x in buf.getvalue().splitlines()]
        lines[name] = (files, echo, [re.sub(r"[\d.]+s$", "", s) for s in sink])
    assert lines["port"] == lines["vdx"]
    assert lines["port"][1][0] == "step i=3 loss=0.25 tag=x"


# ----------------------------------------------------------------------
# 3. the commands, the loader's lock, the imports
# ----------------------------------------------------------------------
class _FakeHandle:
    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, type("Fn", (), {})())


def _check_lib_lock(monkeypatch):
    counts = {"build": 0, "load": 0}

    def build():
        counts["build"] += 1
        time.sleep(0.05)  # every other thread arrives meanwhile
        return Path("/nonexistent/libvdx_torch_kernels.so")

    def cdll(path):
        counts["load"] += 1
        return _FakeHandle()

    monkeypatch.setattr(_lib, "_lib", None)
    monkeypatch.setattr(_lib, "build", build)
    monkeypatch.setattr(_lib.ctypes, "CDLL", cdll)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        barrier, got = threading.Barrier(8), []

        def first_use():
            barrier.wait(timeout=30)
            got.append(_lib.lib())

        threads = [threading.Thread(target=first_use) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(switch)
    assert counts == {"build": 1, "load": 1}, counts
    assert len(got) == 8 and all(h is got[0] for h in got)
    assert got[0].fns["vdx_error_string"].restype is _lib.ctypes.c_char_p


def _loaded(modules) -> list:
    code = (f"import sys; import {', '.join(modules)}; "
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'jax', 'flax', 'vdx', 'PIL', 'pandas'}))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().replace("'", '"'))


def test_cli_loader_lock_and_imports(tmp_path, capsys, monkeypatch):
    assert cli.main(["--help"]) == 0
    listed = capsys.readouterr().out
    for cmd in ("generate", "serve", "analyze", "train", "convert"):
        assert cmd in listed
    for cmd in ("train", "convert"):
        assert cli.main([cmd, "--data", "x"]) == 2
        assert "ROADMAP Queue 1 item 14" in capsys.readouterr().err
    assert cli.main(["nope"]) == 2

    out = tmp_path / "gen"
    args = ["generate", "a corgi on a beach", "--tiny", "--device", "cpu",
            "--num-frames", "8", "--height", "64", "--width", "64",
            "--steps", "2", "--seed", "7", "--output", str(out)]
    assert cli.main(args) == 0
    pipe = TPipe.with_random_params(
        seed=0, unet_config=TUC.tiny(), vae_config=TVC.tiny(),
        text_config=TCC.tiny(), policy=TP, scheduler="ddim", device="cpu")
    want = pipe("a corgi on a beach", negative_prompt="bad quality, blurry, "
                "distorted", num_frames=8, height=64, width=64,
                num_inference_steps=2, seed=7, output_type="np").frames[0]
    got = np.stack([np.asarray(Image.open(out / "frames" / f"frame_{i:04d}.png"))
                    for i in range(8)])
    np.testing.assert_array_equal(got, want)
    TIO.export_to_gif(want, tmp_path / "direct.gif")
    assert (out / "video.gif").read_bytes() == (tmp_path / "direct.gif").read_bytes()

    for window, cls in ((0, GenerationService), (50, BatchingGenerationService)):
        srv = cli.build_server(["--tiny", "--device", "cpu", "--port", "0",
                                "--batch-window-ms", str(window)])
        try:
            assert type(srv.service) is cls
            assert srv.service.pipe.device.type == "cpu"
            if window:
                assert srv.service.batch_window_s == 0.05
        finally:
            srv.httpd.server_close()

    _check_lib_lock(monkeypatch)
    assert _loaded(["vdx_torch.serving", "vdx_torch.tracing", "vdx_torch.utils",
                    "vdx_torch.cli"]) == []
    assert _loaded(["vdx_torch.analysis"]) == ["pandas"]
    # the family base, ModelScope and SVD, and the experiment CLIs (07 and
    # 08 are the pandas analyses)
    assert _loaded(["vdx_torch.pipelines", "vdx_torch.pipelines.svd",
                    "vdx_torch.pipelines.text_to_video_ms",
                    "vdx_torch.models.unet3d", "vdx_torch.models.svd_unet",
                    "vdx_torch.models.clip_vision", "vdx_torch.ops.resize",
                    "vdx_torch.experiments.experiments_common",
                    "vdx_torch.experiments.exp01_baseline_generation",
                    "vdx_torch.experiments.exp02_architecture_inspection",
                    "vdx_torch.experiments.exp03_trace_forward_pass",
                    "vdx_torch.experiments.exp05_grid_search_ablation",
                    "vdx_torch.experiments.exp06_measure_grid_search"]) == []
    assert _loaded(["vdx_torch.experiments.exp07_analyze_grid_search",
                    "vdx_torch.experiments.exp08_analyze_comprehensive"]) \
        == ["pandas"]
