"""The port's serving layer (vdx_torch.serving, vdx_torch.io.png) against
vdx's on the CPU.

1. The protocol: a stub pipeline (frames drawn with numpy from the seed,
   blended with the clip under video2video) behind vdx's GenerationServer
   and behind the port's; the same requests to both, over HTTP. Status
   codes and JSON must be equal, with frames compared as pixels after
   decoding (the two packages' PNG bytes differ: Pillow's filters
   against the port's filter 0) and ``device``, ``avg_seconds``,
   ``timings`` and ``job_id`` left out. Each package's JobManager
   recovers a journal that the other wrote. A second pair of servers
   carries an image-to-video service over a stub SVD pipeline: POST
   /img2vid (the client's PNG resized as Pillow's BILINEAR, down and up,
   before the pipeline sees it), /healthz with the img2vid counters, an
   img2vid job, and a bad image.
2. The slice: POST /generate on the port's server over the tiny port
   pipeline (fp32, 8 frames at 64x64, 2 DDIM steps, CFG 7.5) against
   vdx's pipeline program on the same weights (carried over by vdx's
   rules, compiled once at XLA optimisation level 0): frames within one
   uint8 level (tests/test_torch_port_pipeline.py's bar). The batching
   service with three compatible requests and one other runs two
   batches; each video of the three-request batch sits within one uint8
   level of its own single call and nearer it than the others' (at UNet
   batch 6 the CPU's matmuls round otherwise than at batch 2: the time
   embedding's second linear layer differs by 4.8e-7 already), and each
   video of a two-request batch equals its single call exactly.
3. The codec against Pillow: Pillow reads encode_png's files to the same
   pixels; decode_png reads Pillow's files of modes RGB, RGBA, L, LA and P,
   plain and optimize=True (all five row filters occur), equal to
   ``.convert("RGB")``; interlaced and 16-bit files, a size past
   Pillow's decompression-bomb limit and data short of the header's size
   raise ValueError.
"""

import base64
import http.client
import io
import json
import struct
import threading
import time
import zlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vdx.core import convert as VC
from vdx.core.dtypes import FP32_POLICY as JP
from vdx.models.clip_text import CLIPTextConfig as JCC
from vdx.models.unet_motion import UNetMotionConfig as JUC
from vdx.models.vae import VAEConfig as JVC
from vdx.pipelines import AnimateDiffPipeline as JPipe
from vdx.serving import server as JS
from vdx_torch.core.dtypes import FP32_POLICY as TP
from vdx_torch.io.png import _parse, decode_png, decode_pngs, encode_png
from vdx_torch.models.clip_text import CLIPTextConfig as TCC
from vdx_torch.models.unet_motion import UNetMotionConfig as TUC
from vdx_torch.models.vae import VAEConfig as TVC
from vdx_torch.pipelines import AnimateDiffPipeline as TPipe
from vdx_torch.serving import server as TS

PROMPT = "a corgi walking on the beach, sunset lighting, high quality"
NEG = "bad quality, blurry, distorted"
SIZE = {"num_frames": 8, "num_inference_steps": 2, "height": 64, "width": 64}
# left out of the comparison: the platform's name and wall-clock times
# (device, avg_seconds, timings) and uuid job ids
VOLATILE = ("device", "avg_seconds", "timings", "job_id")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pil_png(a: np.ndarray, **save) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="PNG", **save)
    return buf.getvalue()


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _b64_frames(frames):
    return [base64.b64encode(_pil_png(f)).decode("ascii") for f in frames]


def _frames_of(payload) -> np.ndarray:
    return np.stack([_pil_rgb(base64.b64decode(f)) for f in payload["frames"]])


# ----------------------------------------------------------------------
# 1. the protocol
# ----------------------------------------------------------------------
class _StubPipe:
    """Seeded numpy frames; progress per step; vdx's strength check.
    ``gate`` holds a call until it is set."""

    device = torch.device("cpu")

    def __init__(self, relay):
        self.progress_callback = relay
        self.gate = threading.Event()
        self.gate.set()

    def __call__(self, prompt, seed=0, output_type="pil", num_frames=16,
                 height=512, width=512, num_inference_steps=25, video=None,
                 strength=0.8, **_):
        self.gate.wait(timeout=60)
        if video is not None:
            if not 0.0 < strength <= 1.0:
                raise ValueError(f"strength must be in (0, 1], got {strength}")
            num_frames, height, width = np.asarray(video).shape[:3]
        steps = int(num_inference_steps)
        for i in range(steps):
            self.progress_callback(i, steps)
        rng = np.random.default_rng(seed + len(prompt))
        frames = rng.integers(0, 256, (1, num_frames, height, width, 3),
                              dtype=np.uint8)
        if video is not None:
            frames = frames // 2 + np.asarray(video)[None] // 2
        return SimpleNamespace(frames=torch.from_numpy(frames))


class _Client:
    def __init__(self, port):
        self.port = port

    def __call__(self, method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
        try:
            data = body if isinstance(body, (bytes, type(None))) \
                else json.dumps(body).encode()
            conn.request(method, path, body=data,
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            return r.status, json.loads(r.read())
        finally:
            conn.close()

    def wait(self, job_id, until=("done", "error")):
        deadline = time.time() + 60
        while time.time() < deadline:
            code, st = self("GET", f"/jobs/{job_id}")
            if st.get("status") in until:
                return code, st
            time.sleep(0.01)
        raise AssertionError(f"job {job_id} stuck: {st}")


def _same(a, b, where):
    """Equal JSON but for VOLATILE keys; frames as pixels."""
    if isinstance(a, dict):
        assert set(a) == set(b), (where, sorted(a), sorted(b))
        for k in a:
            if k in VOLATILE:
                continue
            if k == "frames":
                np.testing.assert_array_equal(_frames_of(a), _frames_of(b),
                                              err_msg=where)
            else:
                _same(a[k], b[k], f"{where}.{k}")
    else:
        assert a == b, (where, a, b)


def _protocol_run(mod, clip):
    """One server of package ``mod`` over a stub pipeline; the script's
    (what, status, payload) in order."""
    stub = _StubPipe(mod.ProgressRelay())
    srv = mod.GenerationServer(
        mod.GenerationService(stub, {"num_frames": 3, "num_inference_steps": 4,
                                     "height": 16, "width": 24}), port=0)
    srv.start()
    c, out = _Client(srv.port), []
    try:
        out.append(("healthz", *c("GET", "/healthz")))
        out.append(("generate", *c("POST", "/generate",
                                   {"prompt": "a corgi", "seed": 5})))
        out.append(("generate video", *c("POST", "/generate", {
            "prompt": "a fox", "video": _b64_frames(clip), "strength": 0.5,
            "seed": 2})))
        out.append(("v2v", *c("POST", "/v2v", {
            "prompt": "a fox", "video": _b64_frames(clip), "seed": 3})))
        out.append(("v2v without video", *c("POST", "/v2v", {"prompt": "x"})))
        out.append(("no prompt", *c("POST", "/generate", {"seed": 1})))
        out.append(("bad json", *c("POST", "/generate", b"{not json")))
        out.append(("unknown POST", *c("POST", "/nope", {"prompt": "x"})))
        out.append(("unknown GET", *c("GET", "/nope")))
        out.append(("img2vid", *c("POST", "/img2vid", {"image": "x"})))
        out.append(("healthz after", *c("GET", "/healthz")))
        # jobs: submit, poll to done (progress), fetch
        code, sub = c("POST", "/jobs", {"prompt": "a corgi", "seed": 5})
        out.append(("jobs submit", code, sub))
        out.append(("jobs done", *c.wait(sub["job_id"])))
        out.append(("jobs result", *c("GET", f"/jobs/{sub['job_id']}/result")))
        out.append(("jobs bad subpath", *c("GET", f"/jobs/{sub['job_id']}/x")))
        out.append(("jobs 404", *c("GET", "/jobs/deadbeef")))
        out.append(("jobs result 404", *c("GET", "/jobs/deadbeef/result")))
        # 409: the result of a running job
        stub.gate.clear()
        code, held = c("POST", "/jobs", {"prompt": "held", "seed": 1})
        c.wait(held["job_id"], until=("running",))
        out.append(("jobs 409", *c("GET", f"/jobs/{held['job_id']}/result")))
        stub.gate.set()
        out.append(("jobs held done", *c.wait(held["job_id"])))
        # an error job, and an unknown kind
        code, bad = c("POST", "/jobs", {"prompt": "x", "video": _b64_frames(clip),
                                        "strength": 5.0})
        out.append(("jobs error", *c.wait(bad["job_id"])))
        out.append(("jobs unknown kind", *c("POST", "/jobs",
                                            {"prompt": "x", "kind": "nope"})))
    finally:
        srv.stop()
    return out


class _StubSVD:
    """SVD's call signature; frames from the image it was given (uint8
    from the float [0, 1] input) and the seed, so the resize shows."""

    device = torch.device("cpu")

    def __init__(self, relay):
        self.progress_callback = relay

    def __call__(self, image, seed=0, output_type="np", num_frames=25,
                 height=576, width=1024, num_inference_steps=25,
                 decode_chunk=5, **_):
        image = np.asarray(image)
        assert image.shape == (height, width, 3) and image.dtype == np.float32
        assert int(decode_chunk) > 0
        for i in range(int(num_inference_steps)):
            self.progress_callback(i, int(num_inference_steps))
        base = np.round(image * 255.0).astype(np.uint8)
        rng = np.random.default_rng(seed)
        frames = np.stack([base // 2 + rng.integers(0, 128, base.shape,
                                                    dtype=np.uint8)
                           for _ in range(num_frames)])
        return SimpleNamespace(frames=torch.from_numpy(frames[None]))


def _img2vid_run(mod, image_b64):
    """A server of package ``mod`` with an img2vid service over the stub
    SVD pipeline; the script's (what, status, payload) in order."""
    defaults = {"num_frames": 3, "num_inference_steps": 2, "height": 20,
                "width": 28}
    relay = mod.ProgressRelay()
    svc = mod.GenerationService(_StubPipe(mod.ProgressRelay()), defaults)
    # the port's services on one card share its lock through the constructor
    lock = {"lock": svc.device_lock} if mod is TS else {}
    srv = mod.GenerationServer(svc, port=0, img2vid_service=mod.Img2VidService(
        _StubSVD(relay), defaults, **lock))
    srv.start()
    c, out = _Client(srv.port), []
    try:
        out.append(("img2vid", *c("POST", "/img2vid",
                                  {"image": image_b64, "seed": 3})))
        out.append(("img2vid up", *c("POST", "/img2vid", {
            "image": image_b64, "seed": 4, "height": "52", "width": 70,
            "num_frames": 2})))
        out.append(("img2vid bad image", *c("POST", "/img2vid",
                                            {"image": "bm90IGEgcG5n"})))
        out.append(("img2vid healthz", *c("GET", "/healthz")))
        code, sub = c("POST", "/jobs", {"image": image_b64, "seed": 9})
        out.append(("img2vid job", code, sub))
        out.append(("img2vid job done", *c.wait(sub["job_id"])))
        out.append(("img2vid job result",
                    *c("GET", f"/jobs/{sub['job_id']}/result")))
    finally:
        srv.stop()
    return out


class _Svc:
    """A service whose result names the prompt; counts its calls."""

    def __init__(self):
        self.calls, self.pipe = [], object()
        self.gate = threading.Event()
        self.gate.set()

    def generate(self, request):
        self.gate.wait(timeout=60)
        self.calls.append(request["prompt"])
        return {"frames": [f"video-for-{request['prompt']}"],
                "seed": request.get("seed", 0)}


def _wait(jm, job_id, status):
    deadline = time.time() + 30
    while time.time() < deadline:
        st = jm.status(job_id)
        if st and st["status"] == status:
            return st
        time.sleep(0.01)
    raise AssertionError(f"{job_id} never reached {status}: {jm.status(job_id)}")


def _check_journal_crossing(tmp_path):
    """A journal written by one package, recovered by the other's
    JobManager: done and error jobs as they were (not re-run), the
    unfinished job run by the new worker."""
    for writer, reader in ((JS, TS), (TS, JS)):
        d = tmp_path / f"{writer.__name__}_to_{reader.__name__}"

        class Boom(_Svc):
            def generate(self, request):
                raise RuntimeError("no capacity")

        jm_err = writer.JobManager({"t2v": Boom()}, journal_dir=d)
        failed = jm_err.submit({"prompt": "gamma"})["job_id"]
        _wait(jm_err, failed, "error")
        svc = _Svc()
        jm = writer.JobManager({"t2v": svc}, journal_dir=d)
        assert jm.status(failed)["status"] == "error"
        done = jm.submit({"prompt": "alpha", "seed": 1})["job_id"]
        _wait(jm, done, "done")
        svc.gate.clear()  # the next job hangs "mid-generation"
        pending = jm.submit({"prompt": "beta", "seed": 2})["job_id"]
        _wait(jm, pending, "running")

        svc2 = _Svc()
        jm2 = reader.JobManager({"t2v": svc2}, journal_dir=d)
        assert jm2.status(done) == {"job_id": done, "status": "done"}
        assert jm2.result(done) == {"frames": ["video-for-alpha"], "seed": 1}
        st = jm2.status(failed)
        assert st["status"] == "error" and "RuntimeError: no capacity" in st["error"]
        _wait(jm2, pending, "done")
        assert jm2.result(pending)["frames"] == ["video-for-beta"]
        assert svc2.calls == ["beta"], svc2.calls
        svc.gate.set()


def test_protocol_matches_vdx(tmp_path):
    clip = np.random.default_rng(0).integers(0, 256, (2, 16, 24, 3), dtype=np.uint8)
    want, got = _protocol_run(JS, clip), _protocol_run(TS, clip)
    assert [w[0] for w in want] == [g[0] for g in got]
    for (what, wcode, wbody), (_, gcode, gbody) in zip(want, got):
        assert wcode == gcode, (what, wcode, gcode, wbody, gbody)
        _same(wbody, gbody, what)
    codes = {w[0]: w[1] for w in want}
    assert (codes["v2v without video"], codes["bad json"], codes["img2vid"],
            codes["jobs 409"], codes["jobs unknown kind"]) == (400, 500, 404, 409, 400)
    byname = {g[0]: g[2] for g in got}
    assert byname["healthz"]["device"] == "cpu"
    assert byname["jobs done"]["progress"] == {"step": 4, "total": 4}
    assert "strength" in byname["jobs error"]["error"]
    assert _frames_of(byname["generate video"]).shape == (2, 16, 24, 3)
    # the image-to-video route (SVD's service) on both packages
    image = np.random.default_rng(1).integers(0, 256, (33, 47, 3), dtype=np.uint8)
    image_b64 = base64.b64encode(_pil_png(image)).decode("ascii")
    want, got = _img2vid_run(JS, image_b64), _img2vid_run(TS, image_b64)
    assert [w[0] for w in want] == [g[0] for g in got]
    for (what, wcode, wbody), (_, gcode, gbody) in zip(want, got):
        assert wcode == gcode, (what, wcode, gcode, wbody, gbody)
        if what == "img2vid bad image":  # each package's decoder's message
            assert wcode == 500 and gbody["error"].startswith("ValueError")
            continue
        _same(wbody, gbody, what)
    byname = {g[0]: g[2] for g in got}
    assert _frames_of(byname["img2vid"]).shape == (3, 20, 28, 3)
    assert _frames_of(byname["img2vid up"]).shape == (2, 52, 70, 3)
    assert byname["img2vid healthz"]["img2vid"]["requests_served"] == 2
    assert byname["img2vid job done"]["progress"] == {"step": 2, "total": 2}
    with pytest.raises(ValueError, match="device_lock"):
        TS.GenerationServer(TS.GenerationService(_StubPipe(None)), port=0,
                            img2vid_service=TS.Img2VidService(_StubSVD(None)))
    _check_journal_crossing(tmp_path)


# ----------------------------------------------------------------------
# 2. the slice
# ----------------------------------------------------------------------
def _tiny_port():
    pipe = TPipe(unet_config=TUC.tiny(), vae_config=TVC.tiny(),
                 text_config=TCC.tiny(), policy=TP, scheduler="ddim",
                 device="cpu")
    pipe.init_params(0)
    return pipe


def _vdx_frames(tpipe, seed):
    """vdx's pipeline on the port's weights (vdx's rules): its program
    for SIZE, compiled at O0, as its __call__ runs it."""
    rule_sets = {"unet": VC.unet_motion_rules(JUC.tiny()),
                 "vae": VC.vae_rules(JVC.tiny()),
                 "text": VC.clip_text_rules(JCC.tiny())}
    modules = {"unet": tpipe.unet, "vae": tpipe.vae, "text": tpipe.text_encoder}
    params = {}
    for name, rules in rule_sets.items():
        sd = {k: v.numpy() for k, v in modules[name].state_dict().items()}
        params[name] = VC.unflatten_params(
            {p: tr(sd[hf]) for p, (hf, tr) in rules.items() if hf in sd})
    jpipe = JPipe(unet_config=JUC.tiny(), vae_config=JVC.tiny(),
                  text_config=JCC.tiny(), policy=JP, scheduler="ddim",
                  params=params)
    prog = jpipe._get_program(scheduler="ddim", guidance=True,
                              latent_shape=(1, 8, 8, 8, 4), num_steps=2, chunk=8)
    args = (jpipe.params, jpipe._seed_keys(seed, 1),
            jpipe.encode_prompt(PROMPT, NEG), jnp.float32(7.5),
            jpipe._get_tables("ddim", 2))
    run = prog.lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    latents, frames_u8 = run(*args)
    return jpipe._postprocess(latents, frames_u8, None, "np", 1).frames[0]


def _burst(svc, requests):
    """``requests`` queued on a batching service before its worker starts."""
    results = [None] * len(requests)

    def call(i):
        results[i] = svc.generate(requests[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(requests))]
    for t in threads:
        t.start()
    deadline = time.time() + 60
    while len(svc._queue) < len(requests) and time.time() < deadline:
        time.sleep(0.01)
    svc.start_worker()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive()
    return results


def test_served_slice_matches_vdx():
    tpipe = _tiny_port()
    want = _vdx_frames(tpipe, 1234)

    srv = TS.GenerationServer(TS.GenerationService(tpipe, SIZE), port=0)
    srv.start()
    try:
        code, resp = _Client(srv.port)("POST", "/generate",
                                       {"prompt": PROMPT, "seed": 1234})
    finally:
        srv.stop()
    # a stopped server's job worker is gone, and with it its hold on the
    # services' pipelines
    assert not srv.jobs._worker.is_alive()
    assert code == 200 and resp["num_frames"] == 8
    got = decode_pngs([base64.b64decode(f) for f in resp["frames"]])
    assert got.shape == want.shape == (8, 64, 64, 3) and want.std() > 0
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, diff.max()

    single = TS.GenerationService(tpipe, SIZE)
    reqs = [{"prompt": PROMPT, "seed": 1234},
            {"prompt": "a red panda eating bamboo", "seed": 7,
             "guidance_scale": 5.0},
            {"prompt": "birds over the sea", "seed": 99, "guidance_scale": 9.0}]
    own = [decode_pngs([base64.b64decode(f) for f in single.generate(r)["frames"]])
           for r in reqs]
    svc = TS.BatchingGenerationService(tpipe, SIZE, autostart=False)
    out = _burst(svc, reqs + [{"prompt": "a fox", "seed": 3,
                               "num_inference_steps": 1}])
    assert svc.batches_run == 2 and svc.requests_served == 4
    assert [r["timings"]["batch_size"] for r in out] == [3, 3, 3, 1]
    for b, r in enumerate(out[:3]):
        frames = decode_pngs([base64.b64decode(f) for f in r["frames"]])
        dist = [np.abs(frames.astype(np.int16) - o).max() for o in own]
        assert dist[b] <= 1 and dist[b] < min(d for i, d in enumerate(dist)
                                              if i != b), dist
        assert r["seed"] == reqs[b]["seed"]
    # the batching worker stops and starts again
    worker = svc._worker
    svc.stop_worker()
    assert not worker.is_alive() and svc._worker is None
    svc.start_worker()
    assert svc.generate({"prompt": "a fox", "seed": 3,
                         "num_inference_steps": 1})["frames"] == out[3]["frames"]
    svc.stop_worker()
    svc2 = TS.BatchingGenerationService(tpipe, SIZE, autostart=False)
    out2 = _burst(svc2, reqs[:2])
    assert svc2.batches_run == 1
    for r, o in zip(out2, own):
        np.testing.assert_array_equal(
            decode_pngs([base64.b64decode(f) for f in r["frames"]]), o)


# ----------------------------------------------------------------------
# 3. the codec against Pillow
# ----------------------------------------------------------------------
def _pattern(rng, h, w):
    """Noise bands, gradients and a product texture: Pillow's adaptive
    filtering picks every row filter over these."""
    y, x = np.mgrid[0:h, 0:w]
    smooth = np.stack([(3 * x + y) % 256, (2 * y) % 256, (x * y // 7) % 256], -1)
    noise = rng.integers(0, 256, (h, w, 3))
    img = np.where(((y // 8) % 3 == 0)[..., None], noise, smooth)
    img[::5] = (img[::5] + rng.integers(0, 3, img[::5].shape)) % 256
    return img.astype(np.uint8)


def _with_header(png: bytes, **fields) -> bytes:
    """``png`` with IHDR fields replaced (bit depth, interlace), CRC fixed."""
    n = struct.unpack(">I", png[8:12])[0]
    W, H, depth, ctype, comp, filt, inter = struct.unpack(">IIBBBBB", png[16:16 + n])
    depth = fields.get("depth", depth)
    inter = fields.get("interlace", inter)
    body = struct.pack(">IIBBBBB", W, H, depth, ctype, comp, filt, inter)
    chunk = struct.pack(">I", n) + b"IHDR" + body + struct.pack(
        ">I", zlib.crc32(b"IHDR" + body))
    return png[:8] + chunk + png[8 + 12 + n:]


def test_png_codec_matches_pillow():
    rng = np.random.default_rng(0)
    for h, w in ((1, 1), (7, 13), (64, 80)):
        a = _pattern(rng, h, w)
        png = encode_png(a)
        np.testing.assert_array_equal(_pil_rgb(png), a)
        np.testing.assert_array_equal(decode_png(png), a)
    filters = set()
    for mode in ("RGB", "RGBA", "L", "LA", "P"):
        for optimize in (False, True):
            for h, w in ((1, 5), (33, 17), (64, 80)):
                a = _pattern(rng, h, w)
                im = Image.fromarray(a)
                if mode == "RGBA":
                    alpha = rng.integers(0, 256, (h, w, 1), dtype=np.uint8)
                    im = Image.fromarray(np.concatenate([a, alpha], -1))
                elif mode != "RGB":
                    im = im.convert(mode)
                buf = io.BytesIO()
                im.save(buf, format="PNG", optimize=optimize)
                png = buf.getvalue()
                (_, _, ctype, _), _, rows = _parse(png)
                assert ctype == {"RGB": 2, "RGBA": 6, "L": 0, "LA": 4, "P": 3}[mode]
                filters |= set(rows[:, 0].tolist())
                np.testing.assert_array_equal(decode_png(png), _pil_rgb(png),
                                              err_msg=f"{mode} {optimize} {h}x{w}")
    assert filters == {0, 1, 2, 3, 4}, filters
    # a clip of Pillow frames decoded together, frame by frame equal
    clip = [_pil_png(_pattern(rng, 24, 40)) for _ in range(3)]
    np.testing.assert_array_equal(decode_pngs(clip),
                                  np.stack([_pil_rgb(p) for p in clip]))
    sixteen = _pil_png(rng.integers(0, 65536, (8, 8), dtype=np.uint16))
    with pytest.raises(ValueError, match="bit depth 16"):
        decode_png(sixteen)
    with pytest.raises(ValueError, match="interlace"):
        decode_png(_with_header(encode_png(_pattern(rng, 8, 8)), interlace=1))
    with pytest.raises(ValueError, match="bit depth 4"):
        decode_png(_with_header(encode_png(_pattern(rng, 8, 8)), depth=4))
    with pytest.raises(ValueError, match="over the limit"):
        decode_png(_with_header(encode_png(_pattern(rng, 8, 8)).replace(
            struct.pack(">II", 8, 8), struct.pack(">II", 20000, 20000), 1)))
    with pytest.raises(ValueError, match="the header says"):
        decode_png(_with_header(encode_png(_pattern(rng, 8, 8)).replace(
            struct.pack(">II", 8, 8), struct.pack(">II", 8, 9), 1)))
    with pytest.raises(ValueError, match="CRC"):
        bad = bytearray(encode_png(_pattern(rng, 8, 8)))
        bad[20] ^= 1
        decode_png(bytes(bad))
