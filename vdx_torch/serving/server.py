"""Generation service and HTTP server (port of vdx/serving/server.py).

  * :class:`GenerationService` — thread-safe wrapper around a pipeline:
    single-flight device execution (one request's work on the card at a
    time), request/latency accounting.
  * :class:`GenerationServer` — stdlib http.server JSON API:
      POST /generate {prompt, negative_prompt?, num_frames?, steps?,
                      guidance_scale?, height?, width?, seed?}
        -> {frames: [base64 PNG, ...], timings: {...}}
      POST /v2v {prompt, video: [base64 PNG, ...], strength?, ...}
        -> same payload (video2video; geometry derives from the clip)
      POST /img2vid {image: base64 PNG, num_frames?, ...} -> same payload
        (SVD; with an ``img2vid_service``, else 404 as vdx's server)
      GET /healthz -> {status, device, requests_served, avg_seconds,
                       img2vid?: {requests_served, avg_seconds}}
  * Async job API (a multi-second denoise should not hold an HTTP
    connection open):
      POST /jobs {kind?: "t2v"|"v2v"|"img2vid", ...request}
        -> {job_id, status}
      GET /jobs/{id} -> {status: queued|running|done|error,
                         progress: {step, total}?, error?}
      GET /jobs/{id}/result -> the same payload the sync route returns
    Per-step progress comes from the pipeline's denoise loop when the
    pipeline was built with ``progress=ProgressRelay()``; the job worker
    points the relay at the running job.

No web framework and no Pillow: frames go in and out as PNG through
vdx_torch.io.png (zlib and numpy), since the card's machine has no
Pillow. Routes, status codes, payloads and the job journal are vdx's, so
a client, or a journal directory, serves either package. Scale-out is
one server process per card behind any HTTP load balancer; in-process
batching rides vdx_torch/harness/batched.py.
"""

from __future__ import annotations

import base64
import json
import os
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

import torch

from vdx_torch.io.png import decode_png, decode_pngs, encode_png
from vdx_torch.ops.resize import resize_bilinear_u8


class ProgressRelay:
    """A stable per-step callback for pipelines used in serving.

    The pipeline holds ``progress`` for its life; a relay lets the
    serving layer retarget where progress goes per request
    (``relay.target = fn``). The pipeline calls it with Python ints from
    its host loop, so it adds no host sync; on the card the host runs
    ahead of the device, so a step is reported when it is queued. With no
    target it does nothing."""

    def __init__(self):
        self.target = None

    def __call__(self, i: int, n: int) -> None:
        fn = self.target
        if fn is not None:
            fn(int(i), int(n))


def _png_b64(frames) -> list:
    """uint8 [F, H, W, 3] -> list of base64 PNG strings."""
    return [base64.b64encode(encode_png(f)).decode("ascii") for f in frames]


class GenerationService:
    """``lock``: the device lock, one request's work on the card at a time;
    services that share a card share it (a new lock when None)."""

    def __init__(self, pipe, defaults: Optional[dict] = None,
                 lock: Optional[threading.Lock] = None):
        self.pipe = pipe
        self.defaults = {
            "num_frames": 16,
            "num_inference_steps": 25,
            "guidance_scale": 7.5,
            "height": 512,
            "width": 512,
            "negative_prompt": "bad quality, blurry, distorted",
            **(defaults or {}),
        }
        self.device_lock = lock or threading.Lock()
        # the counters are updated outside the device lock, from handler
        # and worker threads
        self._stats_lock = threading.Lock()
        self.requests_served = 0
        self.total_seconds = 0.0

    def _account(self, seconds: float) -> None:
        with self._stats_lock:
            self.requests_served += 1
            self.total_seconds += seconds

    def generate(self, request: dict) -> dict:
        return self._generate_single(request)

    def _generate_single(self, request: dict) -> dict:
        """One pipeline call under the device lock. With a ``video`` field
        (list of base64 PNG frames) the call runs video2video: the clip is
        decoded host-side and restyled under the prompt at ``strength``
        (geometry then derives from the clip, so those keys drop)."""
        prompt = request["prompt"]
        kwargs = {
            k: request.get(k, v)
            for k, v in self.defaults.items()
        }
        if "video" in request:
            kwargs["video"] = decode_pngs(
                [base64.b64decode(b) for b in request["video"]])
            kwargs["strength"] = float(request.get("strength", 0.8))
            for k in ("num_frames", "height", "width"):
                kwargs.pop(k, None)
        seed = int(request.get("seed", 0))
        t0 = time.time()
        with self.device_lock:  # one request's work on the card at a time
            out = self.pipe(
                prompt,
                seed=seed,
                output_type="device",
                **kwargs,
            )
        # the readback OUTSIDE the lock: the next request's work queues
        # on the card while these frames come back
        frames = out.frames[0].cpu().numpy()
        dt = time.time() - t0
        encoded = _png_b64(frames)
        self._account(dt)
        return {
            "frames": encoded,
            "num_frames": len(frames),
            "timings": {"seconds": round(dt, 3)},
            "seed": seed,
        }

    def health(self) -> dict:
        return {
            "status": "ok",
            "device": torch.device(self.pipe.device).type,
            "requests_served": self.requests_served,
            "avg_seconds": round(
                self.total_seconds / max(self.requests_served, 1), 3
            ),
        }


class Img2VidService(GenerationService):
    """Image-to-video serving for the SVD pipeline (vdx's
    ``Img2VidService``).

    POST body: {image: base64 PNG, num_frames?, num_inference_steps?,
    height?, width?, seed?, decode_chunk?} -> the text-to-video payload.
    The image is decoded host-side (vdx_torch.io.png), resized to the
    requested geometry as Pillow's BILINEAR (vdx_torch.ops.resize), and
    given to the pipeline as float32 [0, 1]. Beside a text-to-video
    service on the same card, build it with that service's
    ``device_lock``."""

    def __init__(self, pipe, defaults: Optional[dict] = None,
                 lock: Optional[threading.Lock] = None):
        super().__init__(pipe, {
            "num_frames": 25,
            "num_inference_steps": 25,
            "height": 576,
            "width": 1024,
            "decode_chunk": 5,
            **(defaults or {}),
        }, lock)
        # text2video keys that do not apply to img2vid
        for k in ("guidance_scale", "negative_prompt"):
            self.defaults.pop(k, None)

    def generate(self, request: dict) -> dict:
        import numpy as np

        raw = base64.b64decode(request["image"])
        kwargs = {k: request.get(k, v) for k, v in self.defaults.items()}
        # cast once so the resize geometry and the pipeline request agree
        for k in ("width", "height", "num_frames", "num_inference_steps",
                  "decode_chunk"):
            if k in kwargs:
                kwargs[k] = int(kwargs[k])
        img = resize_bilinear_u8(decode_png(raw), kwargs["width"],
                                 kwargs["height"])
        image = img.astype(np.float32) / 255.0
        seed = int(request.get("seed", 0))
        t0 = time.time()
        with self.device_lock:
            out = self.pipe(image, seed=seed, output_type="device", **kwargs)
        frames = out.frames[0].cpu().numpy()  # the readback outside the lock
        dt = time.time() - t0
        encoded = _png_b64(frames)
        self._account(dt)
        return {
            "frames": encoded,
            "num_frames": len(frames),
            "timings": {"seconds": round(dt, 3)},
            "seed": seed,
        }


class BatchingGenerationService(GenerationService):
    """Cross-request micro-batching.

    Concurrent requests sharing the static signature (num_frames, steps,
    height, width) stack on the batch axis and run as ONE denoise loop
    (vdx_torch.harness.batched.denoise_batch: one UNet call a step at
    batch 2N) and one chunked decode, with each request's prompt, seed
    and guidance its own. A request waits at most ``batch_window_s`` for
    company; shape-incompatible requests run in their own batch.
    """

    def __init__(self, pipe, defaults: Optional[dict] = None,
                 batch_window_s: float = 0.05, max_batch: int = 8,
                 scheduler: Optional[str] = None, autostart: bool = True):
        super().__init__(pipe, defaults)
        self.batch_window_s = batch_window_s
        self.max_batch = max_batch
        self.scheduler = scheduler or getattr(pipe, "scheduler", "ddim")
        self.batches_run = 0
        self._queue: list = []
        self._cv = threading.Condition()
        self._worker: Optional[threading.Thread] = None
        if autostart:
            self.start_worker()

    def start_worker(self) -> None:
        """Start draining (idempotent). autostart=False lets callers enqueue
        a burst first — deterministic batching for tests/offline use."""
        if self._worker is None:
            self._worker = threading.Thread(target=self._drain_loop, daemon=True)
            self._worker.start()

    # -- public ---------------------------------------------------------
    def generate(self, request: dict) -> dict:
        if "video" in request:
            # video2video requests carry per-request geometry and an input
            # clip — they run single-flight, never stacked into a batch
            return self._generate_single(request)
        slot = {"request": request, "event": threading.Event(),
                "result": None, "error": None}
        with self._cv:
            self._queue.append(slot)
            self._cv.notify()
        slot["event"].wait()
        if slot["error"] is not None:
            raise slot["error"]
        return slot["result"]

    # -- worker ---------------------------------------------------------
    def _static_key(self, request: dict):
        g = lambda k: request.get(k, self.defaults[k])  # noqa: E731
        return (int(g("num_frames")), int(g("num_inference_steps")),
                int(g("height")), int(g("width")))

    def _drain_loop(self):
        while True:
            with self._cv:
                while not self._queue:
                    self._cv.wait()
                # window: let compatible requests accumulate
                self._cv.wait(timeout=self.batch_window_s)
                key = self._static_key(self._queue[0]["request"])
                batch, rest = [], []
                for s in self._queue:
                    if (len(batch) < self.max_batch
                            and self._static_key(s["request"]) == key):
                        batch.append(s)
                    else:
                        rest.append(s)
                self._queue = rest
            try:
                self._run_batch(key, batch)
            except Exception as e:  # noqa: BLE001 — deliver per-request
                for s in batch:
                    s["error"] = e
                    s["event"].set()

    def _run_batch(self, key, batch):
        from vdx_torch.harness import batched
        from vdx_torch.harness.config import ExperimentConfig

        F, steps, H, W = key
        pipe = self.pipe
        t0 = time.time()
        reqs = [s["request"] for s in batch]
        neg = self.defaults["negative_prompt"]
        configs = [
            ExperimentConfig(
                experiment_id=f"request_{i}", video_name="request",
                prompt=r["prompt"],
                negative_prompt=r.get("negative_prompt", neg),
                guidance_scale=float(r.get(
                    "guidance_scale", self.defaults["guidance_scale"])),
                num_inference_steps=steps, phase="serving",
                seed=int(r.get("seed", 0)), num_frames=F, height=H, width=W)
            for i, r in enumerate(reqs)
        ]
        # Prompt encode happens OUTSIDE the device lock: the text tower is
        # small and read-only — only the denoise and decode are
        # single-flighted.
        context = batched.batch_context(pipe, configs)
        chunk = max(1, min(4, F))
        while F % chunk:
            chunk -= 1
        with self.device_lock:
            latents = batched.denoise_batch(pipe, configs, self.scheduler,
                                            context=context)
            # ONE chunked decode for the whole batch: latents [N, F, ...]
            # (chunks never straddle videos since chunk | F)
            frames_u8 = pipe._decode(latents, chunk)
        frames_all = frames_u8.cpu().numpy()  # readback outside the lock
        dt = time.time() - t0
        self.batches_run += 1

        for s, frames, r in zip(batch, frames_all, reqs):
            self._account(dt / len(batch))
            s["result"] = {
                "frames": _png_b64(frames),
                "num_frames": len(frames),
                "timings": {"seconds": round(dt, 3),
                            "batch_size": len(batch)},
                "seed": int(r.get("seed", 0)),
            }
            s["event"].set()


class JobManager:
    """Async request execution: submit -> poll -> fetch.

    One FIFO worker thread drains jobs (requests run single-flight on the
    card anyway, so more workers would only queue on the service lock).
    If a service's pipeline carries a :class:`ProgressRelay`, the worker
    points it at the running job so GET /jobs/{id} reports live per-step
    progress."""

    MAX_JOBS = 256  # completed jobs retained for result pickup (FIFO evict)

    def __init__(self, services: dict, journal_dir=None):
        """services: kind -> GenerationService (e.g. {"t2v": svc,
        "v2v": svc}).

        ``journal_dir``: durable job journal, vdx's files and keys. Each
        submit atomically writes ``{id}.request.json``; the worker
        atomically writes ``{id}.result.json`` (or ``.error.json``) on
        completion. A JobManager constructed over an existing journal,
        this package's or vdx's, RECOVERS it: finished jobs come back
        status=done with their results servable, unfinished ones requeue
        (seeded requests regenerate deterministically) — a killed server
        loses no job and re-runs no finished one."""
        self.services = services
        self.jobs: dict = {}
        self._order: list = []
        self._lock = threading.Lock()
        self._queue: list = []
        self._cv = threading.Condition(self._lock)
        self.journal_dir = Path(journal_dir) if journal_dir else None
        if self.journal_dir is not None:
            self.journal_dir.mkdir(parents=True, exist_ok=True)
            self._recover()
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._worker.start()

    # -- journal --------------------------------------------------------
    def _jfile(self, job_id: str, kind: str):
        return self.journal_dir / f"{job_id}.{kind}.json"

    @staticmethod
    def _atomic_json(path, obj) -> None:
        tmp = path.with_name(path.name + ".tmp")
        with open(tmp, "w") as f:
            json.dump(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def _evict_journal(self, job_id: str) -> None:
        if self.journal_dir is None:
            return
        for kind in ("request", "result", "error"):
            try:
                self._jfile(job_id, kind).unlink()
            except FileNotFoundError:
                pass

    def _recover(self) -> None:
        """Rebuild job state from the journal (no lock needed: runs before
        the worker thread starts)."""
        entries = []
        for p in self.journal_dir.glob("*.request.json"):
            try:
                with open(p) as f:
                    entries.append(json.load(f))
            except (OSError, ValueError):
                continue  # atomic renames leave no torn file; an
                # unreadable one is operator damage, skipped
        for e in sorted(entries, key=lambda e: e.get("created", 0.0)):
            job_id = e["id"]
            job = {"id": job_id, "kind": e["kind"], "status": "queued",
                   "request": e["request"], "result": None, "error": None,
                   "progress": None, "created": e.get("created", 0.0)}
            rfile = self._jfile(job_id, "result")
            efile = self._jfile(job_id, "error")
            if rfile.exists():
                with open(rfile) as f:
                    job["result"] = json.load(f)
                job["status"] = "done"
            elif efile.exists():
                with open(efile) as f:
                    job["error"] = json.load(f).get("error", "unknown")
                job["status"] = "error"
            else:
                self._queue.append(job)
            self.jobs[job_id] = job
            self._order.append(job_id)

    def submit(self, request: dict) -> dict:
        kind = request.pop("kind", "v2v" if "video" in request else None)
        if kind is None:
            kind = "img2vid" if "image" in request else "t2v"
        if kind not in self.services:
            raise KeyError(f"no service for kind={kind!r}")
        job_id = uuid.uuid4().hex[:16]
        job = {"id": job_id, "kind": kind, "status": "queued",
               "request": request, "result": None, "error": None,
               "progress": None, "created": time.time()}
        if self.journal_dir is not None:
            self._atomic_json(
                self._jfile(job_id, "request"),
                {"id": job_id, "kind": kind, "request": request,
                 "created": job["created"]},
            )
        with self._cv:
            self.jobs[job_id] = job
            self._order.append(job_id)
            while len(self._order) > self.MAX_JOBS:
                old = self._order.pop(0)
                if self.jobs.get(old, {}).get("status") in ("done", "error"):
                    self.jobs.pop(old, None)
                    self._evict_journal(old)
                else:  # never evict live jobs
                    self._order.append(old)
                    break
            self._queue.append(job)
            self._cv.notify()
        return {"job_id": job_id, "status": "queued"}

    def status(self, job_id: str) -> Optional[dict]:
        job = self.jobs.get(job_id)
        if job is None:
            return None
        out = {"job_id": job_id, "status": job["status"]}
        if job["progress"] is not None:
            step, total = job["progress"]
            out["progress"] = {"step": step, "total": total}
        if job["error"] is not None:
            out["error"] = job["error"]
        return out

    def result(self, job_id: str) -> Optional[dict]:
        job = self.jobs.get(job_id)
        if job is None or job["status"] != "done":
            return None
        return job["result"]

    def _drain(self):
        while True:
            with self._cv:
                while not self._queue:
                    self._cv.wait()
                job = self._queue.pop(0)
            job["status"] = "running"
            svc = self.services[job["kind"]]
            relay = getattr(svc.pipe, "progress_callback", None)
            is_relay = isinstance(relay, ProgressRelay)
            if is_relay:
                def _on(i, n, job=job):
                    job["progress"] = (i + 1, n)
                relay.target = _on
            try:
                job["result"] = svc.generate(dict(job["request"]))
                if job["progress"] is not None:
                    job["progress"] = (job["progress"][1],
                                       job["progress"][1])
                if self.journal_dir is not None:
                    # commit marker BEFORE the in-memory done flag: a crash
                    # between the two re-runs the job (harmless — seeded),
                    # never loses a result the client was told is done
                    self._atomic_json(self._jfile(job["id"], "result"),
                                      job["result"])
                job["status"] = "done"
            except Exception as e:  # noqa: BLE001 — surfaced via status
                job["error"] = f"{type(e).__name__}: {e}"
                job["status"] = "error"
                if self.journal_dir is not None:
                    self._atomic_json(self._jfile(job["id"], "error"),
                                      {"error": job["error"]})
            finally:
                if is_relay:
                    relay.target = None


class GenerationServer:
    """HTTP front: ``service`` answers POST /generate and /v2v and runs
    the jobs; the optional ``img2vid_service`` answers POST /img2vid (SVD;
    404 without one, as vdx's server) and its jobs, under the same device
    lock; ``journal_dir`` gives the job manager its journal."""

    def __init__(self, service: GenerationService, host: str = "127.0.0.1",
                 port: int = 8080, journal_dir=None,
                 img2vid_service: Optional[Img2VidService] = None):
        self.service = service
        svc = service
        i2v = img2vid_service
        kinds = {"t2v": svc, "v2v": svc}
        if i2v is not None:
            # one request's work on the card at a time across both
            if i2v.device_lock is not svc.device_lock:
                raise ValueError("build the img2vid service with "
                                 "lock=service.device_lock: both run on "
                                 "one card")
            kinds["img2vid"] = i2v
        self.jobs = JobManager(kinds, journal_dir=journal_dir)
        jobs = self.jobs

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/jobs/"):
                    parts = self.path.strip("/").split("/")
                    # jobs/<id> | jobs/<id>/result
                    if len(parts) == 2:
                        st = jobs.status(parts[1])
                        if st is None:
                            self._reply(404, {"error": "unknown job"})
                        else:
                            self._reply(200, st)
                    elif len(parts) == 3 and parts[2] == "result":
                        res = jobs.result(parts[1])
                        if res is None:
                            st = jobs.status(parts[1])
                            if st is None:
                                self._reply(404, {"error": "unknown job"})
                            else:
                                self._reply(409, {"error": "not done",
                                                  **st})
                        else:
                            self._reply(200, res)
                    else:
                        self._reply(404, {"error": "not found"})
                elif self.path == "/healthz":
                    h = svc.health()
                    if i2v is not None:
                        h["img2vid"] = {k: v for k, v in i2v.health().items()
                                        if k in ("requests_served",
                                                 "avg_seconds")}
                    self._reply(200, h)
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                if self.path == "/jobs":
                    try:
                        n = int(self.headers.get("Content-Length", 0))
                        request = json.loads(self.rfile.read(n))
                        self._reply(202, jobs.submit(request))
                    except Exception as e:  # noqa: BLE001
                        self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                if self.path in ("/generate", "/v2v"):
                    target = svc
                elif self.path == "/img2vid" and i2v is not None:
                    target = i2v
                else:
                    self._reply(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    request = json.loads(self.rfile.read(n))
                    if self.path == "/v2v" and "video" not in request:
                        self._reply(
                            400,
                            {"error": "/v2v requires a 'video' field "
                                      "(list of base64 PNG frames)"},
                        )
                        return
                    self._reply(200, target.generate(request))
                except Exception as e:  # noqa: BLE001 — error surface to client
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
