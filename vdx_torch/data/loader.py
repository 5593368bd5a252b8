"""Training data: video clips from frame folders -> batched tensors on the
card (port of vdx/data/loader.py).

* :class:`FrameFolderDataset` finds the videos (every subdirectory of the
  root with a ``frames/`` folder, the grid-search artifact layout, or with
  PNG frames of its own) and loads clips of ``clip_frames`` consecutive
  frames, decoded with ``io.png.decode_png`` and resized with
  ``ops.resize.resize_bilinear_u8`` (Pillow's BILINEAR, ported: the
  card's machine has no Pillow), as float32 in [-1, 1].
* :class:`VideoClipLoader` yields {"pixels": [B, F, H, W, 3]} batches of
  one static shape in vdx's seeded order (numpy's ``default_rng(seed)``
  permutation of the (video, start) index), decoding on a thread pool.
* :func:`prefetch_to_device` copies batches from pinned host memory to an
  explicit device with ``non_blocking`` on a background thread, so the
  copy overlaps the train step; with a ``sharding`` (parallel/mesh.py)
  each batch arrives laid out on the mesh as DTensors, each rank holding
  only its shard (vdx's ``device_put`` with a NamedSharding).
* :func:`encode_clips_to_latents` folds frames into the batch for the VAE
  encoder and restores the video layout.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, List, Optional, Union

import numpy as np
import torch

from vdx_torch.io.png import decode_png
from vdx_torch.ops.resize import resize_bilinear_u8


class FrameFolderDataset:
    """Clips from directories of PNG frames: every subdirectory of
    ``root`` holding a ``frames/`` folder, or ``frame_*.png`` (else any
    ``*.png``) itself, is one video when it has at least ``clip_frames``
    frames; ``size`` = (H, W) resizes, None keeps the native size."""

    def __init__(self, root, clip_frames: int = 8, size: Optional[tuple] = None):
        self.root = Path(root)
        self.clip_frames = clip_frames
        self.size = size
        self.videos: List[List[Path]] = []
        for d in sorted(self.root.iterdir()) if self.root.is_dir() else []:
            fdir = d / "frames" if (d / "frames").is_dir() else d
            if fdir.is_dir():
                frames = sorted(fdir.glob("frame_*.png")) or sorted(
                    fdir.glob("*.png"))
                if len(frames) >= clip_frames:
                    self.videos.append(frames)

    def __len__(self) -> int:
        return len(self.videos)

    def num_clips(self) -> int:
        return sum(len(v) - self.clip_frames + 1 for v in self.videos)

    def load_clip(self, video_idx: int, start: int) -> np.ndarray:
        """-> [F, H, W, 3] float32 in [-1, 1]."""
        frames = []
        for p in self.videos[video_idx][start:start + self.clip_frames]:
            img = decode_png(p.read_bytes())
            if self.size is not None:
                img = resize_bilinear_u8(img, self.size[1], self.size[0])
            frames.append(img.astype(np.float32) / 127.5 - 1.0)
        return np.stack(frames)


class VideoClipLoader:
    """Shuffled, batched, background-decoded clips: yields {"pixels":
    [B, F, H, W, 3] float32} in the order of ``default_rng(seed)``'s
    permutation of every (video, start); ``drop_last`` drops a short
    final batch."""

    def __init__(self, dataset: FrameFolderDataset, batch_size: int,
                 seed: int = 0, drop_last: bool = True, num_workers: int = 2):
        if len(dataset) == 0:
            raise ValueError("empty dataset: no video with enough frames")
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers

    def _index(self) -> List[tuple]:
        return [(vi, s) for vi, frames in enumerate(self.dataset.videos)
                for s in range(len(frames) - self.dataset.clip_frames + 1)]

    def __iter__(self) -> Iterator[dict]:
        idx = self._index()
        order = np.random.default_rng(self.seed).permutation(len(idx))
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for start in range(0, len(order), self.batch_size):
                sel = order[start:start + self.batch_size]
                if len(sel) < self.batch_size and self.drop_last:
                    return
                clips = list(pool.map(
                    lambda i: self.dataset.load_clip(*idx[i]), sel))
                yield {"pixels": np.stack(clips)}


def prefetch_to_device(iterator, device: Union[str, torch.device, None] = None,
                       size: int = 2, sharding=None) -> Iterator[dict]:
    """Batches of ``iterator`` (dicts of arrays or tensors) on ``device``,
    up to ``size`` ahead of the consumer: a background thread pins each
    host array (on a CUDA device) and copies it with ``non_blocking``.
    ``sharding``: a ``Sharding`` for every key, or {key: Sharding}; each
    array becomes a DTensor of its global shape whose local part is this
    rank's shard on the mesh's device (``mesh.place``: each rank cuts its
    own slice of the batch every rank loaded, with no communication, so
    the thread runs no collective). An exception in the producer is raised
    to the consumer."""
    if sharding is None and device is None:
        raise ValueError("prefetch_to_device needs a device or a sharding")
    if sharding is not None:
        from vdx_torch.parallel.mesh import place
    else:
        device = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()

    def put(batch):
        out = {}
        for k, v in batch.items():
            if sharding is not None:
                sh = sharding[k] if isinstance(sharding, dict) else sharding
                out[k] = place(v, sh, device)
                continue
            t = torch.as_tensor(v)
            if device.type == "cuda":
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=True)
        return out

    def producer():
        try:
            for batch in iterator:
                q.put(put(batch))
        except BaseException as e:  # handed to the consumer, re-raised there
            q.put(e)
            return
        q.put(end)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def encode_clips_to_latents(vae, pixels,
                            generator: Optional[torch.Generator] = None
                            ) -> torch.Tensor:
    """[B, F, H, W, 3] pixels in [-1, 1] -> [B, F, h, w, C] pre-scaled
    latents: frames folded into the batch for ``vae.encode`` (the
    posterior mean, or a sample with ``generator``), on the VAE's device,
    without a graph."""
    device = next(vae.parameters()).device
    x = torch.as_tensor(pixels).to(device)
    B, F_ = x.shape[:2]
    with torch.no_grad():
        lat = vae.encode(x.reshape((B * F_,) + tuple(x.shape[2:])), generator)
    return lat.reshape((B, F_) + tuple(lat.shape[1:]))
