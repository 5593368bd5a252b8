"""vdx_torch.data and the training commands against vdx on the CPU.

1. The loader on Pillow-written PNG folders (two videos in the
   grid-search artifact layout, one bare folder, one too short): the same
   videos and clip counts as vdx.data's, the same clips in the same seeded
   order, pixels equal where no resize runs and within one uint8 level
   (1 / 127.5) where one does (vdx resizes with Pillow's BILINEAR, the
   port with its numpy port of it), the batches' static shape, and
   prefetch_to_device.
2. encode_clips_to_latents against vdx's (tiny VAE, fp32, vdx's side
   jitted at XLA optimisation level 0): within 2e-5.
3. ``vdx-torch train --tiny --device cpu`` for two steps, full and
   ``--lora 4``: the checkpoint directory and the adapter file load back
   into a pipeline and change its output; ``vdx-torch convert`` on a tiny
   diffusers-keyed ``.safetensors`` set (every tensor back equal) and on a
   peft LoRA file (the adapter equal to ``convert_lora_checkpoint``'s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_port_models import _compile_o0, _jax_params
from vdx.core import convert as VC
from vdx.core.dtypes import FP32_POLICY as JP
from vdx.data import FrameFolderDataset as JDS
from vdx.data import VideoClipLoader as JLoader
from vdx.data import encode_clips_to_latents as j_encode
from vdx.models.vae import AutoencoderKL as JVAE
from vdx.models.vae import VAEConfig as JVC
from vdx_torch import cli
from vdx_torch.core import lora as TL
from vdx_torch.core.dtypes import FP32_POLICY as TP
from vdx_torch.core.safetensors_io import load_file, save_file
from vdx_torch.data import (FrameFolderDataset, VideoClipLoader,
                            encode_clips_to_latents, prefetch_to_device)
from vdx_torch.models.clip_text import CLIPTextConfig as TCC
from vdx_torch.models.unet_motion import UNetMotionConfig as TUC
from vdx_torch.models.vae import AutoencoderKL as TVAE
from vdx_torch.models.vae import VAEConfig as TVC
from vdx_torch.pipelines import AnimateDiffPipeline as TPipe

LEVEL = 1 / 127.5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file's tests run (the suite runs several
    workers side by side); restored afterwards for other files."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def frame_root(tmp_path_factory):
    """Two artifact-layout videos (6 and 8 frames of 16x16), a bare
    folder (5 frames of 20x12) and a too-short one (2 frames)."""
    root = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(0)
    for name, n, hw, sub in (("exp_a", 6, (16, 16), "frames"),
                             ("exp_b", 8, (16, 16), "frames"),
                             ("bare_video", 5, (20, 12), ""),
                             ("short", 2, (16, 16), "")):
        d = root / name / sub if sub else root / name
        d.mkdir(parents=True)
        for i in range(n):
            arr = (rng.random(hw + (3,)) * 255).astype(np.uint8)
            Image.fromarray(arr).save(d / f"frame_{i:03d}.png")
    return root


def tiny_pipe(**kw):
    return TPipe(unet_config=TUC.tiny(), vae_config=TVC.tiny(),
                 text_config=TCC.tiny(), policy=TP, scheduler="ddim",
                 device="cpu", **kw)


def test_loader_matches_vdx(frame_root):
    for size in (None, (16, 16), (24, 20)):
        ours = FrameFolderDataset(frame_root, clip_frames=4, size=size)
        theirs = JDS(frame_root, clip_frames=4, size=size)
        assert ours.videos == theirs.videos and len(ours) == 3
        assert ours.num_clips() == theirs.num_clips() == 3 + 5 + 2
        if size is None:
            continue
        resized = [vi for vi, v in enumerate(ours.videos)
                   if Image.open(v[0]).size != (size[1], size[0])]
        for seed in (0, 3):
            got = list(VideoClipLoader(ours, batch_size=3, seed=seed,
                                       num_workers=2))
            want = list(JLoader(theirs, batch_size=3, seed=seed))
            assert len(got) == len(want) == 3  # 10 clips, the last 1 dropped
            for g, w in zip(got, want):
                assert g["pixels"].shape == (3, 4) + size + (3,)
                assert g["pixels"].dtype == np.float32
                d = np.abs(g["pixels"] - w["pixels"])
                assert d.max() <= LEVEL * (1 + 1e-6), d.max()
        # the clips themselves, one by one: equal where no resize ran
        order = np.random.default_rng(0).permutation(ours.num_clips())
        index = VideoClipLoader(ours, batch_size=1)._index()
        for i in order:
            vi, s = index[i]
            d = np.abs(ours.load_clip(vi, s) - theirs.load_clip(vi, s)).max()
            assert d <= (LEVEL * (1 + 1e-6) if vi in resized else 0.0), (vi, d)
    # prefetch: the same batches, as tensors on the device asked for
    loader = VideoClipLoader(FrameFolderDataset(frame_root, clip_frames=4,
                                                size=(16, 16)), batch_size=2)
    got = list(prefetch_to_device(iter(loader), "cpu"))
    want = list(loader)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g["pixels"].device.type == "cpu"
        np.testing.assert_array_equal(g["pixels"].numpy(), w["pixels"])
    with pytest.raises(ValueError):
        VideoClipLoader(FrameFolderDataset(frame_root, clip_frames=9),
                        batch_size=1)


def test_encode_clips_matches_vdx():
    tvae = TVAE(TVC.tiny(), TP)
    params = _jax_params(tvae, VC.vae_rules(JVC.tiny()), 4)
    from vdx_torch.core.convert import params_from_jax

    flat = {k: np.asarray(v) for k, v in VC.flatten_params(params).items()}
    tvae.load_state_dict(params_from_jax(flat, "vae", JVC.tiny()))
    jvae = JVAE(JVC.tiny(), policy=JP)
    pixels = np.random.default_rng(1).uniform(
        -1, 1, (2, 3, 32, 32, 3)).astype(np.float32)
    run = _compile_o0(lambda p, x: j_encode(jvae, p, x), params, pixels)
    want = np.asarray(run(params, pixels))
    got = encode_clips_to_latents(tvae, pixels)
    assert got.shape == want.shape == (2, 3, 4, 4, 4)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_train_and_convert_commands(frame_root, tmp_path, capsys):
    base = dict(num_frames=4, height=64, width=64, num_inference_steps=2,
                seed=5, output_type="latent")
    pipe = tiny_pipe()
    pipe.init_params(0)
    before = pipe("portrait", **base).latents
    common = ["--data", str(frame_root), "--tiny", "--device", "cpu",
              "--steps", "2", "--warmup", "1", "--size", "64",
              "--clip-frames", "4", "--batch", "2", "--lr", "1e-2",
              "--log-every", "1"]
    out = tmp_path / "full"
    assert cli.main(["train", *common, "--accum", "2", "--remat",
                     "--ema", "0.9", "--out", str(out)]) == 0
    losses = [float(line.split()[-1]) for line in capsys.readouterr().out
              .splitlines() if line.startswith("step ")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    trained = tiny_pipe()
    trained.load_checkpoint(out / "checkpoint")
    after = trained("portrait", **base).latents
    assert torch.isfinite(after).all() and not torch.equal(after, before)
    ema = load_file(out / "ema" / "unet.safetensors")
    assert set(ema) == set(trained.unet.state_dict())

    out = tmp_path / "lora"
    assert cli.main(["train", *common, "--lora", "4", "--out", str(out)]) == 0
    adapted = tiny_pipe()
    adapted.init_params(0)
    adapted.load_lora(str(out / "lora.safetensors"))
    lora_after = adapted("portrait", **base).latents
    assert torch.isfinite(lora_after).all()
    assert not torch.equal(lora_after, before)
    adapted.unload_lora()
    assert torch.equal(adapted("portrait", **base).latents, before)

    # convert: diffusers-keyed files -> the port's checkpoint directory
    src = tiny_pipe()
    src.init_params(3)
    paths = []
    for name, module in src._components().items():
        path = tmp_path / f"{name}.safetensors"
        save_file(module.state_dict(), path)
        paths += ["--src", f"{name}={path}"]
    assert cli.main(["convert", "--family", "animatediff", "--tiny",
                     "--dtype", "fp32", "--device", "cpu", *paths,
                     "--out", str(tmp_path / "converted")]) == 0
    back = tiny_pipe()
    back.load_checkpoint(tmp_path / "converted")
    for name, module in src._components().items():
        got = back._components()[name].state_dict()
        assert all(torch.equal(got[k], v) for k, v in module.state_dict().items())
    # a peft LoRA file -> the port's adapter file
    sd = src.unet.state_dict()
    sites = TL.target_paths(sd)[:3]
    r = np.random.default_rng(2)
    peft = {}
    for p in sites:
        d_out, d_in = sd[p].shape
        stem = p[:-len(".weight")]
        peft[f"{stem}.lora_A.weight"] = r.standard_normal((2, d_in)).astype(np.float32)
        peft[f"{stem}.lora_B.weight"] = r.standard_normal((d_out, 2)).astype(np.float32)
    save_file(peft, tmp_path / "peft.safetensors")
    assert cli.main(["convert", "--family", "animatediff", "--tiny",
                     "--device", "cpu", "--lora",
                     f"unet={tmp_path / 'peft.safetensors'}",
                     "--lora-out", str(tmp_path / "adapter.safetensors")]) == 0
    want, _ = TL.convert_lora_checkpoint(peft, sd, rules=src._conversion_rules()["unet"][0])
    got, _ = TL.convert_lora_checkpoint(load_file(tmp_path / "adapter.safetensors"),
                                        sd, rules=src._conversion_rules()["unet"][0])
    assert list(got) == list(want) == sites
    for p in sites:
        for w in ("a", "b"):
            torch.testing.assert_close(got[p][w], want[p][w], rtol=0, atol=0)
    assert "3 sites converted" in capsys.readouterr().out
