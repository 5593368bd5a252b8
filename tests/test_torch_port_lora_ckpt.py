"""The port's LoRA adapters and checkpoints against vdx's, on the CPU (fp32,
tiny configs), and its .safetensors reader and writer against the
``safetensors`` package.

* LoRA: the same rank-4 adapter, written in the peft, old diffusers
  processor and kohya (alpha 2) key formats by the port's writer, goes
  through vdx's ``load_lora`` and the port's at scale 0.8. Every UNet
  weight of the two, carried through the rule tables, is equal bit for
  bit where no adapter reaches it, and within 2 fp32 ulps of the
  magnitudes entering the sum (|W| + s |B| |A| alpha / r) where one
  does: both
  merge in fp32, ``a`` pre-scaled by alpha / r in numpy as vdx, but XLA
  sums the rank-4 product in another order than torch and contracts the
  add into an FMA (measured on these factors: about half the delta
  elements bit-equal, the rest about 1 ulp apart). The reports are
  equal. ``set_lora_scale(0)`` equals the pristine weights and
  ``unload_lora`` restores them bit for bit; ``init_lora`` draws vdx's
  adapter from one seed; strict rejects unused LoRA keys in both.
* Checkpoints: an SD-1.5-style split (the UNet file without its motion
  keys in fp32, the motion adapter in fp16, the VAE and the text
  tower) through vdx's and the port's ``load_pretrained``: weights equal
  through the rule tables, reports equal string for string, and the
  same errors with the same messages. ``save_checkpoint`` /
  ``load_checkpoint`` round-trips bit for bit.
"""

import numpy as np
import pytest
import torch

from test_torch_port_requests import load_from_vdx, tiny_port, vdx_params
from vdx.core import convert as VC
from vdx.core import lora as JL
from vdx.core.dtypes import FP32_POLICY as JP
from vdx.models.clip_text import CLIPTextConfig as JCC
from vdx.models.unet_motion import UNetMotionConfig as JUC
from vdx.models.vae import VAEConfig as JVC
from vdx.pipelines import AnimateDiffPipeline as JPipe
from vdx_torch.core import lora as TL
from vdx_torch.core import safetensors_io as sio
from vdx_torch.core.dtypes import FP32_POLICY as TP
from vdx_torch.models.clip_text import CLIPTextConfig as TCC
from vdx_torch.models.unet_motion import UNetMotionConfig as TUC
from vdx_torch.models.vae import VAEConfig as TVC
from vdx_torch.pipelines import AnimateDiffPipeline as TPipe


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


RANK, ALPHA, SCALE = 4, 2.0, 0.8
RULES = {"unet": VC.unet_motion_rules(JUC.tiny()), "vae": VC.vae_rules(JVC.tiny()),
         "text": VC.clip_text_rules(JCC.tiny())}


def jpipe_with(params, **kw):
    return JPipe(unet_config=JUC.tiny(), vae_config=JVC.tiny(),
                 text_config=JCC.tiny(), policy=JP, scheduler="ddim",
                 params=params, **kw)


def assert_same_weights(jparams, tpipe, components=("unet", "vae", "text"),
                        merged=None):
    """Every weight of vdx's trees, carried to the port's layout by vdx's
    rules, equals the port's bit for bit; ``merged`` = {port key: |W| +
    |s * delta| in the port's layout} gives the LoRA sites and their
    2-ulp scale (the rank-4 product's terms may cancel, so its rounding
    scales with the sum of their magnitudes)."""
    modules = {"unet": tpipe.unet, "vae": tpipe.vae, "text": tpipe.text_encoder}
    for comp in components:
        sd = modules[comp].state_dict()
        flat = VC.flatten_params(jparams[comp])
        assert len(flat) == len(sd)
        for path, leaf in flat.items():
            hf, tr = RULES[comp][path]
            want = np.asarray(leaf)
            got = tr(sd[hf].numpy())
            assert got.dtype == want.dtype, (comp, path)
            if merged and hf in merged:
                tol = 2 * np.spacing(tr(merged[hf]).astype(np.float32))
                assert (np.abs(got - want) <= tol).all(), (comp, path)
            else:
                assert np.array_equal(got, want), (comp, path)


@pytest.fixture(scope="module")
def weights():
    seed_pipe = tiny_port()
    seed_pipe.init_params(0)
    return dict(pipe=seed_pipe, params=vdx_params(seed_pipe))


def lora_factors(tpipe):
    """{target key: (A [r, in], B [out, r])}, seeded, over every default
    target of the tiny UNet."""
    r = np.random.default_rng(7)
    sd = tpipe.unet.state_dict()
    out = {}
    for k in TL.target_paths(sd):
        d_out, d_in = sd[k].shape
        out[k] = (r.standard_normal((RANK, d_in)).astype(np.float32) / 4,
                  r.standard_normal((d_out, RANK)).astype(np.float32) / 4)
    return out


def lora_file(factors, fmt, path):
    sd = {}
    for k, (A, B) in factors.items():
        stem = k[: -len(".weight")]
        if fmt == "peft":
            sd[f"unet.{stem}.lora_A.weight"] = A
            sd[f"unet.{stem}.lora_B.weight"] = B
        elif fmt == "processor":
            parent, proj = stem.rsplit(".", 1)
            if proj == "0":  # to_out.0
                parent, proj = parent.rsplit(".", 1)
            sd[f"{parent}.processor.{proj}_lora.down.weight"] = A
            sd[f"{parent}.processor.{proj}_lora.up.weight"] = B
        else:
            m = "lora_unet_" + stem.replace(".", "_")
            sd[f"{m}.lora_down.weight"] = A
            sd[f"{m}.lora_up.weight"] = B
            sd[f"{m}.alpha"] = np.float32(ALPHA)
    sio.save_file({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}, path)
    return sd


def merge_scale(pristine, factors, alpha_over_r):
    """{key: |W| + s * |B| @ |A| * alpha / r}, the magnitudes entering the
    merged sum, in the port's [out, in] layout."""
    return {k: np.abs(pristine[k].numpy()) + (SCALE * alpha_over_r * (
        np.abs(B).astype(np.float64) @ np.abs(A))).astype(np.float32)
        for k, (A, B) in factors.items()}


def test_lora_matches_vdx(weights, tmp_path):
    factors = lora_factors(weights["pipe"])
    rules = RULES["unet"]
    to_hf = {p: hf for p, (hf, _) in rules.items()}
    for fmt in ("peft", "processor", "kohya"):
        path = tmp_path / f"{fmt}.safetensors"
        lora_file(factors, fmt, path)
        jpipe = jpipe_with(weights["params"])
        tp = load_from_vdx(tiny_port(), weights["params"])
        pristine = {k: v.clone() for k, v in tp.unet.state_dict().items()}
        j_rep = jpipe.load_lora(str(path), scale=SCALE)
        t_rep = tp.load_lora(path, scale=SCALE)
        assert [to_hf[p] for p in j_rep["converted"]] == t_rep["converted"]
        assert len(t_rep["converted"]) == len(factors)
        assert j_rep["skipped"] == t_rep["skipped"] == []
        assert j_rep["shape_errors"] == t_rep["shape_errors"] == []
        assert j_rep["unused_lora_keys"] == t_rep["unused_lora_keys"] == []
        scales = merge_scale(pristine, factors, ALPHA / RANK if fmt == "kohya" else 1.0)
        assert_same_weights(jpipe.params, tp, ("unet",), scales)
        changed = [k for k, v in tp.unet.state_dict().items()
                   if not torch.equal(v, pristine[k])]
        assert sorted(changed) == sorted(factors), fmt
        tp.set_lora_scale(0.0)
        for k, v in tp.unet.state_dict().items():
            assert torch.equal(v, pristine[k]), k
        tp.set_lora_scale(SCALE)
        jpipe.unload_lora()
        tp.unload_lora()
        for k, v in tp.unet.state_dict().items():
            assert v.numpy().tobytes() == pristine[k].numpy().tobytes(), k
        assert_same_weights(jpipe.params, tp, ("unet",))
    # strict: a LoRA key no site uses raises in both; lenient reports it
    sd = lora_file(factors, "peft", tmp_path / "extra.safetensors")
    sd["unet.nowhere.lora_A.weight"] = np.zeros((RANK, 3), np.float32)
    for pipe in (jpipe_with(weights["params"]), tiny_port()):
        with pytest.raises(ValueError, match="matched no target site"):
            pipe.load_lora(dict(sd))
    j_rep = jpipe_with(weights["params"]).load_lora(dict(sd), strict=False)
    t_rep = load_from_vdx(tiny_port(), weights["params"]).load_lora(
        {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, strict=False)
    assert j_rep["unused_lora_keys"] == t_rep["unused_lora_keys"] \
        == ["nowhere.lora_A.weight"]
    for pipe in (jpipe_with(weights["params"]), tiny_port()):
        with pytest.raises(ValueError, match="no LoRA active"):
            pipe.unload_lora()
    # init_lora: the same a from one seed, in vdx's site order
    j_tree = JL.init_lora(weights["params"]["unet"], rank=RANK, seed=5)
    t_tree = TL.init_lora(weights["pipe"].unet.state_dict(), rank=RANK, seed=5,
                          rules=rules)
    assert [to_hf[p] for p in j_tree] == list(t_tree)
    for p, site in j_tree.items():
        assert np.array_equal(t_tree[to_hf[p]]["a"].numpy(), np.asarray(site["a"]))
        assert not t_tree[to_hf[p]]["b"].any()
    tp = load_from_vdx(tiny_port(), weights["params"])
    assert tp.load_lora(t_tree) is None  # b = 0: an exact no-op
    assert_same_weights(weights["params"], tp, ("unet",))


def write_split(pipe, path):
    """diffusers-named files: the UNet without its motion keys (fp32), the
    motion adapter (fp16), the VAE and the text tower."""
    unet = pipe.unet.state_dict()
    motion = {k: v.half() for k, v in unet.items() if ".motion_modules." in k}
    files = {"unet": path / "unet.safetensors", "motion": path / "motion.safetensors",
             "vae": path / "vae.safetensors", "text": path / "text.safetensors"}
    sio.save_file({k: v for k, v in unet.items() if k not in motion}, files["unet"])
    sio.save_file(motion, files["motion"])
    sio.save_file(pipe.vae.state_dict(), files["vae"])
    sio.save_file(pipe.text_encoder.state_dict(), files["text"])
    return {k: str(v) for k, v in files.items()}


def port_from(sources, strict=True):
    return TPipe.from_pretrained(
        sources, strict=strict, unet_config=TUC.tiny(), vae_config=TVC.tiny(),
        text_config=TCC.tiny(), policy=TP, scheduler="ddim", device="cpu")


def same_error(vdx_call, port_call):
    with pytest.raises(ValueError) as want:
        vdx_call()
    with pytest.raises(ValueError) as got:
        port_call()
    assert str(got.value) == str(want.value)


def test_checkpoints_match_vdx(weights, tmp_path):
    files = write_split(weights["pipe"], tmp_path)
    sources = {"unet": [files["unet"], files["motion"]], "vae": files["vae"],
               "text": files["text"]}
    # vdx's pipelines start from the same weights (vdx would otherwise
    # trace its init): strict loads overwrite every one
    jpipe = jpipe_with(weights["params"])
    j_rep = jpipe.load_pretrained(sources)
    tp = port_from(sources)
    t_rep = tp.load_pretrained(sources)
    assert t_rep == j_rep
    assert all(not r["missing"] and not r["shape_errors"]
               and not r["unused_checkpoint_keys"] for r in t_rep.values())
    # the fp16 motion file is cast to the fp32 parameters on both sides
    motion = {k: v.float() for k, v in weights["pipe"].unet.state_dict().items()
              if ".motion_modules." in k}
    half = {k: v.half().float() for k, v in motion.items()}
    assert any(not torch.equal(half[k], motion[k]) for k in motion)
    assert all(torch.equal(tp.unet.state_dict()[k], half[k]) for k in motion)
    assert_same_weights(jpipe.params, tp)
    # errors: unknown and missing components, overlapping files, a bad shape
    same_error(lambda: jpipe.load_pretrained(dict(sources, clip=files["text"])),
               lambda: tp.load_pretrained(dict(sources, clip=files["text"])))
    same_error(lambda: jpipe.load_pretrained({"unet": sources["unet"]}),
               lambda: tp.load_pretrained({"unet": sources["unet"]}))
    same_error(lambda: jpipe.load_pretrained(dict(sources, vae=[files["vae"]] * 2)),
               lambda: tp.load_pretrained(dict(sources, vae=[files["vae"]] * 2)))
    bad = sio.load_file(files["text"])
    bad["text_model.encoder.layers.0.mlp.fc1.weight"] = torch.zeros(3, 5)
    bad["text_model.extra"] = torch.zeros(2)
    same_error(lambda: jpipe.load_pretrained(dict(sources, text=bad)),
               lambda: tp.load_pretrained(dict(sources, text=bad)))
    # lenient: the UNet file without the motion adapter, a text tower with a
    # bad shape and an extra key; reports equal string for string
    lenient = {"unet": files["unet"], "text": bad}
    j_rep = jpipe_with(weights["params"]).load_pretrained(lenient, strict=False)
    t_rep = port_from(lenient, strict=False).load_pretrained(lenient, strict=False)
    assert t_rep == j_rep
    assert t_rep["unet"]["missing"] and t_rep["text"]["shape_errors"]
    assert t_rep["text"]["unused_checkpoint_keys"] == ["text_model.extra"]
    # the port's own checkpoint directory: save, load, bit for bit
    tp.save_checkpoint(tmp_path / "ckpt")
    back = tiny_port()
    back.load_checkpoint(tmp_path / "ckpt")
    for a, b in ((tp.unet, back.unet), (tp.vae, back.vae),
                 (tp.text_encoder, back.text_encoder)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    with pytest.raises(RuntimeError, match="size mismatch"):
        TPipe(unet_config=TUC(block_out_channels=(32, 64, 64, 128),
                              layers_per_block=1, cross_attention_dim=64,
                              attention_heads=2, motion_heads=2),
              vae_config=TVC.tiny(), text_config=TCC.tiny(), policy=TP,
              device="cpu").load_checkpoint(tmp_path / "ckpt")


def test_safetensors_io_against_the_package(tmp_path):
    from safetensors.torch import load_file, save_file

    r = np.random.default_rng(1)
    tensors = {
        "f32": torch.from_numpy(r.standard_normal((3, 5)).astype(np.float32)),
        "f16": torch.from_numpy(r.standard_normal((7,)).astype(np.float16)),
        "bf16": torch.from_numpy(r.standard_normal((2, 3, 4)).astype(np.float32)
                                 ).to(torch.bfloat16),
        "i64": torch.arange(6, dtype=torch.int64).reshape(2, 3),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros((0, 4)),
        "strided": torch.arange(12.0).reshape(3, 4).T,
    }
    meta = {"format": "pt", "note": "x"}
    ours, theirs = tmp_path / "ours.safetensors", tmp_path / "theirs.safetensors"
    sio.save_file(tensors, ours, metadata=meta)
    save_file({k: v.contiguous() for k, v in tensors.items()}, str(theirs),
              metadata=meta)
    for read in (load_file(str(ours)), sio.load_file(theirs), sio.load_file(ours)):
        assert read.keys() == tensors.keys()
        for k, v in tensors.items():
            assert read[k].dtype == v.dtype and read[k].shape == v.shape, k
            assert torch.equal(read[k], v), k
    assert sio.read_header(ours)[1] == meta == sio.read_header(theirs)[1]
    # a file whose offsets leave a gap is refused, as the package refuses it
    raw = bytearray(ours.read_bytes())
    (n,) = np.frombuffer(bytes(raw[:8]), "<u8")
    head = raw[8:8 + int(n)].decode().replace('"data_offsets":[0,', '"data_offsets":[1,', 1)
    (tmp_path / "bad.safetensors").write_bytes(bytes(raw[:8]) + head.encode()
                                               + bytes(raw[8 + int(n):]))
    with pytest.raises(ValueError):
        sio.load_file(tmp_path / "bad.safetensors")
