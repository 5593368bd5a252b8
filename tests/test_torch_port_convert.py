"""Round trip of the port's weight converter against vdx's.

vdx parameters (numpy, seeded, laid out by vdx's own init shapes) go
through vdx_torch.core.convert.params_from_jax into the port's
diffusers-named state_dict and back through vdx.core.convert's
``convert_checkpoint``; the result must equal the original tree leaf for
leaf (unet, the VAE decoder, text). This holds the port's copied rule
tables to the reference's. The port modules' own state_dicts must have
exactly the converter's keys and shapes.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from vdx.core import convert as VC
from vdx.models.clip_text import CLIPTextConfig as JCC
from vdx.models.clip_text import CLIPTextModel as JC
from vdx.models.unet_motion import UNetMotion as JU
from vdx.models.unet_motion import UNetMotionConfig as JUC
from vdx.models.vae import AutoencoderKL as JV
from vdx.models.vae import VAEConfig as JVC
from vdx_torch.core.convert import flatten_params, params_from_jax
from vdx_torch.core.dtypes import FP32_POLICY as TP
from vdx_torch.models.clip_text import CLIPTextConfig as TCC
from vdx_torch.models.clip_text import CLIPTextModel as TC
from vdx_torch.models.unet_motion import UNetMotion as TU
from vdx_torch.models.unet_motion import UNetMotionConfig as TUC
from vdx_torch.models.vae import AutoencoderKL as TV
from vdx_torch.models.vae import VAEConfig as TVC


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file's tests run (the suite runs several
    workers side by side); restored afterwards for other files."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _template(component):
    """vdx's eval_shape parameter template and rules (traced once per
    component for the whole module)."""
    z = np.zeros
    if component == "unet":
        m = JU(JUC.tiny())
        args = (z((1, 2, 8, 8, 4), np.float32), z((1,), np.int32),
                z((1, 7, 64), np.float32))
        rules = VC.unet_motion_rules(JUC.tiny())
    elif component == "vae":
        m = JV(JVC.tiny())
        args = (z((1, 64, 64, 3), np.float32),)
        rules = VC.vae_rules(JVC.tiny())
    else:
        m = JC(JCC.tiny())
        args = (z((1, 77), np.int32),)
        rules = VC.clip_text_rules(JCC.tiny())
    return jax.eval_shape(m.init, jax.random.PRNGKey(0), *args), rules


PORT = {"unet": (TU, TUC, JUC), "vae": (TV, TVC, JVC), "text": (TC, TCC, JCC)}


def _check_round_trip(component):
    template, rules = _template(component)
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), template)
    flat = flatten_params(tree)  # the port's own flattener
    assert flat.keys() == VC.flatten_params(tree).keys()
    state = params_from_jax(flat, component, PORT[component][2].tiny())
    sd = {k: v.numpy() for k, v in state.items()}
    params, report = VC.convert_checkpoint(sd, template, rules, strict=False)
    assert not report["shape_errors"] and not report["unused_checkpoint_keys"]
    back = VC.flatten_params(params)
    # every leaf the port carries comes back bit for bit; only vdx's VAE
    # encoder (not ported yet) is left unconverted
    carried = [k for k in flat if not (component == "vae" and k.startswith("encoder/"))]
    assert len(carried) == len(sd)
    for k in carried:
        np.testing.assert_array_equal(np.asarray(back[k]), flat[k], err_msg=k)
    missing = [m for m in report["missing"] if "encoder/" not in m]
    assert not missing, missing[:5]


def _check_module_keys(component):
    template, _ = _template(component)
    flat = {k: np.zeros(s.shape, np.float32)
            for k, s in VC.flatten_params(template).items()}
    state = params_from_jax(flat, component, PORT[component][2].tiny())
    tcls, tcfg, _ = PORT[component]
    with torch.device("meta"):
        module = tcls(tcfg.tiny(), TP)
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state.items()}
    assert got == want


def _check_rejects_unknown_leaves():
    with pytest.raises(KeyError):
        params_from_jax({"conv_in/kernel": np.zeros((3, 3, 4, 32)),
                         "not_a_leaf": np.zeros(3)}, "unet", JUC.tiny())


# Two tests per file, each looping over its cases: pytest-xdist's loadfile
# mode hands out files with many tests first, and this file's few tests
# keep it behind the suite's heavy files.
def test_params_round_trip_through_vdx_converter():
    for component in ("unet", "vae", "text"):
        _check_round_trip(component)


def test_port_modules_have_the_converter_keys():
    for component in ("unet", "vae", "text"):
        _check_module_keys(component)
    _check_rejects_unknown_leaves()
