"""vdx_torch's CUDA kernels (K1, K4, and K1', K5: flash attention in
every other ``exp_impl`` form, on the wgmma + TMA pipeline and on the
template where the routing rule sends them; K2, K3: GroupNorm; K6-K9:
temporal attention) against their plain PyTorch versions, on the card, the fp32
policy's TF32 scope in a forward on the card, plus an import-hygiene
check that runs everywhere.

The kernel tests skip without a GPU. On the card they run with

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_port_kernels_cuda.py -q

(``--noconftest``: the repo's conftest imports jax, which the GPU machine
does not have). Tolerance for bf16 outputs: one bf16 ulp at the largest
reference magnitude, 2^-7 * max(1, max|ref|) — both sides compute in fp32
and round once to bf16, so a different fp32 summation order can flip the
last bit of an element, no more. fp32 outputs: 1e-4 absolute on O(1)
values (fp32 sums of up to 10^5 terms in different orders). K4's
running max rescales acc and l tile by tile where the plain version takes
one max over the row: the same function up to fp32 rounding, and p is
rounded to bf16 after the rescale in the kernel but before it in the
plain version, which moves each weight by under 2^-9 relative, averaging
out far below one output ulp. The same holds for the exp and exp2 forms
(the kernel rescales per key tile, vdx and the plain version per key
block); fastexp2 and noexp rescale per key block in the kernel too, since
their outputs depend on it. mxu_only does not normalise, so its fp32 bar
scales with max|plain| (1e-4 per unit of output). noexp's bf16 bar has
no floor at 1 (padded keys shrink its outputs to about 1e-30), and its l
may nearly cancel, so in fp32 it is held to its recurrence in float64
(kernels.flash_attention.plain_err_tol, which chip_smoke.py uses too).
"""

import ast
import math
import pathlib
from functools import partial

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file's tests run (the suite runs several
    workers side by side); restored afterwards for other files."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (see the module docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(ref: torch.Tensor) -> float:
    if ref.dtype == torch.bfloat16:
        return 2.0 ** -7 * max(1.0, ref.float().abs().max().item())
    return 1e-4


def _randn(shape, gen, device, dtype=torch.bfloat16, mean=0.0):
    return (torch.randn(shape, generator=gen, device=device) + mean).to(dtype)


# K1 (staticmax on the wgmma + TMA kernel) at each of its instances
# (DP = 48, 80, 128, 160, 256): ragged Sq and Skv tails, Skv under one key
# tile
K1_CASES = [(2, 512, 512, 2, 40),
            (1, 300, 577, 3, 80),   # ragged Sq and Skv tails
            (2, 129, 1000, 2, 64),
            (1, 64, 70, 1, 8),
            (1, 100, 200, 2, 120),
            (2, 300, 333, 3, 160),
            (1, 200, 50, 2, 128),   # Skv under one 64-key tile
            (1, 64, 100, 2, 40),    # Skv under one 128-key tile
            (1, 300, 333, 2, 168),  # DP = 256: one consumer warpgroup
            (2, 129, 577, 2, 200),
            (1, 200, 700, 2, 256),
            (1, 65, 50, 1, 256)]    # Skv under one 64-key tile
# K4 on the wgmma + TMA kernel (D % 8 == 0, D <= 256) and, at D % 8 != 0,
# on the mma.sync template ("K4 template")
K4_CASES = [(32, 576, 576, 8, 160),   # 768x768 level-2 self-attention
            (2, 1000, 1000, 2, 160),  # multi-tile Skv, ragged tail
            (2, 300, 333, 3, 40),     # DP = 48
            (1, 129, 70, 2, 80),      # DP = 80, Skv under one tile
            (1, 200, 333, 3, 128),    # DP = 128
            (1, 300, 300, 2, 20),     # template: D % 8 != 0, element loads
            (1, 129, 700, 2, 256),    # DP = 256
            (2, 65, 64, 1, 200),      # DP = 256, Skv a single tile
            (1, 300, 333, 3, 168),    # DP = 256
            (1, 100, 300, 2, 250)]    # template: D % 8 != 0 past 160
FP32_CASES = [("K1", 2, 300, 300, 2, 40),
              ("K1", 1, 100, 531, 2, 120),
              ("K4", 2, 300, 300, 2, 160),
              ("K4", 1, 100, 200, 2, 20),
              ("K4", 1, 129, 70, 1, 256)]
# Each GN case runs on K2 (where a cluster holds its stripe) and on K3, in
# bf16 and fp32: ragged last CTA (K2) and last chunk (K3) at S = 1001;
# 8-group stripes of 128 channels; one CTA a stripe; K3's column passes
# at 2560 channels and its cap at 4096 (K2's widest stripe: 128 channels,
# 512 bytes in fp32); K2's largest cluster (16 CTAs, two an SM) at the 768
# level-2 motion GN; the widest 16-CTA stripe (960 channels, one CTA an
# SM, which the dispatch sends to K3); stripes widened to 4 groups.
GN_CASES = [(3, 1001, 320, 32, 1e-5, True),
            (2, 777, 128, 32, 1e-6, False),
            (2, 64, 640, 32, 1e-6, True),
            (2, 100, 2560, 32, 1e-5, True),
            (1, 30, 4096, 32, 1e-5, False),
            (2, 9216, 1280, 32, 1e-6, False),
            (2, 9216, 960, 32, 1e-5, True),
            (4, 64, 1280, 32, 1e-5, True)]
# the up-block-1 resnet GN (2560 channels), which the slab gate of the
# first GroupNorm kernels refused: 1024x1024 in bf16, 768x768 in fp32
GN2560_CASES = [(torch.bfloat16, 32, 1024),
                (torch.float32, 32, 576)]
FORMS = ("exp", "exp2", "fastexp2", "staticmax", "staticaug", "noexp",
         "mxu_only")
# (B, Sq, Skv, H, D, block_k) for every form in bf16 and fp32: ragged Sq
# and Skv at each instance (bf16 on the wgmma + TMA pipeline, DP = 48, 80,
# 128, 160 and, for D = 168, 200, 256, DP = 256), a period
# of 128 keys over a ragged tail, 640 keys (20 tiles of 32) at D = 256,
# and Skv a multiple of the period (no padded keys, whose -1e30 scores
# otherwise drive noexp's l to about -1e31 and its outputs to near zero):
# 4 periods of 128, and 4 of 256 at D = 160 and D = 256. bf16 runs each
# case once more on rows 8 bytes past 16-byte alignment: the template.
FORM_CASES = [(2, 300, 300, 2, 40, 128),
              (1, 200, 577, 2, 80, 1024),
              (1, 129, 700, 2, 160, 256),
              (1, 100, 1100, 1, 256, 1024),
              (1, 64, 300, 1, 256, 128),
              (1, 100, 512, 2, 40, 128),
              (1, 100, 1024, 2, 160, 256),
              (1, 64, 1024, 1, 256, 256),
              (1, 200, 333, 2, 128, 256),
              (1, 300, 333, 2, 168, 1024),
              (1, 129, 1100, 2, 200, 256)]
# (entry, P, F, H, D, dtype): the 512x512 level-0 motion site, F = 8 / 32
# and D = 80 / 160, fp32 operands, K9 at F = 24; bf16 K6-K8 (the
# tensor-core kernel) and K9 at D = 160 with 16, 24 and 32 frames
TEMPORAL_CASES = [("k6", 8192, 16, 8, 40, torch.bfloat16),
                  ("k7", 512, 16, 8, 160, torch.bfloat16),
                  ("k8", 300, 8, 8, 80, torch.bfloat16),
                  ("k9", 256, 32, 8, 40, torch.bfloat16),
                  ("k6", 64, 32, 4, 160, torch.float32),
                  ("k7", 100, 8, 3, 40, torch.float32),
                  ("k8", 128, 16, 8, 80, torch.float32),
                  ("k9", 96, 24, 2, 160, torch.float32),
                  ("k9", 64, 16, 2, 20, torch.bfloat16),  # D % 8 != 0
                  *((kernel, 300, F, 8, 160, torch.bfloat16)
                    for kernel in ("k6", "k7", "k8", "k9")
                    for F in (16, 24, 32))]


def _check_k1(cuda, B, Sq, Skv, H, D, below=False):
    """K1 against its plain version; ``below``: k > 0 and two rows of q at
    -8 and -4.5, whose every scaled logit is below -46 (at D = 40 about
    -95, where p underflows to 0, and -53, where p is subnormal)."""
    from vdx_torch.kernels.flash_attention import (flash_attention_dt,
                                                   flash_attention_dt_plain)

    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _randn((B, Sq, H, D), gen, cuda)
    k = _randn((B, Skv, H, D), gen, cuda)
    v = _randn((B, Skv, H, D), gen, cuda)
    if below:
        k = (k.float().abs() + 0.5).to(k.dtype)
        q[:, 0], q[:, 1] = -8.0, -4.5
    before = _counts()
    got = flash_attention_dt(q, k, v, scale=D ** -0.5, exp_impl="staticmax")
    torch.cuda.synchronize()
    assert _counts() == dict(before, K1=before["K1"] + 1)
    want = flash_attention_dt_plain(q, k, v, scale=D ** -0.5,
                                    exp_impl="staticmax")
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(want), err


def _check_k4(cuda, B, Sq, Skv, H, D):
    from vdx_torch.kernels.flash_attention import (flash_attention,
                                                   flash_attention_plain)

    gen = torch.Generator(device=cuda).manual_seed(4)
    q = _randn((B, Sq, H, D), gen, cuda)
    k = _randn((B, Skv, H, D), gen, cuda)
    v = _randn((B, Skv, H, D), gen, cuda)
    before = _counts()
    got = flash_attention(q, k, v, scale=D ** -0.5)
    torch.cuda.synchronize()
    name = _counter(None, torch.bfloat16, D, True)
    assert _counts() == dict(before, **{name: before[name] + 1})
    want = flash_attention_plain(q, k, v, scale=D ** -0.5)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(want), (B, Sq, Skv, H, D, err)


def _counts():
    """Every flash attention launch count (kernels.flash_attention's
    launch_counts: K1, K4, each form's and "K4 template")."""
    from vdx_torch.kernels.flash_attention import launch_counts

    return launch_counts()


def _counter(exp_impl, dtype, D, aligned):
    from vdx_torch.kernels.flash_attention import counter_for

    return counter_for(exp_impl, dtype, D, aligned)


def _check_fp32(cuda, kernel, B, Sq, Skv, H, D):
    """fp32 operands: a SIMT kernel with p kept in fp32, as vdx's Pallas
    kernels do for fp32 v (the fp32 policy on the card)."""
    from vdx_torch.kernels import flash_attention as KA

    static = dict(exp_impl="staticmax")
    fn, plain = {"K1": (partial(KA.flash_attention_dt, **static),
                        partial(KA.flash_attention_dt_plain, **static)),
                 "K4": (KA.flash_attention, KA.flash_attention_plain)}[kernel]
    # fp32 staticmax is the SIMT kernel's static mode, "K1 static"; fp32
    # K4 counts as "K4 template"
    name = {"K1": "K1 static", "K4": "K4 template"}[kernel]
    assert _counter("staticmax" if kernel == "K1" else None, torch.float32,
                    D, True) == name
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn((B, S, H, D), generator=gen, device=cuda)
               for S in (Sq, Skv, Skv))
    before = _counts()
    got = fn(q, k, v, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert _counts() == dict(before, **{name: before[name] + 1})
    assert got.dtype == torch.float32
    want = plain(q, k, v, scale=D ** -0.5)
    err = (got - want).abs().max().item()
    assert err <= _tol(want), (kernel, B, Sq, Skv, H, D, err)


def _check_k4_strided_and_misaligned(cuda):
    """K4 on views into one fused projection (the wgmma + TMA kernel, TMA
    with the views' strides), and on rows that are not 16-byte aligned
    (the template's element loads, counted as "K4 template")."""
    from vdx_torch.kernels.flash_attention import (flash_attention,
                                                   flash_attention_plain)

    gen = torch.Generator(device=cuda).manual_seed(6)
    qkv = _randn((2, 600, 3, 2, 160), gen, cuda)
    flat = _randn((2 * 600 * 2 * 160 + 4,), gen, cuda)
    odd = flat[4:].view(2, 600, 2, 160)  # base 8 bytes past alignment
    for (q, k, v), counter in ((qkv.unbind(dim=2), "K4"),
                               ((odd, odd, odd), "K4 template")):
        before = _counts()
        got = flash_attention(q, k, v, scale=0.1)
        after = _counts()
        assert after == dict(before, **{counter: before[counter] + 1}), after
        want = flash_attention_plain(q, k, v, scale=0.1)
        assert (got.float() - want.float()).abs().max().item() <= _tol(want)


def _check_k1_strided_operands(cuda):
    """q/k/v as views into one fused [B, S, 3, H, D] projection (K1 on the
    wgmma + TMA kernel), and rows that are not 16-byte aligned (the
    mma.sync kernel's static mode, counted as "K1 static", not as K1)."""
    from vdx_torch.kernels.flash_attention import (flash_attention_dt,
                                                   flash_attention_dt_plain)

    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = _randn((2, 640, 3, 4, 40), gen, cuda)
    flat = _randn((2 * 640 * 4 * 40 + 4,), gen, cuda)
    odd = flat[4:].view(2, 640, 4, 40)  # base 8 bytes past alignment
    for (q, k, v), counter in ((qkv.unbind(dim=2), "K1"),
                               ((odd, odd, odd), "K1 static")):
        before = _counts()
        got = flash_attention_dt(q, k, v, scale=0.2, exp_impl="staticmax")
        after = _counts()
        assert after == dict(before, **{counter: before[counter] + 1}), after
        want = flash_attention_dt_plain(q, k, v, scale=0.2,
                                        exp_impl="staticmax")
        assert (got.float() - want.float()).abs().max().item() <= _tol(want)


def _check_form(cuda, form, dtype, B, Sq, Skv, H, D, block_k):
    """flash_attention_dt in one form against its plain version with the
    same block_k (kernels.flash_attention.plain_err_tol's bar), on
    contiguous operands, on views into one fused [B, S, 3, H, D]
    projection (16-byte aligned rows) and, in bf16, on views whose base is
    8 bytes past a 16-byte boundary; the counter counter_for names takes
    each launch, no other: the form's own on the wgmma + TMA pipeline
    (bf16, D <= 160, aligned rows: K1, K1' ..., K5), else its " template"
    name ("K1 static" for staticmax)."""
    from vdx_torch.kernels.flash_attention import (flash_attention_dt,
                                                   plain_err_tol)

    gen = torch.Generator(device=cuda).manual_seed(9)
    q = _randn((B, Sq, H, D), gen, cuda, dtype)
    kv = _randn((B, Skv, 2, H, D), gen, cuda, dtype)
    qkv = _randn((B, Skv, 3, H, D), gen, cuda, dtype)
    sets = [(q, kv[:, :, 0].contiguous(), kv[:, :, 1].contiguous(), True),
            (*qkv.unbind(dim=2), True)]
    if dtype == torch.bfloat16:
        n = B * Skv * H * D
        flat = _randn((3 * n + 4,), gen, cuda, dtype)[4:]
        odd = [flat[i * n:(i + 1) * n].view(B, Skv, H, D) for i in range(3)]
        sets.append((odd[0][:, :Sq], odd[1], odd[2], False))
    for q, k, v, aligned in sets:
        before = _counts()
        got = flash_attention_dt(q, k, v, scale=D ** -0.5, block_k=block_k,
                                 exp_impl=form)
        torch.cuda.synchronize()
        after = _counts()
        name = _counter(form, dtype, D, aligned)
        assert after == dict(before, **{name: before[name] + 1}), (form, after)
        err, _, tol, _ = plain_err_tol(got, q, k, v, scale=D ** -0.5,
                                       exp_impl=form, block_k=block_k)
        assert got.dtype == dtype and err <= tol, \
            (form, dtype, B, Sq, Skv, H, D, block_k, err, tol)


def _temporal(kernel):
    """(wrapper, plain version, extra kwargs) of K6-K9."""
    from vdx_torch.kernels import flash_attention as KA
    from vdx_torch.kernels import temporal_attention_cp as KT

    return {"k6": (KA.flash_attention_blockdiag,
                   KA.flash_attention_blockdiag_plain, {"block": 512}),
            "k7": (KA.flash_attention_blockdiag_tc,
                   KA.flash_attention_blockdiag_tc_plain, {"block": 256}),
            "k8": (KA.flash_attention_blockdiag_tc2,
                   KA.flash_attention_blockdiag_tc_plain, {"block": 256}),
            "k9": (KT.temporal_attention_cp, KT.temporal_attention_cp_plain,
                   {"block_p": 1})}[kernel]


def _check_temporal(cuda, kernel, P, F, H, D, dtype):
    """K6-K9 against their plain versions, on contiguous operands, on q/k/v
    views into one fused [P, F, 3, H, D] projection and, in bf16, on views
    whose base is 8 bytes past a 16-byte boundary (element staging)."""
    fn, plain, kw = _temporal(kernel)
    if kernel in ("k7", "k8"):
        kw = dict(kw, heads=H)
    if "block" in kw and kw["block"] % F:  # vdx's F | block (F = 24: 384)
        kw = dict(kw, block=math.lcm(128, F))
    gen = torch.Generator(device=cuda).manual_seed(7)
    qkv = _randn((P, F, 3, H, D), gen, cuda, dtype)
    contiguous = tuple(t.contiguous() for t in qkv.unbind(dim=2))
    sets = [contiguous, qkv.unbind(dim=2)]
    if dtype == torch.bfloat16:
        n = P * F * H * D
        flat = _randn((3 * n + 4,), gen, cuda, dtype)[4:]
        sets.append(tuple(flat[i * n:(i + 1) * n].view(P, F, H, D)
                          for i in range(3)))
    for q, k, v in sets:
        n0 = fn.launches
        got = fn(q, k, v, scale=D ** -0.5, **kw)
        torch.cuda.synchronize()
        assert fn.launches == n0 + 1 and got.dtype == dtype
        want = plain(q, k, v, scale=D ** -0.5)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= _tol(want), (kernel, P, F, H, D, dtype, err)


def _check_gn(cuda, kernel, dtype, B, S, C, G, eps, silu):
    from vdx_torch.kernels import groupnorm as K

    gen = torch.Generator(device=cuda).manual_seed(2)
    x = _randn((B, S, C), gen, cuda, dtype, mean=0.5)
    scale = 1.0 + 0.1 * torch.randn(C, generator=gen, device=cuda)
    bias = 0.1 * torch.randn(C, generator=gen, device=cuda)
    fn = K.fused_group_norm if kernel == "k2" else K.fused_group_norm_2phase
    plan = (K.k2_plan(S, C, G, x.element_size()) if kernel == "k2"
            else K.k3_plan(B, S, C, G, x.element_size()))
    if plan is None:
        with pytest.raises(ValueError):
            fn(x, scale, bias, num_groups=G, eps=eps, with_silu=silu)
        return
    n0 = fn.launches
    got = fn(x, scale, bias, num_groups=G, eps=eps, with_silu=silu)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    want = K.group_norm_moments_plain(x, scale, bias, num_groups=G, eps=eps,
                                      with_silu=silu)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(want), (kernel, dtype, B, S, C, plan, err)


def _check_gn_dispatch_matches_plain_formulation(cuda, shape):
    """ops.group_norm_silu on CUDA (K2 or K3 by the launch plan) against
    the CPU plain formulation, 5D input with stats over frames and space."""
    from vdx_torch.ops.groupnorm import group_norm_silu

    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(shape, generator=gen, device=cuda)
    C = shape[-1]
    scale = 1.0 + 0.1 * torch.randn(C, generator=gen, device=cuda)
    bias = 0.1 * torch.randn(C, generator=gen, device=cuda)
    got = group_norm_silu(x, 32, scale, bias, 1e-6)
    want = group_norm_silu(x.cpu(), 32, scale.cpu(), bias.cpu(), 1e-6)
    assert (got.cpu() - want).abs().max().item() <= 1e-4


def _check_gn_dispatch_at_2560_channels(cuda, dtype, B, S):
    """The shapes the first GN kernels' slab gate refused, through the
    dispatch, on the kernel the launch plan names, against the plain
    version."""
    from vdx_torch.kernels import groupnorm as K

    gen = torch.Generator(device=cuda).manual_seed(8)
    x = _randn((B, S, 2560), gen, cuda, dtype, mean=0.5)
    plan = K.gn_plan(B, S, 2560, 32, x.element_size())
    fn = K.fused_group_norm if plan.route == "K2" else K.fused_group_norm_2phase
    scale = 1.0 + 0.1 * torch.randn(2560, generator=gen, device=cuda)
    bias = 0.1 * torch.randn(2560, generator=gen, device=cuda)
    n0 = fn.launches
    got = K.group_norm_silu_cuda(x, 32, scale, bias, 1e-5)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    want = K.group_norm_moments_plain(x, scale, bias, num_groups=32, eps=1e-5,
                                      with_silu=True)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(want), (dtype, B, S, err)


def _check_tf32_off_inside_fp32_forwards_only(cuda):
    """An fp32-policy UNet / VAE / text forward on the card runs with both
    TF32 flags False (read by a forward hook inside the call) and gives
    the user's flags back; a bf16 forward leaves them as they were."""
    from vdx_torch.core.dtypes import BF16_POLICY, FP32_POLICY
    from vdx_torch.models.clip_text import CLIPTextConfig
    from vdx_torch.models.unet_motion import UNetMotionConfig
    from vdx_torch.models.vae import VAEConfig
    from vdx_torch.pipelines import AnimateDiffPipeline

    def flags():
        return (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)

    saved = flags()
    try:
        for policy, inside in ((FP32_POLICY, (False, False)),
                               (BF16_POLICY, None)):
            pipe = AnimateDiffPipeline.with_random_params(
                seed=0, unet_config=UNetMotionConfig.tiny(),
                vae_config=VAEConfig.tiny(), text_config=CLIPTextConfig.tiny(),
                policy=policy, scheduler="ddim", device=cuda)
            seen = []
            for m in (pipe.unet.conv_in, pipe.vae.decoder.conv_in,
                      pipe.text_encoder.text_model.final_layer_norm):
                m.register_forward_hook(lambda *_: seen.append(flags()))
            for before in ((True, True), (True, False)):
                torch.backends.cuda.matmul.allow_tf32, \
                    torch.backends.cudnn.allow_tf32 = before
                seen.clear()
                pipe("a corgi", num_frames=8, height=64, width=64,
                     num_inference_steps=1, output_type="np")
                assert len(seen) == 3 and set(seen) == {inside or before}, seen
                assert flags() == before
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = saved


def _check_wrappers_raise_on_what_kernels_do_not_take(cuda):
    from vdx_torch.kernels.flash_attention import (flash_attention_dt,
                                                   flash_attention_dt_plain)
    from vdx_torch.ops.attention import dot_product_attention
    from vdx_torch.ops.groupnorm import group_norm

    from vdx_torch.kernels.flash_attention import flash_attention

    q = torch.randn(1, 512, 2, 40, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention_dt(q, q, q, scale=1.0)  # fp16
    q16 = torch.randn(1, 512, 2, 128, device=cuda, dtype=torch.bfloat16)
    n0 = flash_attention.launches
    dot_product_attention(q16, q16, q16)  # flash-sized, D = 128: K4
    assert flash_attention.launches == n0 + 1
    # D = 128 computes, as vdx does (vdx's default form, exp)
    got = flash_attention_dt(q16, q16, q16, scale=1.0)
    want = flash_attention_dt_plain(q16, q16, q16, scale=1.0, exp_impl="exp")
    assert (got.float() - want.float()).abs().max().item() <= _tol(want)
    q264 = torch.randn(1, 64, 1, 264, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q264, q264, q264, scale=1.0)
    with pytest.raises(ValueError, match="head dims 8..256"):
        flash_attention_dt(q264, q264, q264, scale=1.0)
    with pytest.raises(ValueError, match="exp_impl"):
        flash_attention_dt(q16, q16, q16, scale=1.0, exp_impl="exp3")
    with pytest.raises(ValueError, match="cpu"):
        flash_attention(q16, q16.cpu(), q16, scale=1.0)
    with pytest.raises(TypeError):
        flash_attention(q16, q16.float(), q16, scale=1.0)
    # GroupNorm: what neither K2 nor K3 takes raises, no plain fallback
    for shape, G in (((1, 70000, 100), 4),        # C % 8 != 0
                     ((1, 70000, 4104), 8),       # C > 4096
                     ((2, 4096, 2048), 256)):     # G > 128
        x = torch.randn(shape, device=cuda, dtype=torch.bfloat16)
        C = shape[-1]
        with pytest.raises(NotImplementedError):
            group_norm(x, G, torch.ones(C, device=cuda),
                       torch.zeros(C, device=cuda))
    flat = torch.randn(2 * 1024 * 320 + 4, device=cuda, dtype=torch.bfloat16)
    odd = flat[4:].view(2, 1024, 320)  # base 8 bytes past 16-byte alignment
    with pytest.raises(ValueError, match="16-byte aligned"):
        group_norm(odd, 32, torch.ones(320, device=cuda),
                   torch.zeros(320, device=cuda))
    # K6-K9: vdx's preconditions, then the kernel's own caps
    t = torch.randn(8, 16, 2, 40, device=cuda, dtype=torch.bfloat16)
    n0 = _temporal("k6")[0].launches
    assert dot_product_attention(t, t, t, impl="blockdiag").shape == t.shape
    assert _temporal("k6")[0].launches == n0 + 1
    for kernel, bad, kw, match in (
            ("k6", t[..., :20], {}, "D % 8"),
            ("k7", t, {"heads": 4}, "heads"),
            ("k8", t, {"heads": 2, "block": 200}, "block % 128"),
            ("k9", t, {"block_p": 3}, "block_p"),
            ("k6", torch.randn(2, 64, 2, 40, device=cuda), {}, "frames"),
            ("k9", torch.randn(4, 16, 1, 168, device=cuda), {"block_p": 4},
             "head dims"),
            ("k7", t.half(), {"heads": 2}, None)):
        fn = _temporal(kernel)[0]
        with pytest.raises(TypeError if match is None else ValueError,
                           match=match):
            fn(bad, bad, bad, scale=1.0, **kw)
    with pytest.raises(ValueError, match="cpu"):
        _temporal("k9")[0](t, t.cpu(), t, block_p=1)


# A few tests per file, each looping over its cases: pytest-xdist's
# loadfile mode hands out files with many tests first, and this file's few
# tests keep it behind the suite's heavy files.
@pytest.mark.cuda
def test_k1_matches_plain(cuda):
    """The attention kernels: K1 and K4 (bf16 and fp32), every form of
    flash_attention_dt (K1', K5, and K1 off its kernel) on both routes,
    K6-K9."""
    for case in K1_CASES:
        _check_k1(cuda, *case)
    _check_k1(cuda, 2, 256, 300, 2, 40, below=True)
    _check_k1_strided_operands(cuda)
    for form in FORMS:
        for dtype in (torch.bfloat16, torch.float32):
            for case in FORM_CASES:
                _check_form(cuda, form, dtype, *case)
    for case in K4_CASES:
        _check_k4(cuda, *case)
    _check_k4_strided_and_misaligned(cuda)
    for case in FP32_CASES:
        _check_fp32(cuda, *case)
    for case in TEMPORAL_CASES:
        _check_temporal(cuda, *case)


@pytest.mark.cuda
def test_gn_kernels_match_plain(cuda):
    for kernel in ("k2", "k3"):
        for dtype in (torch.bfloat16, torch.float32):
            for case in GN_CASES:
                _check_gn(cuda, kernel, dtype, *case)
    for case in GN2560_CASES:
        _check_gn_dispatch_at_2560_channels(cuda, *case)
    for shape in ((2, 4, 16, 16, 320), (2, 16, 64, 64, 64)):
        _check_gn_dispatch_matches_plain_formulation(cuda, shape)
    _check_wrappers_raise_on_what_kernels_do_not_take(cuda)
    _check_tf32_off_inside_fp32_forwards_only(cuda)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_or_vdx():
    files = sorted((ROOT / "vdx_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts" / "profile_torch_port.py",
        ROOT / "scripts" / "bench_attn_torch.py",
        ROOT / "scripts" / "bench_gn_torch.py",
        ROOT / "scripts" / "sass_forms.py"]
    assert len(files) > 10
    bad = []
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "vdx", "safetensors"):
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad
