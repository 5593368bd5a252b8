"""Flash attention over [B, S, H, D] tensors: K1, K1', K4 and K5 (CUDA,
``csrc/flash_attention*.cu``), and the temporal kernels K6-K8.

``flash_attention_dt`` — port of vdx/kernels/flash_attention.py
``flash_attention_dt``: non-causal softmax(q k^T * scale) v in one of vdx's
seven ``exp_impl`` forms. Every form but ``exp`` first folds
scale * log2(e) into q, the product in fp32 rounded once to q's dtype, so
the scores s live in the log2 domain. r() is the rounding to v's dtype.

* ``staticmax`` (K1): p = 2^(s - 80), no row max; out = (sum r(p) v) /
  max(l, 2^-126) with l summed from the unrounded p. The power-of-two
  offset is exact and cancels in acc / l. Domain bound (as vdx,
  ``STATIC_OFF``): a row whose every scaled logit is below -46 underflows
  to zeros; one above ~193 overflows.
* ``staticaug`` (K5): staticmax with l summed from the rounded r(p) (vdx
  gets l from a ones row of v in the PV product).
* ``exp``, ``exp2``, ``fastexp2`` (K1'): the running-max recurrence of
  vdx's kernel, m' = max(m, blockmax s), alpha = e(m - m'), p = e(s - m'),
  l' = alpha l + sum p over the unrounded p, acc' = alpha acc + r(p) v,
  out = acc / l; e is exp on s * scale (``exp``), exp2 (``exp2``) or vdx's
  cubic ``_fast_exp2`` (``fastexp2``), the max updated once per effective
  ``block_k`` keys. For fastexp2 that period shows in the output (the
  cubic's 7.5e-5 error composes over the rescales).
* ``noexp`` (K1', a probe): the same recurrence with e(x) = x + 1. Its
  output depends on the period, padded keys (up to a multiple of it)
  scoring -1e30 and entering l.
* ``mxu_only`` (K1', a probe): out = r(s) v, no softmax at all.

``flash_attention`` (K4) — port of vdx's ``flash_attention``: the running
max in base e for any head dim up to 256 (the same kernel as ``exp``).

K6, K7, K8 — ports of vdx/kernels/flash_attention.py
``flash_attention_blockdiag``, ``flash_attention_blockdiag_tc`` and
``flash_attention_blockdiag_tc2``: per-position attention over the F
frames of [P, F, H, D] tensors (the motion modules' temporal sites),

    out[p, :, h] = softmax_g(q[p, :, h] . k[p, g, h]) v[p, :, h]

in base 2 with l summed from the unrounded p and PV from p rounded to v's
dtype. K6 folds scale * log2(e) into q in q's own dtype (so under bf16
the constant and the product round to bf16); K7 and K8 multiply the fp32
scores by it, and compute the identical function. In bf16 all three run
on the tensor cores (``mma.sync``) as modes of one Hopper kernel in
``csrc/temporal_attention.cu``; K9 (kernels/temporal_attention_cp.py) and
fp32 operands run the same source's SIMT kernel (fp32 FMAs);
:func:`temporal_kernel_for` is that rule.

Each wrapper launches its CUDA kernel for a CUDA tensor and raises on
anything the kernel does not take; :func:`kernel_for` is the one routing
rule: every form and K4 in bf16 at D % 8 == 0, D <= 256 with 16-byte
aligned rows run the wgmma + TMA pipeline (``csrc/flash_attention_sm90.cuh``:
K1, K4 and exp in ``csrc/flash_attention_sm90.cu``, the other K1' forms and
K5 in ``csrc/flash_attention_sm90_forms.cu``; past D = 160 its instance with
one consumer warpgroup); bf16 on rows that are not 16-byte aligned, and K4
at D % 8 != 0, a mode of the mma.sync template
(``csrc/flash_attention_runmax.cu``); fp32 a SIMT kernel with fp32 p
(``csrc/flash_attention_f32.cu``).
:func:`counter_for` names each route's counter. For a CPU tensor each
computes its plain PyTorch version, which the tests and ``chip_smoke.py``
hold the kernel against.

Under autograd (grad enabled, an input that requires grad) K1, K1', K5
and K4 run through :class:`FlashAttentionDtFn` and
:class:`FlashAttentionFn`: the kernel is the forward, the plain version's
VJP the backward (vdx gives its flash kernels none). No launch site hands
autograd a detached output: each raises under grad when an input requires
grad (``_lib.check_not_detached``), which a Function's forward, run with
grad disabled, never meets. The temporal kernels (K6-K9) have no backward.
"""

from __future__ import annotations

import torch

from vdx_torch.kernels import _lib

LOG2E = 1.4426950408889634
NEG_INF = -1e30
STATIC_OFF = 80.0
L_FLOOR = 2.0 ** -126
# vdx's degree-3 polynomial for 2^f on [0, 1] (the "fastexp2" form)
EXP2_C0 = 0.9999250788416159
EXP2_C1 = 0.6958342408899721
EXP2_C2 = 0.22606693137993905
EXP2_C3 = 0.0780238760040786
# vdx's exp_impl forms, in the order of the CUDA entry points' form codes
EXP_IMPLS = ("exp", "exp2", "fastexp2", "staticmax", "staticaug", "noexp",
             "mxu_only")
# each form's counter on the wgmma + TMA pipeline: K1 (staticmax) in
# flash_attention_dt.launches, the others in .form_launches; K5 is
# staticaug, K1' the running-max forms and the probes
FORM_KERNEL = {"exp": "K1' exp", "exp2": "K1' exp2",
               "fastexp2": "K1' fastexp2", "staticmax": "K1",
               "staticaug": "K5", "noexp": "K1' noexp",
               "mxu_only": "K1' mxu_only"}
# each form's counter off that pipeline, in .form_launches: " template"
# means off the wgmma + TMA pipeline, so one counter takes the launches of
# two kernels, the mma.sync template (bf16: rows that are not 16-byte
# aligned, K4 at D % 8 != 0) and the SIMT kernel (fp32); so do "K1 static"
# and "K4 template"
TEMPLATE_KERNEL = {f: "K1 static" if f == "staticmax" else f"{n} template"
                   for f, n in FORM_KERNEL.items()}
# fp32 outputs against the plain version: sums in another order
FP32_TOL = 1e-4
# every CUDA flash attention kernel takes head dims up to 256 (the wgmma +
# TMA pipeline: 48, 80, 128, 160 with two consumer warpgroups, 256 with one)
MAX_D = 256
SM90_MAX_D = 256
# the CUDA kernels by source (csrc/<name>.cu): the wgmma + TMA pipeline's
# K1/K4 instances (and exp, K4's) and its other forms, the mma.sync
# template, the fp32 SIMT kernel
SM90, SM90_FORMS, TEMPLATE, SIMT = (
    "flash_attention_sm90", "flash_attention_sm90_forms",
    "flash_attention_runmax", "flash_attention_f32")
# csrc/temporal_attention.cu takes up to 32 frames and head dims up to 160
TEMPORAL_MAX_F = 32
TEMPORAL_MAX_D = 160
# its modes, in the order of the C entry points' mode codes: K6, K7/K8, K9
TEMPORAL_MODES = ("blockdiag", "tc", "cp")
# its kernels: bf16 K6-K8 on the tensor cores, K9 and fp32 on the FMA pipes
TEMPORAL_MMA, TEMPORAL_SIMT = "temporal_mma", "temporal_simt"


def min_pad_block(S: int, cap: int) -> int:
    """vdx's ``_min_pad_block``: the largest multiple of 128 up to ``cap``
    that keeps the fewest blocks over S with the least padding."""
    Sp = max(128, ((S + 127) // 128) * 128)
    cap = max(128, (min(cap, Sp) // 128) * 128)
    n = (Sp + cap - 1) // cap
    return min(cap, ((Sp // n + 127) // 128) * 128)


def fast_exp2(y: torch.Tensor) -> torch.Tensor:
    """vdx's ``_fast_exp2`` on fp32: 2^y for y <= 0, clamped at -125, from
    the exponent bits (n + 127) << 23 times the cubic in f = y - floor(y)
    (Horner form, each operation rounded to fp32)."""
    y = torch.clamp_min(y, -125.0)
    n = torch.floor(y)
    f = y - n
    p = ((EXP2_C3 * f + EXP2_C2) * f + EXP2_C1) * f + EXP2_C0
    return ((n.to(torch.int32) + 127) << 23).view(torch.float32) * p


def _running_max_plain(s: torch.Tensor, v: torch.Tensor, exp_impl: str,
                       bk: int) -> torch.Tensor:
    """vdx's recurrence on scores s [b, h, q, k] (base e for "exp", else
    log2 domain), in s's dtype, the max updated once per ``bk`` keys; keys
    padded up to a multiple of ``bk`` score -1e30 and v zero. -> acc / l
    [b, q, h, D]."""
    e = {"exp": torch.exp, "exp2": torch.exp2, "fastexp2": fast_exp2,
         "noexp": lambda x: x + 1.0}[exp_impl]
    Skv = s.shape[-1]
    pad = -Skv % bk
    if pad:
        s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    m = torch.full(s.shape[:-1], NEG_INF, dtype=s.dtype, device=s.device)
    l = torch.zeros_like(m)
    acc = None
    for j in range(0, Skv + pad, bk):
        sb = s[..., j:j + bk]
        m_new = torch.maximum(m, sb.amax(dim=-1))
        alpha = e(m - m_new)
        p = e(sb - m_new[..., None])
        l = alpha * l + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).to(s.dtype),
                          v[:, j:j + bk].to(s.dtype))
        acc = pv if acc is None else alpha[..., None] * acc + pv
        m = m_new
    return (acc / l[..., None]).transpose(1, 2)


def flash_attention_dt_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             *, scale: float, exp_impl: str,
                             block_k: int = 1024) -> torch.Tensor:
    """Plain PyTorch ``flash_attention_dt`` in form ``exp_impl``: vdx's
    arithmetic and rounding points with the S x S scores materialised,
    accumulated in fp32 (float64 for float64 operands: the recurrence
    without rounding, after the fold in fp32). ``block_k`` (through
    :func:`min_pad_block`) is the running-max forms' statistics period.
    [B, Sq, H, D] -> [B, Sq, H, D]."""
    if exp_impl not in EXP_IMPLS:
        raise ValueError(f"unknown exp_impl {exp_impl!r}; vdx takes {EXP_IMPLS}")
    acc_t = torch.float64 if q.dtype == torch.float64 else torch.float32
    if exp_impl == "exp":
        qs = q
    else:  # q pre-scaled in fp32 and rounded once to q's dtype
        qs = (q.float() * (scale * LOG2E)).to(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.to(acc_t), k.to(acc_t))
    if exp_impl in ("staticmax", "staticaug"):
        p = torch.exp2(s - STATIC_OFF)
        pr = p.to(v.dtype).to(acc_t)
        l = torch.clamp_min((p if exp_impl == "staticmax" else pr).sum(dim=-1),
                            L_FLOOR)  # [b, h, q]
        acc = torch.einsum("bhqk,bkhd->bqhd", pr, v.to(acc_t))
        return (acc / l.transpose(1, 2)[..., None]).to(q.dtype)
    if exp_impl == "mxu_only":
        return torch.einsum("bhqk,bkhd->bqhd", s.to(v.dtype).to(acc_t),
                            v.to(acc_t)).to(q.dtype)
    if exp_impl == "exp":
        s = s * scale
    bk = min_pad_block(k.shape[1], block_k)
    return _running_max_plain(s, v, exp_impl, bk).to(q.dtype)


def plain_err_tol(out: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, *, scale: float, exp_impl: str,
                  block_k: int = 1024):
    """``out``, flash_attention_dt's output on q, k, v in form
    ``exp_impl``, against :func:`flash_attention_dt_plain` with the same
    ``block_k``. -> (max_abs_err, mean_abs_err, tol, max|plain|), the
    last from the float64 recurrence for noexp in fp32.

    bf16: one bf16 ulp at max|plain|, 2^-7 * max|plain| (both sides round
    once to bf16 from fp32 sums in another order), floored at 1 for every
    form but noexp. noexp's bar has no floor: when Skv is not a multiple
    of the period, the padded keys' -1e30 scores enter l and shrink every
    output to about 1e-30, and the bar has to shrink with them.

    fp32: 1e-4, times max(1, max|plain|) for mxu_only, which does not
    normalise. noexp in fp32: x + 1 in place of the exponential leaves l a
    sum of signed terms, rescaled by factors m - m' + 1 that may be
    negative, so l can nearly cancel and fp32 does not resolve the output
    to 1e-4 (the fp32 plain version itself lands up to ~6e-4 from float64
    at O(1) outputs). The kernel is held to the same recurrence in float64
    within 1e-4 * max|exact| plus four times the fp32 plain version's own
    distance from it.
    """
    kw = dict(scale=scale, exp_impl=exp_impl, block_k=block_k)
    ref = flash_attention_dt_plain(q, k, v, **kw)
    mag = ref.float().abs().max().item()
    if exp_impl == "noexp" and q.dtype == torch.float32:
        exact = flash_attention_dt_plain(q.double(), k.double(), v.double(),
                                         **kw)
        own = (ref.double() - exact).abs().max().item()
        err = (out.double() - exact).abs()
        mag = exact.abs().max().item()
        tol = FP32_TOL * mag + 4 * own
    else:
        err = (out.float() - ref.float()).abs()
        floor = 0.0 if exp_impl == "noexp" else 1.0
        tol = (2.0 ** -7 * max(floor, mag) if q.dtype == torch.bfloat16
               else FP32_TOL * (max(1.0, mag) if exp_impl == "mxu_only"
                                else 1.0))
    return err.max().item(), err.mean().item(), tol, mag


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float) -> torch.Tensor:
    """Plain PyTorch K4: the S x S scores materialised, softmax in fp32
    with l from the unrounded p, PV from p rounded to v's dtype, one
    rounding at the end. [B, Sq, H, D] -> [B, Sq, H, D]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)  # [b, h, q]
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return (acc / l.transpose(1, 2)[..., None]).to(q.dtype)


def _check_operands(what: str, q, k, v) -> None:
    """Device, dtype, shape and layout checks shared by K1, K1', K4, K5."""
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, got {q.device}")
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if k.shape != (B, Skv, H, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {q.shape} k {k.shape} v {v.shape}")
    if B * H > 65535 or Sq < 1 or Skv < 1:
        raise ValueError(f"{what} grid out of range: B*H={B * H}, Sq={Sq}, "
                         f"Skv={Skv}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} takes bf16 or fp32, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{what} needs {name} with unit stride on D")


def _rows_16b_aligned(*ts: torch.Tensor) -> bool:
    """Every [b, s, h] row of each tensor starts on a 16-byte boundary
    (bf16: strides in multiples of 8 elements, an aligned base)."""
    return all(not any(st % 8 for st in t.stride()[:3]) and t.data_ptr() % 16 == 0
               for t in ts)


def _strides(*ts: torch.Tensor):
    return [st for t in ts for st in t.stride()[:3]]


def kernel_for(exp_impl, dtype: torch.dtype, D: int, aligned: bool) -> str:
    """The routing rule: which CUDA kernel computes flash attention in form
    ``exp_impl`` (one of :data:`EXP_IMPLS`; None for K4, ``flash_attention``)
    on ``dtype`` operands of head dim D, ``aligned`` when every q/k/v row
    and base is 16-byte aligned. -> in bf16 at D % 8 == 0, 8 <= D <= 256 on
    aligned rows the wgmma + TMA pipeline: :data:`SM90` for K1
    (staticmax), K4 and exp, :data:`SM90_FORMS` for every other form; else
    :data:`TEMPLATE` (bf16) or :data:`SIMT` (fp32). Never the plain
    version: that runs on CPU tensors only."""
    if dtype == torch.float32:
        return SIMT
    if aligned and D % 8 == 0 and 8 <= D <= SM90_MAX_D:
        return SM90 if exp_impl in (None, "staticmax", "exp") else SM90_FORMS
    return TEMPLATE


def counter_for(exp_impl, dtype: torch.dtype, D: int, aligned: bool) -> str:
    """The counter that takes the launch :func:`kernel_for` routes (same
    arguments). On the wgmma + TMA pipeline: "K4"
    (``flash_attention.launches``), "K1" (``flash_attention_dt.launches``)
    or the form's :data:`FORM_KERNEL` name; off it "K4 template"
    (``flash_attention.template_launches``) or the form's
    :data:`TEMPLATE_KERNEL` name ("K1 static", "K5 template", "K1' exp2
    template", ...), which count the mma.sync template's launches (bf16)
    and the SIMT kernel's (fp32) alike. Form names count in
    ``flash_attention_dt.form_launches``."""
    return _counter(exp_impl, kernel_for(exp_impl, dtype, D, aligned))


def _counter(exp_impl, kernel: str) -> str:
    """:func:`counter_for`'s name for a launch of form ``exp_impl`` on
    ``kernel``, :func:`kernel_for`'s choice."""
    if kernel in (SM90, SM90_FORMS):
        return "K4" if exp_impl is None else FORM_KERNEL[exp_impl]
    return "K4 template" if exp_impl is None else TEMPLATE_KERNEL[exp_impl]


def launch_counts() -> dict:
    """Every flash attention launch count, by :func:`counter_for`'s names."""
    return {"K1": flash_attention_dt.launches, "K4": flash_attention.launches,
            **flash_attention_dt.form_launches,
            "K4 template": flash_attention.template_launches}


def _launch_sm90(q, k, v, *, scale: float, exp_impl, kernel: str,
                 period: int, what: str):
    """One launch of the wgmma + TMA pipeline in form ``exp_impl`` (None:
    K4) on ``kernel``, :func:`kernel_for`'s choice, mult = scale *
    log2(e): :data:`SM90` for K1 (staticmax, mult folded into q), K4 and
    exp (the running max, mult on the fp32 scores); :data:`SM90_FORMS` for
    the other forms (mult folded into q; ``period`` is fastexp2's and
    noexp's statistics period in keys, a multiple of 128)."""
    _lib.check_not_detached(what, q, k, v)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    B, Sq, H, D = q.shape
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, Sq, k.shape[1], H, D, *_strides(q, k, v, o),
            float(scale * LOG2E))
    if kernel == SM90:
        err = _lib.lib().vdx_flash_attention_sm90(
            *args, int(exp_impl == "staticmax"), _lib.stream_ptr(q.device))
    else:
        err = _lib.lib().vdx_flash_attention_sm90_forms(
            *args, EXP_IMPLS.index(exp_impl), int(period),
            _lib.stream_ptr(q.device))
    _lib.check(err, what)
    return o


def _launch_forms(q, k, v, *, scale: float, exp_impl: str,
                  period: int) -> torch.Tensor:
    """One launch of the form ``exp_impl`` of the mma.sync kernel (bf16,
    ``csrc/flash_attention_runmax.cu``) or the SIMT kernel (fp32,
    ``csrc/flash_attention_f32.cu``); ``period`` is fastexp2's and
    noexp's statistics period in keys (a multiple of 128)."""
    _lib.check_not_detached(f"flash attention {exp_impl}", q, k, v)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    B, Sq, H, D = q.shape
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, Sq, k.shape[1], H, D, *_strides(q, k, v, o),
            float(scale * LOG2E), EXP_IMPLS.index(exp_impl), int(period))
    if q.dtype == torch.float32:
        err = _lib.lib().vdx_flash_attention_f32(*args, _lib.stream_ptr(q.device))
    else:
        vec = D % 8 == 0 and _rows_16b_aligned(q, k, v)
        err = _lib.lib().vdx_flash_attention_mma_bf16(
            *args, int(vec), _lib.stream_ptr(q.device))
    _lib.check(err, f"flash attention {exp_impl} ({str(q.dtype)[6:]})")
    return o


def flash_attention_dt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, scale: float, block_q: int = 1024,
                       block_k: int = 1024,
                       exp_impl: str = "exp") -> torch.Tensor:
    """vdx's ``flash_attention_dt``: [B, Sq, H, D] x [B, Skv, H, D]^2 ->
    q's shape, in form ``exp_impl`` (one of :data:`EXP_IMPLS`; see the
    module docstring), bf16 or fp32, D % 8 == 0.

    ``block_q`` and ``block_k`` are vdx's TPU tiles, taken through
    :func:`min_pad_block` as vdx does. They change nothing but the
    statistics period (the effective block_k) of noexp and, within the
    cubic's error, of fastexp2; for every other form they change only the
    fp32 summation order on the TPU, and the Hopper kernels need none.

    CUDA: one launch on the current stream, no synchronise, D <= 256 (the
    Hopper kernels' limit), on the kernel :func:`kernel_for` names, counted
    where :func:`counter_for` says: staticmax on the wgmma + TMA pipeline
    (K1) in ``launches``; every other launch in ``form_launches``, under
    :data:`FORM_KERNEL`'s name of its form on that pipeline and
    :data:`TEMPLATE_KERNEL`'s off it. With grad enabled and an input that
    requires grad, the launch goes through :class:`FlashAttentionDtFn`
    (the backward: the plain version's VJP). CPU: the plain version,
    which autograd differentiates itself.
    """
    if exp_impl not in EXP_IMPLS:
        raise ValueError(f"unknown exp_impl {exp_impl!r}; vdx takes {EXP_IMPLS}")
    D = q.shape[-1]
    if D % 8:
        raise ValueError(f"flash_attention_dt takes D % 8 == 0, got D={D}")
    if q.device.type == "cpu":
        return flash_attention_dt_plain(q, k, v, scale=scale,
                                        exp_impl=exp_impl, block_k=block_k)
    if _needs_graph(q, k, v):
        return FlashAttentionDtFn.apply(q, k, v, scale, exp_impl, block_k)
    return _flash_dt_cuda(q, k, v, scale, exp_impl, block_k)


def _flash_dt_cuda(q, k, v, scale: float, exp_impl: str,
                   block_k: int) -> torch.Tensor:
    """:func:`flash_attention_dt`'s launch on CUDA tensors, counted."""
    D = q.shape[-1]
    period = min_pad_block(k.shape[1], block_k)
    what = f"flash_attention_dt {exp_impl}"
    _check_operands(what, q, k, v)
    if not 8 <= D <= MAX_D:
        raise ValueError(f"{what}: the Hopper kernels take head dims 8..{MAX_D} "
                         f"in steps of 8 (vdx has no upper bound), got {D}")
    kernel = kernel_for(exp_impl, q.dtype, D, _rows_16b_aligned(q, k, v))
    counter = _counter(exp_impl, kernel)
    if kernel in (SM90, SM90_FORMS):
        o = _launch_sm90(q, k, v, scale=scale, exp_impl=exp_impl,
                         kernel=kernel, period=period,
                         what=f"{counter} {what}")
    else:
        o = _launch_forms(q, k, v, scale=scale, exp_impl=exp_impl,
                          period=period)
    if counter == "K1":
        flash_attention_dt.launches += 1
    else:
        flash_attention_dt.form_launches[counter] += 1
    return o


flash_attention_dt.launches = 0
flash_attention_dt.form_launches = {
    name: 0 for name in (*FORM_KERNEL.values(), *TEMPLATE_KERNEL.values())
    if name != "K1"}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, scale: float) -> torch.Tensor:
    """K4: running-max flash attention, [B, Sq, H, D] x [B, Skv, H, D]^2
    -> q's shape, any 1 <= D <= 256.

    CUDA: one launch on the current stream, no synchronise, on the kernel
    :func:`kernel_for` names: the wgmma + TMA kernel's running-max form
    (bf16, D % 8 == 0, D <= 256, aligned rows), counted in ``launches``;
    else the ``exp`` form of the mma.sync kernel (bf16; element loads when
    D % 8 != 0 or the rows are not aligned) or of the SIMT kernel (fp32),
    counted apart in ``template_launches`` ("K4 template"). With grad
    enabled and an input that requires grad, through
    :class:`FlashAttentionFn` (the plain version's VJP). CPU: the plain
    version.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale)
    if _needs_graph(q, k, v):
        return FlashAttentionFn.apply(q, k, v, scale)
    return _flash_cuda(q, k, v, scale)


def _flash_cuda(q, k, v, scale: float) -> torch.Tensor:
    """:func:`flash_attention`'s launch on CUDA tensors, counted."""
    _check_operands("K4", q, k, v)
    D = q.shape[-1]
    if not 1 <= D <= MAX_D:
        raise ValueError(f"K4 takes head dims 1..{MAX_D}, got {D}")
    kernel = kernel_for(None, q.dtype, D, _rows_16b_aligned(q, k, v))
    if kernel == SM90:
        o = _launch_sm90(q, k, v, scale=scale, exp_impl=None, kernel=kernel,
                         period=0, what="K4 flash_attention")
        flash_attention.launches += 1
    else:
        o = _launch_forms(q, k, v, scale=scale, exp_impl="exp", period=128)
        flash_attention.template_launches += 1
    return o


flash_attention.launches = 0
flash_attention.template_launches = 0


# --------------------------------------------- K1, K1', K5, K4 under grad --
# vdx gives its flash kernels no VJP (jax.grad through them fails); its
# trainer differentiates the XLA attention. Here the kernel runs the
# forward and the backward is the VJP of the plain version the kernel is
# held against, recomputed from the saved q, k, v (vdx's GroupNorm
# pattern, ops/groupnorm.py). No hand-written backward kernel.

# fp32 scores a backward slice may hold: 2^28 elements, 1 GiB (autograd
# keeps a few S x S tensors of the plain version beside them)
VJP_SLICE_SCORES = 1 << 28


def _needs_graph(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def plain_vjp(plain, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              g: torch.Tensor, needs=(True, True, True)) -> list:
    """The VJP of ``plain`` (a [B, S, H, D] attention of q, k, v) at g,
    recomputed in (batch, head) slices whose fp32 scores stay under
    :data:`VJP_SLICE_SCORES` elements. -> [dq, dk, dv], None where
    ``needs`` is False; each in its input's dtype."""
    B, Sq, H, _ = q.shape
    per = max(1, VJP_SLICE_SCORES // (Sq * k.shape[1]))
    hs = min(H, per)
    bs = max(1, min(B, per // H)) if hs == H else 1
    ins = (q, k, v)
    grads = [torch.empty_like(t) if n else None for t, n in zip(ins, needs)]
    for b in range(0, B, bs):
        for h in range(0, H, hs):
            idx = (slice(b, b + bs), slice(None), slice(h, h + hs))
            with torch.enable_grad():
                xs = [t[idx].detach().requires_grad_(bool(n))
                      for t, n in zip(ins, needs)]
                out = plain(*xs)
                got = iter(torch.autograd.grad(
                    out, [x for x in xs if x.requires_grad], g[idx]))
            for gr in grads:
                if gr is not None:
                    gr[idx] = next(got)
    return grads


class FlashAttentionDtFn(torch.autograd.Function):
    """:func:`flash_attention_dt` on CUDA under autograd: the forward is
    the kernel launch, the backward :func:`plain_vjp` of
    :func:`flash_attention_dt_plain` in the same form and period.
    ``backward_calls`` counts backward passes."""

    backward_calls = 0

    @staticmethod
    def forward(ctx, q, k, v, scale, exp_impl, block_k):
        ctx.save_for_backward(q, k, v)
        ctx.args = dict(scale=scale, exp_impl=exp_impl, block_k=block_k)
        return _flash_dt_cuda(q, k, v, scale, exp_impl, block_k)

    @staticmethod
    def backward(ctx, g):
        FlashAttentionDtFn.backward_calls += 1
        q, k, v = ctx.saved_tensors
        plain = (lambda a, b, c:  # noqa: E731
                 flash_attention_dt_plain(a, b, c, **ctx.args))
        return (*plain_vjp(plain, q, k, v, g, ctx.needs_input_grad[:3]),
                None, None, None)


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` (K4) on CUDA under autograd: the kernel
    forward, :func:`plain_vjp` of :func:`flash_attention_plain`."""

    backward_calls = 0

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _flash_cuda(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        FlashAttentionFn.backward_calls += 1
        q, k, v = ctx.saved_tensors
        plain = (lambda a, b, c:  # noqa: E731
                 flash_attention_plain(a, b, c, scale=ctx.scale))
        return (*plain_vjp(plain, q, k, v, g, ctx.needs_input_grad[:3]),
                None)


# ------------------------------------------------- K6-K9: temporal sites --


def _base2_softmax_pv(s: torch.Tensor, v: torch.Tensor, dtype) -> torch.Tensor:
    """K6-K8's tail on fp32 scores s [P, H, F, F] (log2 domain): p =
    2^(s - rowmax), l from the unrounded p, PV from p rounded to v's
    dtype, one rounding to ``dtype`` at the end -> [P, F, H, D]."""
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)  # [P, H, F]
    acc = torch.einsum("phfg,pghd->pfhd", p.to(v.dtype).float(), v.float())
    return (acc / l.transpose(1, 2)[..., None]).to(dtype)


def flash_attention_blockdiag_plain(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, *,
                                    scale: float) -> torch.Tensor:
    """Plain PyTorch K6: q pre-scaled by scale * log2(e) in q's dtype,
    then :func:`_base2_softmax_pv`. [P, F, H, D] -> [P, F, H, D]."""
    qs = q * torch.tensor(scale * LOG2E, dtype=q.dtype)
    s = torch.einsum("pfhd,pghd->phfg", qs.float(), k.float())
    return _base2_softmax_pv(s, v, q.dtype)


def flash_attention_blockdiag_tc_plain(q: torch.Tensor, k: torch.Tensor,
                                       v: torch.Tensor, *,
                                       scale: float) -> torch.Tensor:
    """Plain PyTorch K7/K8: the fp32 scores times scale * log2(e), then
    :func:`_base2_softmax_pv`. [P, F, H, D] -> [P, F, H, D]."""
    s = torch.einsum("pfhd,pghd->phfg", q.float(), k.float()) \
        * (scale * LOG2E)
    return _base2_softmax_pv(s, v, q.dtype)


def check_temporal_shapes(what: str, q, k, v) -> None:
    """q, k and v of one [P, F, H, D] shape (vdx's folds need it)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what} takes q, k, v of one [P, F, H, D] shape; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")


def _check_blockdiag(what: str, q, k, v, block: int, heads=None) -> None:
    """vdx's preconditions of K6-K8 (its asserts), on every device."""
    check_temporal_shapes(what, q, k, v)
    P, F, H, D = q.shape
    if heads is not None and H != heads:
        raise ValueError(f"{what}: q has {H} heads, heads={heads}")
    if D % 8:
        raise ValueError(f"{what} takes D % 8 == 0, got D={D}")
    if block % 128 or block % F:
        raise ValueError(f"{what} takes block % 128 == 0 and F | block; "
                         f"got block={block}, F={F}")


def temporal_kernel_for(mode: str, dtype: torch.dtype) -> str:
    """The routing rule of ``csrc/temporal_attention.cu``: which kernel runs
    ``mode`` (one of :data:`TEMPORAL_MODES`: "blockdiag" K6, "tc" K7/K8,
    "cp" K9) on ``dtype`` operands. -> :data:`TEMPORAL_MMA` (bf16 K6-K8:
    mma.sync bf16 tensor cores, fp32 accumulators) or :data:`TEMPORAL_SIMT`
    (K9, all fp32 arithmetic, and fp32 K6-K8: fp32 FMAs). Any row
    alignment and head dim up to 160: the kernels stage element by element
    where 16-byte loads do not fit."""
    if mode not in TEMPORAL_MODES:
        raise ValueError(f"unknown temporal mode {mode!r}; {TEMPORAL_MODES}")
    return (TEMPORAL_MMA if dtype == torch.bfloat16 and mode != "cp"
            else TEMPORAL_SIMT)


def launch_temporal(mode: str, what: str, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, mult: float) -> torch.Tensor:
    """One launch of ``mode`` of ``csrc/temporal_attention.cu`` (one of
    :data:`TEMPORAL_MODES`) on CUDA [P, F, H, D] operands (strided views,
    unit stride on D), on the kernel :func:`temporal_kernel_for` names; ->
    a contiguous output of q's shape and dtype. The range and dtype are
    checked before the device; with grad enabled, inputs that require
    grad raise (no temporal kernel has a backward)."""
    _lib.check_not_detached(what, q, k, v)
    P, F, H, D = q.shape
    if not (1 <= F <= TEMPORAL_MAX_F and 1 <= D <= TEMPORAL_MAX_D):
        raise ValueError(f"{what}: the Hopper kernel takes 1..{TEMPORAL_MAX_F} "
                         f"frames and head dims 1..{TEMPORAL_MAX_D}; got "
                         f"F={F}, D={D}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} takes bf16 or fp32, got {q.dtype}")
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, got {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{what} needs {name} with unit stride on D")
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    if o.numel() == 0:
        return o
    per_16b = 16 // q.element_size()
    vec = D % 8 == 0 and all(
        not any(st % per_16b for st in t.stride()[:3]) and t.data_ptr() % 16 == 0
        for t in (q, k, v))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            P, F, H, D, *_strides(q, k, v, o), float(mult),
            TEMPORAL_MODES.index(mode))
    if temporal_kernel_for(mode, q.dtype) == TEMPORAL_MMA:
        err = _lib.lib().vdx_temporal_attention_mma(
            *args, int(vec), _lib.stream_ptr(q.device))
    else:
        err = _lib.lib().vdx_temporal_attention_simt(
            *args, int(q.dtype == torch.bfloat16), int(vec),
            _lib.stream_ptr(q.device))
    _lib.check(err, what)
    return o


def flash_attention_blockdiag(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, scale: float,
                              block: int = 512) -> torch.Tensor:
    """K6: per-position attention over the F frames of [P, F, H, D] q, k,
    v (bf16 or fp32) -> q's shape, with scale * log2(e) folded into q in
    q's dtype.

    Raises where vdx asserts: one shape for q, k and v; D % 8 == 0;
    block % 128 == 0 and F | block. ``block`` is the TPU kernel's tile of
    the folded P*F token axis; the Hopper kernel needs none (one warp per
    position and head) and keeps it only for those preconditions. CUDA:
    one launch (bf16: the tensor-core kernel), F <= 32 and D <= 160. CPU:
    the plain version.
    """
    _check_blockdiag("K6", q, k, v, block)
    if q.device.type == "cpu":
        return flash_attention_blockdiag_plain(q, k, v, scale=scale)
    mult = torch.tensor(scale * LOG2E, dtype=q.dtype).item()
    o = launch_temporal("blockdiag", "K6 blockdiag", q, k, v, mult)
    flash_attention_blockdiag.launches += 1
    return o


flash_attention_blockdiag.launches = 0


def flash_attention_blockdiag_tc(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, *, scale: float, heads: int,
                                 block: int = 256) -> torch.Tensor:
    """K7: K6's attention with scale * log2(e) applied to the fp32 scores
    (vdx's [T, C]-layout form). Raises where vdx asserts (H == heads,
    D % 8 == 0, block % 128 == 0, F | block, one shape for q, k, v); the
    Hopper kernel needs no ``block``. CUDA: one launch of the kernel's
    fp32-scaled-scores mode (bf16: on the tensor cores), F <= 32,
    D <= 160. CPU: the plain version."""
    _check_blockdiag("K7", q, k, v, block, heads)
    if q.device.type == "cpu":
        return flash_attention_blockdiag_tc_plain(q, k, v, scale=scale)
    o = launch_temporal("tc", "K7 blockdiag_tc", q, k, v, scale * LOG2E)
    flash_attention_blockdiag_tc.launches += 1
    return o


flash_attention_blockdiag_tc.launches = 0


def flash_attention_blockdiag_tc2(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, *, scale: float, heads: int,
                                  block: int = 256) -> torch.Tensor:
    """K8: vdx's q-major variant of K7, the identical function; the same
    kernel mode, counted apart. Preconditions and devices as K7."""
    _check_blockdiag("K8", q, k, v, block, heads)
    if q.device.type == "cpu":
        return flash_attention_blockdiag_tc_plain(q, k, v, scale=scale)
    o = launch_temporal("tc", "K8 blockdiag_tc2", q, k, v, scale * LOG2E)
    flash_attention_blockdiag_tc2.launches += 1
    return o


flash_attention_blockdiag_tc2.launches = 0
