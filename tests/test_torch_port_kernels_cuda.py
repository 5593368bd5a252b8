"""vdx_torch's CUDA kernels (K1, K2, K3) against their plain PyTorch
versions, on the card, plus an import-hygiene check that runs everywhere.

The kernel tests skip without a GPU. On the card they run with

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_port_kernels_cuda.py -q

(``--noconftest``: the repo's conftest imports jax, which the GPU machine
does not have). Tolerance for bf16 outputs: one bf16 ulp at the largest
reference magnitude, 2^-7 * max(1, max|ref|) — both sides compute in fp32
and round once to bf16, so a different fp32 summation order can flip the
last bit of an element, no more. fp32 outputs: 1e-4 absolute on O(1)
values (fp32 sums of up to 10^5 terms in different orders).
"""

import ast
import pathlib

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


K1_CASES = [(2, 512, 512, 2, 40),
            (1, 300, 577, 3, 80),   # ragged Sq and Skv tails
            (2, 129, 1000, 2, 64),
            (1, 64, 70, 1, 8),
            (1, 100, 200, 2, 120)]
GN_CASES = [(3, 1000, 320, 32, 1e-5, True),
            (2, 777, 128, 32, 1e-6, False),
            (2, 64, 640, 32, 1e-6, True)]


def _check_k1(cuda, B, Sq, Skv, H, D):
    from vdx_torch.kernels.flash_attention import (flash_attention_dt,
                                                   flash_attention_dt_plain)

    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _randn((B, Sq, H, D), gen, cuda)
    k = _randn((B, Skv, H, D), gen, cuda)
    v = _randn((B, Skv, H, D), gen, cuda)
    n0 = flash_attention_dt.launches
    got = flash_attention_dt(q, k, v, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention_dt.launches == n0 + 1
    want = flash_attention_dt_plain(q, k, v, scale=D ** -0.5)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(want), err


def _check_k1_strided_operands(cuda):
    """q/k/v as views into one fused [B, S, 3, H, D] projection."""
    from vdx_torch.kernels.flash_attention import (flash_attention_dt,
                                                   flash_attention_dt_plain)

    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = _randn((2, 640, 3, 4, 40), gen, cuda)
    q, k, v = qkv.unbind(dim=2)
    got = flash_attention_dt(q, k, v, scale=0.2)
    want = flash_attention_dt_plain(q, k, v, scale=0.2)
    assert (got.float() - want.float()).abs().max().item() <= _tol(want)


def _check_gn(cuda, kernel, dtype, B, S, C, G, eps, silu):
    from vdx_torch.kernels import groupnorm as K

    gen = torch.Generator(device=cuda).manual_seed(2)
    x = _randn((B, S, C), gen, cuda, dtype, mean=0.5)
    scale = 1.0 + 0.1 * torch.randn(C, generator=gen, device=cuda)
    bias = 0.1 * torch.randn(C, generator=gen, device=cuda)
    fn = K.fused_group_norm if kernel == "k2" else K.fused_group_norm_2phase
    if kernel == "k2" and not K.k2_viable(S, C, G, x.element_size()):
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
    assert err <= _tol(want), err


def _check_gn_dispatch_matches_plain_formulation(cuda, shape):
    """ops.group_norm_silu on CUDA (K2 or K3 by the gate) against the CPU
    plain formulation, 5D input with stats over frames and space."""
    from vdx_torch.ops.groupnorm import group_norm_silu

    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(shape, generator=gen, device=cuda)
    C = shape[-1]
    scale = 1.0 + 0.1 * torch.randn(C, generator=gen, device=cuda)
    bias = 0.1 * torch.randn(C, generator=gen, device=cuda)
    got = group_norm_silu(x, 32, scale, bias, 1e-6)
    want = group_norm_silu(x.cpu(), 32, scale.cpu(), bias.cpu(), 1e-6)
    assert (got.cpu() - want).abs().max().item() <= 1e-4


def _check_wrappers_raise_on_what_kernels_do_not_take(cuda):
    from vdx_torch.kernels.flash_attention import flash_attention_dt
    from vdx_torch.ops.attention import dot_product_attention
    from vdx_torch.ops.groupnorm import group_norm

    q = torch.randn(1, 512, 2, 40, device=cuda)
    with pytest.raises(TypeError):
        flash_attention_dt(q, q, q, scale=1.0)  # fp32
    q16 = torch.randn(1, 512, 2, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="K4"):
        dot_product_attention(q16, q16, q16)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_dt(q16, q16, q16, scale=1.0)  # D = 128 is K4's
    x = torch.randn(1, 70000, 100, device=cuda)  # C % 8 != 0, slab too big
    with pytest.raises(NotImplementedError):
        group_norm(x, 4, torch.ones(100, device=cuda),
                   torch.zeros(100, device=cuda))


# A few tests per file, each looping over its cases: pytest-xdist's
# loadfile mode hands out files with many tests first, and this file's few
# tests keep it behind the suite's heavy files.
@pytest.mark.cuda
def test_k1_matches_plain(cuda):
    for case in K1_CASES:
        _check_k1(cuda, *case)
    _check_k1_strided_operands(cuda)


@pytest.mark.cuda
def test_gn_kernels_match_plain(cuda):
    for kernel in ("k2", "k3"):
        for dtype in (torch.bfloat16, torch.float32):
            for case in GN_CASES:
                _check_gn(cuda, kernel, dtype, *case)
    for shape in ((2, 4, 16, 16, 320), (2, 16, 64, 64, 64)):
        _check_gn_dispatch_matches_plain_formulation(cuda, shape)
    _check_wrappers_raise_on_what_kernels_do_not_take(cuda)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_or_vdx():
    files = sorted((ROOT / "vdx_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts" / "profile_torch_port.py"]
    assert len(files) > 10
    bad = []
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "vdx"):
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad
