"""Frame-sharded denoiser execution — sequence parallelism for long clips
(port of vdx/parallel/frame_parallel.py).

The frame axis is sharded over the mesh's ``frames`` axis. Spatial and
cross attention and the 2D convs are frame-local; only the temporal
blocks communicate: Ulysses all_to_all axis swaps (the default) or ring
attention, plus GN statistics over the global frame axis and halo'd
frame convs in either mode (nn/temporal.py, nn/resnet.py). The same
weights run sharded or not.

``sharded_apply`` runs on every rank of the mesh (SPMD, as torchrun
starts them): it takes the GLOBAL sample, which every rank holds, cuts
out its rank's frames, runs the denoiser on them inside the mesh's
binding, and returns the global result, gathered over the frames axis.
"""

from __future__ import annotations

import torch

from vdx_torch.parallel.mesh import Mesh, all_gather, axis_index

SEQ_IMPLS = ("ring", "ulysses")


def check_seq_impl(seq_impl: str) -> None:
    if seq_impl not in SEQ_IMPLS:
        raise ValueError(f"unknown seq_impl {seq_impl!r}")


def make_frame_sharded_denoiser(mesh: Mesh, *, axis: str = "frames",
                                n_conditioning: int = 1,
                                seq_impl: str = "ulysses"):
    """A frame-sharded apply for a denoiser of any family with a
    ``temporal_impl`` forward argument.

    Returns ``sharded_apply(denoiser, sample [B, F, ...], timestep,
    *conditioning, frames_valid=None, pab_refresh=None, pab_cache=None)``:
    ``denoiser`` is the module, whose own weights and settings
    (``attn_impl``, FreeU, the policy) run as they are; ``n_conditioning``
    tensors follow the timestep (1 for the text context, 2 for SVD's
    image_embeds and added_time_ids), replicated. vdx returns (model,
    sharded_apply) and takes a parameter tree; the port's modules carry
    their weights, so the apply takes the module.

    ``seq_impl``: "ulysses" (two all_to_alls around each temporal block;
    sites whose positions do not divide the axis take the ring) or
    "ring" (KV rotation at every temporal attention). ``frames_valid``:
    ragged frame sharding — F was zero-padded to divide the axis and only
    the first ``frames_valid`` frames are real. Under PAB
    (``pab_refresh``) it returns (eps, this rank's attention cache). vdx's
    ``pab`` flag has no counterpart: the port's denoisers take PAB flags
    at every call."""
    check_seq_impl(seq_impl)
    impl = f"{seq_impl}:{axis}"

    def sharded_apply(denoiser: torch.nn.Module, sample: torch.Tensor,
                      timestep, *conditioning, frames_valid=None,
                      pab_refresh=None, pab_cache=None):
        if len(conditioning) != n_conditioning:
            raise TypeError(f"expected {n_conditioning} conditioning tensors, "
                            f"got {len(conditioning)}")
        n = mesh.shape[axis]
        F = sample.shape[1]
        if F % n:
            raise ValueError(f"{F} frames do not divide over the {n} shards of "
                             f"axis {axis!r}: zero-pad them and pass "
                             "frames_valid")
        Fl = F // n
        kw = {"frames_valid": frames_valid, "temporal_impl": impl}
        if pab_refresh is not None:
            kw.update(pab_refresh=pab_refresh, pab_cache=pab_cache)
        with mesh.bind():
            i = axis_index(axis)
            out = denoiser(sample[:, i * Fl:(i + 1) * Fl], timestep,
                           *conditioning, **kw)
            eps, cache = out if pab_refresh is not None else (out, None)
            eps = all_gather(eps, axis, dim=1)
        return eps if pab_refresh is None else (eps, cache)

    return sharded_apply


def make_frame_sharded_unet(mesh: Mesh, *, axis: str = "frames",
                            seq_impl: str = "ulysses"):
    """sharded_apply of a UNetMotion (or UNet3D, Latte: one conditioning
    tensor): sharded_apply(unet, sample [B, F, H, W, C], t, context) ->
    eps [B, F, H, W, C_out]."""
    return make_frame_sharded_denoiser(mesh, axis=axis, seq_impl=seq_impl)


def make_frame_sharded_svd_unet(mesh: Mesh, *, axis: str = "frames",
                                seq_impl: str = "ulysses"):
    """sharded_apply of the SVD UNet: sharded_apply(unet, sample
    [B, F, H, W, 8], t, image_embeds, added_time_ids) -> eps.
    Communication: the temporal transformer blocks (ring or Ulysses), a
    one-frame halo in the temporal resblocks' frame convs, and GN
    statistics over the global frame axis."""
    return make_frame_sharded_denoiser(mesh, axis=axis, n_conditioning=2,
                                       seq_impl=seq_impl)
