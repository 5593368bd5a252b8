"""The port's mesh, collectives and frame-sharded ops against vdx's, on the
CPU in fp32.

* ``auto_mesh``'s factorisation against vdx's for 1, 2, 4 and 8 devices;
  without a process group ``make_mesh`` raises, ``health_check`` is 1, and
  a collective on an axis that no ``Mesh.bind()`` binds raises NameError.
* One spawned 4-rank ``gloo`` group (``initialize`` over a file in
  tmp_path, so xdist workers never share a port; one torch thread a rank;
  a 60 s group timeout, and the ranks joined within RANKS_LIMIT): each
  rank computes its shard of every op and the parent holds the shards
  against vdx's ops under ``shard_map`` on the 8-device CPU mesh (its
  first 4 devices), at ATOL:
  - ``frame_halo_pad`` (zeros at the clip's two ends);
  - the tiled ``all_to_all`` both ways, on inputs with no symmetry (a
    wrong chunk order would permute frames);
  - ``ring_attention`` without ``kv_valid`` and with it, 3 real frames of
    8, so two shards hold only padding, and
    ``make_sharded_temporal_attention``'s global view on every rank;
  - GroupNorm(+SiLU) with ``stats_axis_name`` and GroupNorm with
    ``frame_mask`` (5 real frames of 8) against
    ``vdx.ops.groupnorm.group_norm``;
  - ``health_check() == 4``;
  - ``auto_mesh()`` over the 4 ranks (vdx's 2x2x1) and a video laid out
    on it by ``video_sharding`` (batch over data, frames over frames) and
    ``replicated``, through ``distribute_tensor``.

The worker functions import no jax: the spawned ranks import this module.
"""

import datetime
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

ATOL = 2e-5
N_RANKS = 4
# a rank that fails makes the others' collectives raise at the group's 60 s
# timeout; the parent stops waiting and kills them past this limit
RANKS_LIMIT = 240


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file's tests run (the suite runs several
    workers side by side); restored afterwards for other files."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rank_main(rank, worker, n, init_file, args):
    import torch.distributed as dist

    from vdx_torch.parallel.distributed import initialize

    torch.set_num_threads(1)
    initialize(f"file://{init_file}", n, rank, device="cpu",
               timeout=datetime.timedelta(seconds=60))
    try:
        worker(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(worker, tmp_path, *args, n=N_RANKS, limit=RANKS_LIMIT):
    """Run ``worker(rank, *args)`` on n spawned ranks of a gloo group; an
    exception in any rank fails the test, as do ranks still running after
    ``limit`` seconds. -> the context before joining, (wait) to join."""
    ctx = mp.start_processes(_rank_main,
                             args=(worker, n, str(tmp_path / "pg"), args),
                             nprocs=n, join=False, start_method="spawn")

    def wait():
        deadline = time.monotonic() + limit
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"ranks still running after {limit} s")

    return wait


# ----------------------------------------------------------------------
# the inputs (numpy, one seed) and each rank's shard of the port's ops
# ----------------------------------------------------------------------
F_GLOBAL = 8
RING_VALID = 3
GN_VALID = 5


def _inputs():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"halo": f(2, F_GLOBAL, 3, 2, 5), "a2a": f(8, F_GLOBAL, 3),
            "q": f(2, F_GLOBAL, 2, 4), "k": f(2, F_GLOBAL, 2, 4),
            "v": f(2, F_GLOBAL, 2, 4), "gn": 3 * f(2, F_GLOBAL, 3, 3, 8) + 1,
            "gn_scale": 1 + 0.1 * f(8), "gn_bias": 0.1 * f(8)}


def _ops_worker(rank, out_dir):
    from torch.distributed.tensor import distribute_tensor

    from vdx_torch.nn.frame_shard import frame_validity_mask
    from vdx_torch.ops.groupnorm import group_norm, group_norm_silu
    from vdx_torch.ops.halo import frame_halo_pad
    from vdx_torch.parallel.distributed import health_check
    from vdx_torch.parallel.mesh import (AXES, all_to_all, auto_mesh, axis_index,
                                         make_mesh, replicated, video_sharding)
    from vdx_torch.parallel.ring_attention import (
        make_sharded_temporal_attention, ring_attention)

    mesh = make_mesh(1, N_RANKS, 1)
    x = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    Fl = F_GLOBAL // N_RANKS
    out = {"health": np.int64(health_check()),
           "ring_global": make_sharded_temporal_attention(mesh)(
               x["q"], x["k"], x["v"])}
    with mesh.bind():
        i = axis_index("frames")
        loc = {k: v[:, i * Fl:(i + 1) * Fl] for k, v in x.items() if v.dim() > 1}
        out["halo"] = frame_halo_pad(loc["halo"], "frames")
        swapped = all_to_all(loc["a2a"], "frames", split_axis=0, concat_axis=1)
        out["a2a"] = swapped
        out["a2a_back"] = all_to_all(swapped, "frames", split_axis=1, concat_axis=0)
        out["ring"] = ring_attention(loc["q"], loc["k"], loc["v"], axis_name="frames")
        out["ring_valid"] = ring_attention(
            loc["q"], loc["k"], loc["v"], axis_name="frames",
            kv_valid=frame_validity_mask(Fl, RING_VALID, "frames"))
        s, b = x["gn_scale"], x["gn_bias"]
        out["gn_stats"] = group_norm_silu(loc["gn"], 4, s, b, 1e-6,
                                          stats_axis_name="frames")
        out["gn_mask"] = group_norm(
            loc["gn"], 4, s, b, 1e-6, stats_axis_name="frames",
            frame_mask=frame_validity_mask(Fl, GN_VALID, "frames"))
    # auto_mesh over the 4 ranks (2x2x1) and its two layouts of a video
    am = auto_mesh()
    layout = {"shape": np.int64([am.shape[a] for a in AXES]),
              "coord": np.int64(am.device_mesh.get_coordinate()),
              "video": distribute_tensor(x["halo"], *video_sharding(am)).to_local(),
              "replicated": distribute_tensor(x["halo"], *replicated(am)).to_local()}
    np.savez(f"{out_dir}/rank{rank}.npz",
             **{k: np.asarray(v) for k, v in out.items()})
    np.savez(f"{out_dir}/layout{rank}.npz",
             **{k: np.asarray(v) for k, v in layout.items()})


def _vdx_ops():
    """vdx's ops under shard_map over the frames axis of a 1x4x1 mesh:
    global arrays, each rank's block along the sharded axis."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from vdx.nn.temporal import frame_validity_mask
    from vdx.ops.groupnorm import group_norm, group_norm_silu
    from vdx.ops.halo import frame_halo_pad
    from vdx.parallel.mesh import make_mesh
    from vdx.parallel.ring_attention import (make_sharded_temporal_attention,
                                             ring_attention)

    mesh = make_mesh(1, N_RANKS, 1)
    x = {k: jnp.asarray(v) for k, v in _inputs().items()}
    Fl = F_GLOBAL // N_RANKS

    def sm(fn, n_in, out_spec=P(None, "frames")):
        return jax.jit(shard_map(fn, mesh=mesh, in_specs=(P(None, "frames"),) * n_in,
                                 out_specs=out_spec, check_vma=False))

    a2a = lambda t: jax.lax.all_to_all(t, "frames", 0, 1, tiled=True)  # noqa: E731
    s, b = x["gn_scale"], x["gn_bias"]
    swapped = sm(a2a, 1, P("frames"))(x["a2a"])
    return {
        "halo": sm(lambda t: frame_halo_pad(t, "frames"), 1)(x["halo"]),
        "a2a": swapped,
        "a2a_back": x["a2a"],
        "ring": sm(lambda q, k, v: ring_attention(q, k, v, axis_name="frames"),
                   3)(x["q"], x["k"], x["v"]),
        "ring_valid": sm(lambda q, k, v: ring_attention(
            q, k, v, axis_name="frames",
            kv_valid=frame_validity_mask(Fl, RING_VALID, "frames")), 3)(
                x["q"], x["k"], x["v"]),
        "ring_global": make_sharded_temporal_attention(mesh)(
            x["q"], x["k"], x["v"]),
        "gn_stats": sm(lambda t: group_norm_silu(
            t, 4, s, b, 1e-6, stats_axis_name="frames"), 1)(x["gn"]),
        "gn_mask": sm(lambda t: group_norm(
            t, 4, s, b, 1e-6, stats_axis_name="frames",
            frame_mask=frame_validity_mask(Fl, GN_VALID, "frames")), 1)(x["gn"]),
    }


def test_mesh_layout_and_unbound_axes():
    from vdx.parallel.mesh import auto_mesh as vdx_auto_mesh
    from vdx_torch.parallel import distributed, mesh

    for n in (1, 2, 4, 8):
        want = vdx_auto_mesh(n).shape
        assert mesh.auto_mesh_shape(n) == tuple(want[a] for a in mesh.AXES), n
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_mesh(1, 4, 1)
    assert distributed.health_check() == 1
    assert distributed.initialize() is False  # one process, no torchrun
    x = torch.ones(3)
    for call in (lambda: mesh.psum(x, "frames"), lambda: mesh.axis_size("frames"),
                 lambda: mesh.ppermute(x, "frames", [(0, 1)]),
                 lambda: mesh.all_to_all(x[None], "frames", 0, 1)):
        with pytest.raises(NameError, match="unbound axis name 'frames'"):
            call()


def test_collectives_match_vdx_at_four_ranks(tmp_path):
    wait = spawn(_ops_worker, tmp_path, str(tmp_path))
    want = _vdx_ops()  # while the ranks run
    wait()
    Fl = F_GLOBAL // N_RANKS
    for r in range(N_RANKS):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert int(got["health"]) == N_RANKS
        for name, w in want.items():
            w = np.asarray(w)
            if name == "a2a":  # [P/n, F_global, C] blocks along positions
                blk = w.shape[0] // N_RANKS
                w = w[r * blk:(r + 1) * blk]
            elif name != "ring_global":  # the global view on every rank
                blk = w.shape[1] // N_RANKS
                w = w[:, r * blk:(r + 1) * blk]
            g = got[name]
            assert g.shape == w.shape, (name, r, g.shape, w.shape)
            err = float(np.max(np.abs(g - w)))
            assert np.all(np.isfinite(g)) and err <= ATOL, (name, r, err)
    # the edge shards' halo slots are zeros (the global conv's padding)
    first, last = (np.load(tmp_path / f"rank{r}.npz")["halo"]
                   for r in (0, N_RANKS - 1))
    assert not first[:, 0].any() and not last[:, -1].any()
    assert first.shape[1] == Fl + 2
    # auto_mesh(4) is vdx's 2x2x1; video_sharding puts batch on data and
    # frames on frames, replicated puts the whole video on every rank
    video = _inputs()["halo"]
    coords = set()
    for r in range(N_RANKS):
        got = np.load(tmp_path / f"layout{r}.npz")
        assert got["shape"].tolist() == [2, 2, 1]
        d, f, t = got["coord"].tolist()
        coords.add((d, f, t))
        F2 = F_GLOBAL // 2
        np.testing.assert_array_equal(got["video"],
                                      video[d:d + 1, f * F2:(f + 1) * F2])
        np.testing.assert_array_equal(got["replicated"], video)
    assert coords == {(d, f, 0) for d in range(2) for f in range(2)}
