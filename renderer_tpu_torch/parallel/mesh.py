"""Multi-device frame rendering over torch.distributed.

Every rank runs the same function on its own device, which is what the body
of a `shard_map` is. The decomposition of a tile rasterizer:

- **tp (vertex parallel)**: rank i transforms its slice VE/n of the
  expanded vertex stream, then every output of the vertex stage is
  all-gathered, so every rank holds the whole post-transform vertex set.
- **sp (screen parallel)**: each rank rasterizes, shades and composites its
  own tile rows; binning is shard-local (stage-1 row expansion clipped to
  the band, binning.bin_triangle_classes `tile_row_lo`/`row_stride`).
  Rows are a contiguous band per rank by default, or round-robin
  (`interleave=True`: rank i owns tile rows {i + k·n}) for load balance.
  The bands are all-gathered into the whole u8 image, de-interleaved when
  interleaved. Triangle setup stays replicated: it is cheaper to recompute
  than its output is to gather.
- **dp**: a leading batch of frames (cameras, animation times) over a
  second mesh dimension; each dp group renders one frame over its sp ranks.

A mesh is this rank's process groups (`make_mesh`, `make_mesh_2d`). The
caller initialises torch.distributed and picks the backend: NCCL with one
rank per GPU; gloo where ranks share a card or run on the CPU (gloo's
collectives take CUDA tensors and stage them through the host). There is
no automatic switch. `spawn` starts ranks in processes of their own.
"""

from __future__ import annotations

import math
import os
import time
import traceback
from dataclasses import dataclass, replace

import torch
import torch.distributed as dist

from renderer_tpu_torch.core import constants
from renderer_tpu_torch.core.config import RenderConfig
from renderer_tpu_torch.raster import pipeline, vertex_stage

_I_DEMAND = pipeline.STAT_NAMES.index("masked_demand_max")  # 9
_I_ROWS = pipeline.STAT_NAMES.index("total_rows")  # 13


def _combine_shard_stats(stats: torch.Tensor, group) -> torch.Tensor:
    """Reduce one shard's stats vector over the sp group. Binning runs
    per shard, so every count stat (overflow [0:4], saturated pixels [4:8],
    total_pairs [8], total_rows and row_overflow [13:]) is a partition of
    the single-device value and sums to it exactly; the per-pixel demand
    peaks [9:13] are per-shard maxima and reduce by MAX. Capacity knobs are
    per-device buffers under sharding (see per_shard_config)."""
    summed = stats.clone()
    peaks = stats.clone()
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(peaks, op=dist.ReduceOp.MAX, group=group)
    return torch.cat([summed[:_I_DEMAND], peaks[_I_DEMAND:_I_ROWS], summed[_I_ROWS:]])


def per_shard_config(config: RenderConfig, sp: int, *,
                     headroom: float = 2.0,
                     floor: int = 1 << 14) -> RenderConfig:
    """Size the per-device binning buckets to the per-shard demand: under
    sp the shards partition the full-screen expansion exactly, so pair and
    row buckets hold ceil(full/sp)·headroom, rounded up to a power of two,
    floored, and never above the full-screen bucket. Headroom absorbs
    content imbalance; overflow stays loud and demand-fed either way."""

    def shrink(cap: int) -> int:
        need = int(math.ceil(cap / sp * headroom))
        b = 1
        while b < need:
            b *= 2
        # floor inside the cap: the full-screen bucket already bounds the
        # per-shard demand, so never exceed it even when floor > need
        return min(max(b, floor), cap)

    return replace(config, pair_capacity=shrink(config.pair_capacity),
                   row_capacity=shrink(config.row_capacity)).validate()


@dataclass
class Mesh:
    """This rank's view of a device mesh: the size of each named dimension,
    its index along each, and its process group along each."""

    shape: dict  # dim name -> size
    index: dict  # dim name -> this rank's index along it
    groups: dict  # dim name -> process group of the ranks that share the others

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)


def _groups_of(blocks):
    """Create one process group per rank list, on every rank, in the same
    order (torch.distributed requires it); return this rank's group."""
    rank = dist.get_rank()
    mine = None
    for ranks in blocks:
        g = dist.new_group(ranks=list(ranks))
        if rank in ranks:
            mine = g
    return mine


def make_mesh(n_devices: int | None = None, axis: str = "sp") -> Mesh:
    """A 1-D mesh of n ranks. The world is split into consecutive blocks of
    n ranks, each a mesh of its own that renders the same frame (n defaults
    to the world size). Its groups use the default group's backend."""
    world = dist.get_world_size()
    n = n_devices or world
    if world % n:
        raise ValueError(f"make_mesh: world size {world} is not a multiple of {n}")
    rank = dist.get_rank()
    blocks = [range(b * n, (b + 1) * n) for b in range(world // n)]
    return Mesh({axis: n}, {axis: rank % n}, {axis: _groups_of(blocks)})


def make_mesh_2d(dp: int, sp: int) -> Mesh:
    """A ("dp", "sp") mesh over dp·sp ranks: rank r has dp index r // sp and
    sp index r % sp ('dp' batches frames, 'sp' splits each frame's tile
    rows)."""
    world = dist.get_world_size()
    if world != dp * sp:
        raise ValueError(f"make_mesh_2d: need {dp * sp} ranks, have {world}")
    rank = dist.get_rank()
    sp_blocks = [range(d * sp, (d + 1) * sp) for d in range(dp)]
    dp_blocks = [range(s, dp * sp, sp) for s in range(sp)]
    return Mesh({"dp": dp, "sp": sp}, {"dp": rank // sp, "sp": rank % sp},
                {"sp": _groups_of(sp_blocks), "dp": _groups_of(dp_blocks)})


def _all_gather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """Concatenate every rank's `t` along dim 0, in group-rank order."""
    t = t.contiguous()
    if t.dtype == torch.bool:  # gloo has no bool collectives
        return _all_gather(t.to(torch.uint8), group, n).bool()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


def _check_shape(config: RenderConfig, sp: int, ve: int) -> None:
    assert config.tiles_y % sp == 0, (
        f"tiles_y={config.tiles_y} must divide over {sp} devices")
    assert config.height % sp == 0, f"height={config.height} must divide over {sp} devices"
    assert config.height == config.padded_height, (
        "sharded rendering requires height to be a multiple of tile_h "
        f"(height={config.height}, tile_h={config.tile_h})")
    assert ve % sp == 0, f"VE={ve} must divide over {sp} devices"


def _render_band(geom, frame, materials, *, config, axis, mesh, has_masked,
                 has_blended, morph_k, joint_cap, interleave):
    """One rank's share of one frame: its vertex slice (gathered), its band
    of tile rows, the stats combined over the sp group and the bands
    gathered into the whole image. Returns (u8 [H, W, 3], stats)."""
    from renderer_tpu_torch.scene.draw_stream import unpack_frame

    n = mesh.shape[axis]
    i = mesh.index[axis]
    group = mesh.groups[axis]
    ve = geom["exp_src"].shape[0]
    _check_shape(config, n, ve)
    local_tiles_y = config.tiles_y // n

    frame = unpack_frame(frame, morph_k=morph_k, joint_cap=joint_cap)
    # tp: transform a vertex slice, all-gather the results
    per = ve // n
    lgeom = dict(geom)
    lgeom["exp_src"] = geom["exp_src"][i * per : (i + 1) * per]
    lgeom["exp_draw"] = geom["exp_draw"][i * per : (i + 1) * per]
    vs_local = vertex_stage.run_vertex_stage(lgeom, frame, skin_start=None,
                                             morph_k=morph_k)
    vs = {k: _all_gather(v, group, n) for k, v in vs_local.items()}

    # sp: raster + shade + composite on this rank's tile rows
    band, stats = pipeline.render_shard(
        geom, frame, materials, vs,
        config=config,
        has_masked=has_masked,
        has_blended=has_blended,
        local_tiles_y=local_tiles_y,
        tile_row_offset=(i if interleave else i * local_tiles_y),
        row_stride=(n if interleave else 1),
        out_rows=config.height // n,
    )
    stats = _combine_shard_stats(stats, group)
    img = _all_gather(band, group, n)  # [n · rows, W, 3], band after band
    if interleave:
        # rank d's band holds global tile rows {d + k·n}: de-interleave
        # [n, L·th, W, 3] → [L, n, th, W, 3] → [H, W, 3]
        th = config.tile_h
        img = img.reshape(n, local_tiles_y, th, config.width, 3)
        img = img.transpose(0, 1).reshape(config.height, config.width, 3)
    return img, stats


def render_frame_sharded(
    geom: dict,
    frame: dict,
    materials: dict,
    *,
    config: RenderConfig,
    mesh: Mesh,
    has_masked: bool = True,
    has_blended: bool = True,
    morph_k: int = 0,
    joint_cap: int = constants.MAX_JOINT_COUNT,
    interleave: bool = False,
):
    """The whole frame over a 1-D mesh, called by every rank of it with the
    same (replicated) inputs on its own device. Returns, on every rank, the
    u8 image [H, W, 3] and stats i32[N_STATS] (count stats summed, demand
    peaks maxed over the shards: _combine_shard_stats).

    `interleave=False` gives each rank a contiguous band of tile rows;
    `interleave=True` assigns tile rows round-robin (rank d owns rows
    {d + k·n}), which spreads screen content near-uniformly over the ranks."""
    (axis,) = mesh.axis_names
    return _render_band(geom, frame, materials, config=config, axis=axis, mesh=mesh,
                        has_masked=has_masked, has_blended=has_blended,
                        morph_k=morph_k, joint_cap=joint_cap, interleave=interleave)


def render_frames_batched(
    geom: dict,
    frames: dict,  # per-frame tensors with a leading batch axis [B, ...]
    materials: dict,
    *,
    config: RenderConfig,
    mesh: Mesh,  # ("dp", "sp") mesh with dp == B
    has_masked: bool = True,
    has_blended: bool = True,
    morph_k: int = 0,
    joint_cap: int = constants.MAX_JOINT_COUNT,
    interleave: bool = False,
):
    """dp × sp rendering: dp group d renders frame d of the batch (its own
    camera, transforms and joints over the shared geometry and materials),
    split over its sp ranks as render_frame_sharded does. Returns, on every
    rank, u8 [B, H, W, 3] and stats i32 [B, N_STATS], each frame's stats
    combined over sp, so overflow anywhere in the batch is loud (check the
    max over the batch axis, the render_frames_device policy)."""
    dp = mesh.shape["dp"]
    batch = next(iter(frames.values())).shape[0]
    assert batch == dp, f"frame batch {batch} must equal dp={dp}"
    d = mesh.index["dp"]
    frame = {k: v[d] for k, v in frames.items()}
    img, stats = _render_band(geom, frame, materials, config=config, axis="sp",
                              mesh=mesh, has_masked=has_masked,
                              has_blended=has_blended, morph_k=morph_k,
                              joint_cap=joint_cap, interleave=interleave)
    imgs = _all_gather(img[None], mesh.groups["dp"], dp)
    all_stats = _all_gather(stats[None], mesh.groups["dp"], dp)
    return imgs, all_stats


def frame_inputs(renderer, scene, debug_mode: int = 0):
    """The device inputs of one frame of `scene` on `renderer`'s device, as
    Renderer.render_frame_device builds them: (geometry stream, geom
    tensors, frame {"blob"}, materials, joint_cap)."""
    from renderer_tpu_torch.scene import draw_stream

    fv = draw_stream.frame_view(scene)
    gs, geom = renderer._geometry(scene, fv.order, fv.geom_key)
    frame = renderer._frame_arrays(scene, fv, gs, debug_mode)
    return gs, geom, frame, renderer._materials(), renderer._joint_cap(scene)


# -- ranks in processes of their own -----------------------------------------


def _rank_main(rank, world, fn, args, backend, init_method, threads, queue):
    try:
        torch.set_num_threads(threads)
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        queue.put((rank, True, out))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, world_size: int, *args, store_dir, backend: str = "gloo",
          threads: int = 1, timeout: float = 600.0) -> list:
    """Run fn(rank, *args) on `world_size` ranks, each a spawned process
    with the default process group initialised (`backend`, a FileStore in
    `store_dir`, `threads` torch threads). `fn` must be a module-level
    function and its result picklable. Returns the results in rank order;
    raises with a failing rank's traceback, and stops every process it
    started."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = os.path.join(os.fspath(store_dir), "store")
    if os.path.exists(store):
        os.remove(store)
    init_method = f"file://{store}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, fn, args, backend, init_method, threads, q))
             for r in range(world_size)]
    for p in procs:
        p.start()
    results: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world_size:
            try:
                rank, ok, out = q.get(timeout=1.0)
            except queue_mod.Empty:
                # a rank that died before it could answer (at start-up, or
                # killed) would otherwise leave the others waiting forever
                dead = [r for r, p in enumerate(procs)
                        if r not in results and not p.is_alive()]
                if dead:
                    raise RuntimeError(f"spawn: rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} without answering")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"spawn: no result in {timeout} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            results[rank] = out
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return [results[r] for r in range(world_size)]
