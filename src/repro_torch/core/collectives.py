"""The paper's communication patterns as collectives over a named mesh,
the port of `repro.core.collectives`.

These are the device-level expressions of the paper's three ideas, shared
with the FMM's exchange (`core.dist`) and used by the LM tier:

  granularity (§4.1)  -> ring collectives hop by hop, so a consumer can
                         work on each chunk as it arrives (the analogue of
                         subtree-grained LET messages);
  HSDX relay  (§4.2)  -> hierarchical collectives: an intra-pod stage
                         first, then a small inter-pod stage over the `pod`
                         axis (relaying through "neighbor" groups);
  pairwise    (§4.3)  -> ring / grid ppermute schedules in which every
                         transfer goes to a direct neighbour.

The reference writes them for use inside `shard_map` (they read the axis
index and size of the rank that runs them).  The port's take the mesh and
the axis names instead and work on the buffers of every rank a process
holds, stacked on a leading axis L (all D ranks of a stacked mesh, or this
process's one rank of a group mesh), as `core.dist` does.  A rank's own
shape below is written without L.  The rings keep the reference's hop
order and chunk order, so their sums add in the same order, and both
meshes give the same bits.  What the reference says about ICI links is
the TPU's: here each function states what crosses each axis, not how fast.
"""
from __future__ import annotations

import torch

__all__ = [
    "ring_all_gather", "ring_reduce_scatter", "hierarchical_all_reduce",
    "two_stage_all_to_all", "all_gather_matmul_overlapped",
    "neighbor_exchange", "hsdx_grid_exchange",
]


def _take(buf: torch.Tensor, idx) -> torch.Tensor:
    """(L, n, ...) -> (L, ...): row idx[l] of each local rank l."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    return buf[rows, torch.as_tensor(idx, device=buf.device)]


def ring_all_gather(x, mesh, axis_name: str, *, reverse: bool = False):
    """All-gather via N-1 neighbor ppermutes (a contention-free ring;
    §4.3).  x: (d, ...) a rank -> (N*d, ...) in rank order."""
    n = mesh.axis_size(axis_name)
    if n == 1:
        return x
    perm = [((i + 1) % n, i) for i in range(n)] if not reverse else \
           [(i, (i + 1) % n) for i in range(n)]
    hops, buf = [x], x
    for _ in range(n - 1):
        buf = mesh.ppermute(buf, perm, axis_name)
        hops.append(buf)
    chunks = torch.stack(hops, 1)                          # (L, n, d, ...)
    me = torch.as_tensor(mesh.axis_index(axis_name))
    t = torch.arange(n)
    # chunk t came from rank (me + t) mod n (for the chosen ring direction)
    src = (me[:, None] + t) % n if not reverse else (me[:, None] - t) % n
    order = torch.argsort(src, dim=1).to(x.device)
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    chunks = chunks[rows, order]
    return chunks.reshape(x.shape[0], n * x.shape[1], *x.shape[2:])


def ring_reduce_scatter(x, mesh, axis_name: str):
    """Reduce-scatter via N-1 neighbor ppermutes.  x: (N*d, ...) a rank ->
    (d, ...).  Rank r's chunk is summed along the ring starting after r:
    ((0 + x_{r+1}) + x_{r+2}) + ... + x_r, the reference's order."""
    n = mesh.axis_size(axis_name)
    if n == 1:
        return x
    L, d = x.shape[0], x.shape[1] // n
    me = mesh.axis_index(axis_name)
    parts = x.reshape(L, n, d, *x.shape[2:])
    perm = [(i, (i + 1) % n) for i in range(n)]
    acc = torch.zeros((L, d) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    for t in range(n - 1):
        # at step t, rank r holds the partial sum for chunk (r - t - 1) mod
        # n; add the local contribution for that chunk and pass it on
        acc = acc + _take(parts, [(m - t - 1) % n for m in me])
        acc = mesh.ppermute(acc, perm, axis_name)
    return acc + _take(parts, me)


def _stage(stats, name: str, axes, nbytes: int) -> None:
    if stats is not None:
        stats.append({"stage": name, "axes": tuple(axes),
                      "bytes_per_rank": int(nbytes)})


def hierarchical_all_reduce(x, mesh, inner_axis: str,
                            outer_axis: str | None, *, stats=None):
    """HSDX-shaped all-reduce of x (any shape a rank): reduce-scatter over
    the dense intra-pod axis, an all-reduce of the 1/|inner| slice across
    pods, all-gather back over the inner axis.  The reference's padding:
    the flattened buffer is padded to a multiple of |inner|.

    With a list as `stats`, each stage appends {"stage", "axes",
    "bytes_per_rank"}: the payload one rank puts into that stage (its
    buffer for the reduce-scatter, its reduced slice for the other two).
    The outer stage carries 1/|inner| of what a flat all-reduce over both
    axes would carry across them (`outer_axis=None` with both axes, one
    stage of the whole buffer)."""
    L, item = x.shape[0], x.element_size()
    if outer_axis is None:
        _stage(stats, "all_reduce", (inner_axis,) if isinstance(
            inner_axis, str) else inner_axis, x[0].numel() * item)
        return mesh.psum(x, inner_axis)
    flat = x.reshape(L, -1)
    n = mesh.axis_size(inner_axis)
    pad = (-flat.shape[1]) % n
    flat = torch.nn.functional.pad(flat, (0, pad))
    _stage(stats, "reduce_scatter", (inner_axis,), flat[0].numel() * item)
    part = mesh.psum_scatter(flat.reshape(L, n, -1), inner_axis)
    _stage(stats, "all_reduce", (outer_axis,), part[0].numel() * item)
    part = mesh.psum(part, outer_axis)
    _stage(stats, "all_gather", (inner_axis,), part[0].numel() * item)
    full = mesh.all_gather(part, inner_axis)
    flat = full.reshape(L, -1)
    if pad:
        flat = flat[:, :-pad]
    return flat.reshape(x.shape)


def two_stage_all_to_all(x, mesh, inner_axis: str, outer_axis: str,
                         split_axis: int = 0, concat_axis: int = 0):
    """Hierarchical all-to-all (the HSDX relay applied to MoE dispatch):
    stage 1 exchanges within the pod, stage 2 across pods; the flat
    all-to-all over both axes is the baseline.  A rank's split axis must
    be a multiple of n_inner * n_outer (destination-major: index = outer *
    n_inner + inner); the result equals the flat all-to-all over (outer,
    inner)."""
    n_in = mesh.axis_size(inner_axis)
    n_out = mesh.axis_size(outer_axis)
    lead = x.shape[1 + split_axis]
    if lead % (n_in * n_out):
        raise ValueError(f"two_stage_all_to_all: split axis of {lead} is "
                         f"not a multiple of {n_in} x {n_out} ranks")
    L = x.shape[0]
    x = x.movedim(1 + split_axis, 1)
    rest = x.shape[2:]
    x = x.reshape(L, n_out, n_in, -1, *rest)
    x = mesh.all_to_all(x, inner_axis, dim=1)     # the intra-pod stage
    x = mesh.all_to_all(x, outer_axis, dim=0)     # the inter-pod stage
    x = x.reshape(L, lead, *rest)
    x = x.movedim(1, 1 + split_axis)
    if concat_axis != split_axis:
        x = x.movedim(1 + split_axis, 1 + concat_axis)
    return x


def all_gather_matmul_overlapped(x, w, mesh, axis_name: str):
    """y = all_gather(x, axis) @ w, as ring hops: chunk t's product is
    taken while hop t+1 is under way (the granularity knob at its optimum
    rather than the bulk-synchronous extreme).

    x: (m, k) a rank, its shard of the gathered dim; w: (k, n), the same
    on every rank.  Returns (N*m, n) a rank, rows in rank order.  Each
    chunk is multiplied by itself, one product a rank, so the stacked and
    the group mesh give the same bits."""
    n_dev = mesh.axis_size(axis_name)
    me = mesh.axis_index(axis_name)
    perm = [((i + 1) % n_dev, i) for i in range(n_dev)]
    L, m = x.shape[0], x.shape[1]
    out = torch.zeros((L, n_dev, m, w.shape[-1]),
                      dtype=torch.result_type(x, w), device=x.device)
    rows = torch.arange(L, device=x.device)
    buf = x
    for t in range(n_dev):
        nxt = mesh.ppermute(buf, perm, axis_name) if t < n_dev - 1 else None
        y = torch.stack([b @ w for b in buf.unbind(0)])
        src = torch.as_tensor([(i + t) % n_dev for i in me], device=x.device)
        out = out.index_put((rows, src), y)
        buf = nxt
    return out.reshape(L, n_dev * m, -1)


def neighbor_exchange(x, mesh, axis_name: str, shift: int = 1):
    """One HSDX hop: send to the +shift ring neighbor (direct link only)."""
    n = mesh.axis_size(axis_name)
    perm = [(i, (i + shift) % n) for i in range(n)]
    return mesh.ppermute(x, perm, axis_name)


def grid_offsets() -> list:
    """The 26 offsets of a 3-D grid neighbourhood, in the reference's
    order."""
    return [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1) if (dx, dy, dz) != (0, 0, 0)]


def hsdx_grid_exchange(buf, mesh, axis_name: str, grid_shape,
                       stages: int = 1):
    """HSDX on a process grid laid out along a flat axis: at each stage
    every rank exchanges with its 3^3 - 1 grid neighbours (Algorithm 1's
    per-level Neighbor_alltoallv), one ppermute per neighbour offset (each
    offset a full permutation, with the torus wrap).

    buf: (...) a rank.  Returns (stages, 26, ...) a rank: what arrived from
    each offset at each stage; the next stage relays the mean of a stage's
    26 payloads (added in offset order, times 1/26: a product, which every
    device rounds alike)."""
    gx, gy, gz = grid_shape
    n = gx * gy * gz
    coords = [(i // (gy * gz), (i // gz) % gy, i % gz) for i in range(n)]
    recv_stages = []
    x = buf
    for _ in range(stages):
        recvs = []
        for dx, dy, dz in grid_offsets():
            perm = []
            for i, (cx, cy, cz) in enumerate(coords):
                tx, ty, tz = (cx + dx) % gx, (cy + dy) % gy, (cz + dz) % gz
                perm.append((i, tx * gy * gz + ty * gz + tz))
            recvs.append(mesh.ppermute(x, perm, axis_name))
        stage_recv = torch.stack(recvs, 1)                # (L, 26, ...)
        acc = recvs[0]
        for r in recvs[1:]:
            acc = acc + r
        x = acc * (1.0 / len(recvs))                      # relay aggregate
        recv_stages.append(stage_recv)
    return torch.stack(recv_stages, 1)
