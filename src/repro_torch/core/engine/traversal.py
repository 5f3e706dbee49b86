"""Device dual traversal and step revalidation.

The port of `repro.core.engine.traversal`.  The dual traversal of one
(target, source) tree pair runs on the planning device over flat cell tables
(`tree.flat_cell_tables`, uploaded once per tree):

  - state is a padded pair frontier `(A, B)` of capacity `Kcap` and the
    number `n` of live pairs;
  - each generation scores the first `roundup(n, 128)` lanes of the frontier
    with the MAC kernel K3 (`kernels.mac.mac_margins`), or with its plain
    version when `use_kernel=False`;
  - accepted, leaf-leaf and truncated pairs append to output buffers through
    mask + exclusive-cumsum positions; child expansion puts target-split
    children first, then source-split ones, so the emitted pair lists are in
    the exact order of the host traversal (`core.traversal.dual_traversal`)
    whenever the float32 MAC decisions agree with its float64 ones.

The reference runs the loop as one `lax.while_loop`; here it is a Python
loop over generations that reads the new frontier size, the three output
counts and nothing else to the host once per generation, in one transfer.
The reference drops out-of-range scatter writes (`mode="drop"`); here every
buffer has one spare slot past its capacity that takes them, and a count
past a capacity is an overflow.  An overflow retries the traversal with
every capacity doubled, and the capacities that worked are remembered per
padded-cell class (`_CAPS_CACHE`).

The traversal also returns the minimum accepted-M2L margin, the slack input
`api._m2l_margin` computes on the host, so a device-planned geometry's MAC
slack budgets take the device margins directly.

Step revalidation (`restack_payload` / `partition_drift`): a within-slack
`FMMSession.step` uploads `new_x` once, restacks it into the engine's
`(P, Nmax, 3)` payload envelope through the frozen global-id tables on the
device, and reduces every partition's drift in one pass; the restacked
payload is the next evaluation's payload.  These are plain `jax.jit`
functions in the reference, and plain tensor operations here.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from repro_torch.core.tree import flat_cell_tables
from repro_torch.device import resolve_device
from repro_torch.kernels import mac as kmac

__all__ = ["device_dual_traversal", "default_traversal_backend",
           "resolve_traversal_backend", "partition_drift", "restack_payload",
           "traversal_caps"]

_TABLE_KEYS = ("center", "radius", "child_start", "n_child", "is_leaf",
               "truncated")


def default_traversal_backend(device=None) -> str:
    """"device" when the planning device is a CUDA device, "host" (the
    float64 NumPy reference) on the CPU — the reference's rule with the
    planning device in place of JAX's default backend."""
    return "device" if resolve_device(device).type == "cuda" else "host"


def resolve_traversal_backend(backend: str | None, device=None) -> str:
    """None and "auto" resolve through `default_traversal_backend(device)`;
    "host" and "device" are taken as given; anything else raises."""
    if backend in (None, "auto"):
        return default_traversal_backend(device)
    if backend not in ("host", "device"):
        raise ValueError(f"traversal_backend must be 'host', 'device' or "
                         f"'auto', got {backend!r}")
    return backend


# The reference's starting multipliers of the padded cell count (frontier,
# m2l, p2p, m2p), measured there on sphere/plummer/cube at theta = 0.5;
# overflow-doubled capacities are remembered per padded-cell class.
_CAP_MULT = (32, 64, 32, 2)
_CAPS_CACHE: dict[int, tuple] = {}


def traversal_caps(pad_cells: int) -> tuple:
    """(frontier, m2l, p2p, m2p) capacities: powers of two, at least the
    MAC kernel's 128-lane block, shared by every pair of one geometry.
    Serves the last overflow-doubled choice for this padded-cell class when
    one is cached."""
    hit = _CAPS_CACHE.get(int(pad_cells))
    if hit is not None:
        return hit

    def cap(k):
        return max(128, 1 << int(np.ceil(np.log2(max(k, 1)))))
    return tuple(cap(m * pad_cells) for m in _CAP_MULT)


# ------------------------------------------------------------------ loop ---
def _traversal_loop(tt, ts, *, theta: float, caps: tuple, use_kernel: bool):
    """The whole dual traversal of one tree pair on the tables' device.
    Returns (m2l (2, n), p2p, m2p, min_margin, overflow): pair tensors cut
    to their counts, the minimum accepted margin as a float32 scalar tensor,
    and whether a capacity overflowed (the outputs are then incomplete)."""
    Kcap, Mcap, Pcap, Qcap = caps
    dev = tt["radius"].device
    i64 = torch.int64
    score = kmac.mac_margins if use_kernel else kmac.mac_margins_ref
    col = torch.arange(8, dtype=i64, device=dev)[None, :]  # <= 8 children
    inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    # one spare slot past each capacity takes the writes the reference drops
    out = {k: torch.zeros(2, c + 1, dtype=i64, device=dev)
           for k, c in (("m2l", Mcap), ("p2p", Pcap), ("m2p", Qcap))}
    count = {"m2l": 0, "p2p": 0, "m2p": 0}
    cap = {"m2l": Mcap, "p2p": Pcap, "m2p": Qcap}
    A = torch.zeros(Kcap + 1, dtype=i64, device=dev)
    B = torch.zeros(Kcap + 1, dtype=i64, device=dev)
    n = 1
    min_margin = inf
    while n > 0:
        K = -(-n // kmac.MAC_BLOCK) * kmac.MAC_BLOCK
        a, b = A[:K], B[:K]
        valid = torch.arange(K, dtype=i64, device=dev) < n
        ra, rb = tt["radius"][a], ts["radius"][b]
        margin = score(tt["center"][a], ra, ts["center"][b], rb, theta)
        far = valid & (margin > 0)
        min_margin = torch.minimum(min_margin,
                                   torch.where(far, margin, inf).min())
        leaf_t, leaf_s = tt["is_leaf"][a], ts["is_leaf"][b]
        both_leaf = valid & ~far & leaf_t & leaf_s
        trunc = both_leaf & ts["truncated"][b]
        sums = []
        for key, mask in (("m2l", far), ("p2p", both_leaf & ~trunc),
                          ("m2p", trunc)):
            m = mask.to(i64)
            pos = count[key] + torch.cumsum(m, 0) - m     # exclusive prefix
            idx = torch.where(mask, pos, cap[key]).clamp_(max=cap[key])
            out[key][:, idx] = torch.stack([a, b])
            sums.append(m.sum())

        # split the larger cell (or the only splittable one): target-split
        # children first, then source-split, as the host loop orders them
        rem = valid & ~far & ~both_leaf
        split_t = rem & ~leaf_t & (leaf_s | (ra >= rb))
        split_s = rem & ~split_t
        nt = torch.where(split_t, tt["n_child"][a], 0).to(i64)
        ns = torch.where(split_s, ts["n_child"][b], 0).to(i64)
        total_t = nt.sum()
        off = torch.where(split_t, torch.cumsum(nt, 0) - nt,
                          total_t + torch.cumsum(ns, 0) - ns)
        pos = torch.where(col < (nt + ns)[:, None], off[:, None] + col,
                          Kcap).clamp_(max=Kcap).reshape(-1)
        st = split_t[:, None]
        newA = torch.where(st, tt["child_start"][a].to(i64)[:, None] + col,
                           a[:, None])
        newB = torch.where(st, b[:, None],
                           ts["child_start"][b].to(i64)[:, None] + col)
        A = torch.zeros(Kcap + 1, dtype=i64, device=dev)
        B = torch.zeros(Kcap + 1, dtype=i64, device=dev)
        A.index_put_((pos,), newA.reshape(-1))
        B.index_put_((pos,), newB.reshape(-1))

        # the one device -> host read of the generation
        n, *added = torch.stack([total_t + ns.sum(), *sums]).tolist()
        for key, k in zip(("m2l", "p2p", "m2p"), added):
            count[key] += k
        if n > Kcap or any(count[k] > cap[k] for k in count):
            return None, None, None, min_margin, True
    pairs = [out[k][:, :count[k]] for k in ("m2l", "p2p", "m2p")]
    return (*pairs, min_margin, False)


# ----------------------------------------------------------- host wrapper ---
def _as_device_tables(tables: dict, device) -> dict:
    dev = {k: torch.as_tensor(tables[k], device=device) for k in _TABLE_KEYS}
    dev["child_start"] = dev["child_start"].to(torch.int64)
    return dev


# (id(tree), pad_cells, device) -> (weakref anchor, device tables).
# plan_geometry traverses every receiver tree against its senders and
# itself; the memo uploads each tree's flat tables once.  Entries evict
# themselves when the tree dies.  Grafted LET views are not memoised: each
# is traversed once but lives as long as its geometry, so caching would pin
# O(P^2 * pad_cells) device tables with no reuse.
_TREE_TABLE_CACHE: dict = {}


def _device_tables_for(tree, pad_cells: int | None, device) -> dict:
    if getattr(tree, "truncated", None) is not None:    # grafted LET view
        return _as_device_tables(flat_cell_tables(tree, pad_cells=pad_cells),
                                 device)
    key = (id(tree), pad_cells, str(device))
    hit = _TREE_TABLE_CACHE.get(key)
    if hit is not None:
        return hit[1]
    dev = _as_device_tables(flat_cell_tables(tree, pad_cells=pad_cells),
                            device)
    try:
        anchor = weakref.ref(tree,
                             lambda _, k=key: _TREE_TABLE_CACHE.pop(k, None))
    except TypeError:
        anchor = tree
    _TREE_TABLE_CACHE[key] = (anchor, dev)
    return dev


def device_dual_traversal(tgt_tree, src_tree, theta: float = 0.5,
                          with_m2p: bool = False, *,
                          pad_cells: int | None = None,
                          use_kernel: bool = True, device=None,
                          max_retries: int = 8):
    """Dual traversal of one (target, source) tree pair on `device` (None:
    the card).

    Returns `(m2l, p2p, m2p, min_margin)`: `(*, 2)` int64 host pair arrays in
    the exact emission order of the host traversal, and the minimum accepted
    M2L margin `theta*d - (Ra+Rb)` (float32 arithmetic; +inf when no pair
    was accepted).  `use_kernel=False` scores with the plain version instead
    of the K3 wrapper (which itself runs the plain version on the CPU).
    With `with_m2p=False`, truncated source cells are a contract violation.
    Overflowing a capacity retries with every capacity doubled, at most
    `max_retries` times."""
    dev = resolve_device(device)
    tt = _device_tables_for(tgt_tree, pad_cells, dev)
    ts = tt if src_tree is tgt_tree else _device_tables_for(src_tree,
                                                           pad_cells, dev)
    pad_class = max(tt["radius"].shape[0], ts["radius"].shape[0])
    caps = traversal_caps(pad_class)
    grew = False
    for _ in range(max_retries + 1):
        m2l, p2p, m2p, min_margin, overflow = _traversal_loop(
            tt, ts, theta=float(theta), caps=caps, use_kernel=use_kernel)
        if not overflow:
            if grew:        # remember only capacities that actually worked
                _CAPS_CACHE[int(pad_class)] = caps
            break
        caps = tuple(2 * c for c in caps)
        grew = True
    else:
        raise RuntimeError(f"device traversal overflowed after "
                           f"{max_retries} capacity doublings")

    sizes = [m2l.shape[1], p2p.shape[1], m2p.shape[1]]
    flat = np.ascontiguousarray(torch.cat([m2l, p2p, m2p], dim=1).T.cpu())
    m2l_h, p2p_h, m2p_h = np.split(flat, np.cumsum(sizes)[:2])
    if not with_m2p and len(m2p_h):
        raise AssertionError("truncated source cells require with_m2p=True")
    return m2l_h, p2p_h, m2p_h, float(min_margin)


# ------------------------------------------------------ step revalidation ---
def restack_payload(new, orig_idx, flat_idx, n_parts: int,
                    n_bodies_max: int):
    """Scatter an original-order device tensor (N, ...) into the engine's
    stacked `(P, Nmax, ...)` float32 payload envelope — the device-side
    `schedules.stack_bodies`, fed by the uploaded `new_x` directly."""
    tail = tuple(new.shape[1:])
    flat = torch.zeros((n_parts * n_bodies_max,) + tail, dtype=torch.float32,
                       device=new.device)
    flat[flat_idx] = new[orig_idx].to(torch.float32)
    return flat.reshape((n_parts, n_bodies_max) + tail)


def partition_drift(x_pad, ref_pad, old_pad):
    """Per-partition drift `max_i |x_i - x_ref_i|` against the structure
    reference and a changed-since-last-payload mask, for all partitions at
    once.  Padded rows are zero in all three and add drift 0 / unchanged."""
    drift = ((x_pad - ref_pad) ** 2).sum(-1).amax(1).sqrt()
    changed = (x_pad - old_pad).abs().amax(dim=(1, 2)) > 0
    return drift, changed
