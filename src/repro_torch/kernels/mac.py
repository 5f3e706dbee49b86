"""K3: the MAC margin of a pair frontier, its plain version and its wrapper.

The device dual traversal (`repro_torch.core.engine.traversal`) scores every
undecided (target, source) cell pair of a frontier generation with

    margin = theta * |c_A - c_B| - (R_A + R_B)        (accepted iff > 0)

`mac_margins` replaces the Pallas TPU kernel `repro.kernels.mac.mac_margins`
with the hand-written CUDA kernel `csrc/mac.cu` (sm_90a, bound through
ctypes).  On this card it is bound by device-memory bytes: 36 bytes per pair
(two centers, two radii, one margin) against about a dozen float32
operations; at frontier sizes it sits near launch latency.  One thread
scores one pair, reading its own inputs once and writing one float (see the
note in the source).

`mac_margins_ref` is the plain PyTorch version, written as the same
elementwise steps in the same order, `d = sqrt((dx*dx + dy*dy) + dz*dz)`,
`theta*d - (ra + rb)`, with theta rounded to float32.  Each step is one
correctly rounded float32 operation, and the kernel rounds the same steps
explicitly, so the two agree bit for bit: the margin's sign decides which
pairs the traversal accepts.  The wrapper runs the plain version for tensors
on the CPU and launches the kernel for tensors on a CUDA device.

`launches` counts kernel launches: the wrapper adds one where it launches
the kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import library

__all__ = ["mac_margins", "mac_margins_ref", "MAC_BLOCK"]

MAC_BLOCK = 128                 # frontier lengths are multiples of this

launches = 0


def mac_margins_ref(ca, ra, cb, rb, theta: float):
    """Plain version: ca/cb (K, 3), ra/rb (K,) float32 -> (K,) float32, any
    K."""
    dx = ca[:, 0] - cb[:, 0]
    dy = ca[:, 1] - cb[:, 1]
    dz = ca[:, 2] - cb[:, 2]
    d = torch.sqrt((dx * dx + dy * dy) + dz * dz)
    th = torch.full((), theta, dtype=torch.float32, device=ra.device)
    return th * d - (ra + rb)


def _check(ca, ra, cb, rb):
    K = ra.shape[0] if ra.dim() == 1 else -1
    if ca.shape != (K, 3) or cb.shape != (K, 3) or rb.shape != (K,):
        raise ValueError(f"mac_margins: expected ca/cb (K, 3) and ra/rb (K,); "
                         f"got {tuple(ca.shape)}, {tuple(ra.shape)}, "
                         f"{tuple(cb.shape)}, {tuple(rb.shape)}")
    if K % MAC_BLOCK != 0:
        raise ValueError(f"frontier length {K} not a multiple of {MAC_BLOCK}")
    for name, t in (("ca", ca), ("ra", ra), ("cb", cb), ("rb", rb)):
        if t.dtype != torch.float32:
            raise TypeError(f"mac_margins: {name} must be float32, got "
                            f"{t.dtype}")
    if not (ca.device == ra.device == cb.device == rb.device):
        raise ValueError(f"mac_margins: inputs on different devices: "
                         f"{ca.device}, {ra.device}, {cb.device}, "
                         f"{rb.device}")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = library("mac.cu")
    lib.repro_mac_margins.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_float, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    lib.repro_mac_margins.restype = ctypes.c_int
    lib.repro_mac_error_string.argtypes = [ctypes.c_int]
    lib.repro_mac_error_string.restype = ctypes.c_char_p
    return lib


def mac_margins(ca, ra, cb, rb, theta: float):
    """Score a padded pair frontier: ca/cb (K, 3), ra/rb (K,) float32, K a
    multiple of `MAC_BLOCK` (ValueError otherwise) -> (K,) float32 margins;
    lanes past the live frontier hold values the caller masks.  CPU tensors
    run `mac_margins_ref`; CUDA tensors launch K3 on the current stream
    (raising if the launch fails); any other device raises."""
    global launches
    _check(ca, ra, cb, rb)
    dev = ra.device
    if dev.type == "cpu":
        return mac_margins_ref(ca, ra, cb, rb, theta)
    if dev.type != "cuda":
        raise ValueError(f"mac_margins: unsupported device {dev}")
    for name, t in (("ca", ca), ("ra", ra), ("cb", cb), ("rb", rb)):
        if not t.is_contiguous():
            raise ValueError(f"mac_margins: {name} must be contiguous")
    K = ra.shape[0]
    out = torch.empty(K, dtype=torch.float32, device=dev)
    if K == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_mac_margins(ca.data_ptr(), ra.data_ptr(),
                                    cb.data_ptr(), rb.data_ptr(),
                                    float(theta), out.data_ptr(), K, stream)
    if err != 0:
        raise RuntimeError("mac kernel launch failed: "
                           + lib.repro_mac_error_string(err).decode())
    launches += 1
    return out
