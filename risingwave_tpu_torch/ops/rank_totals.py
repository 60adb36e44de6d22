"""Same-key rank/total counts of the join's chunk pass (kernel B1).

Counterpart of ``risingwave_tpu/ops/pallas_rank.py``: the Pallas TPU kernel
``_kernel`` launched by ``rank_totals_pallas_call`` is replaced by the CUDA
kernel ``csrc/rank_totals.cu``. Per probe row i and bucket lane w:

    r[i, w] = #{ j < i : ident[j] == ident[i] >= 0, matches[j, w] }
    t[i, w] = #{ j     : ident[j] == ident[i] >= 0, matches[j, w] }

The kernel computes it as a stable sort of the rows by key and a segmented
prefix sum down each lane, in int32, in two launches on the current stream
with no host sync; its source note gives the design and its bound on an H100
(bytes: about 1.4 us at N=4096, W=128, for every key pattern). It needs a
fixed workspace, one per device and stream, kept here and grown only when a
larger chunk arrives. ``rank_totals`` launches the kernel for CUDA tensors
and runs ``rank_totals_plain`` (the counterpart of ``rank_totals_jnp``) for
CPU tensors; neither falls back to the other.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels


def rank_totals_plain(ident: torch.Tensor, matches: torch.Tensor):
    """Plain PyTorch version: two [N,N]·[N,W] products of the equality
    masks, in float32 (exact for counts below 2**24), rounded to int32."""
    n = ident.shape[0]
    idx = torch.arange(n, device=ident.device)
    eq = (ident[:, None] == ident[None, :]) & (ident >= 0)[:, None]
    lower = eq & (idx[None, :] < idx[:, None])
    mf = matches.to(torch.float32)
    r = torch.round(lower.to(torch.float32) @ mf).to(torch.int32)
    t = torch.round(eq.to(torch.float32) @ mf).to(torch.int32)
    return r, t


def _check(ident: torch.Tensor, matches: torch.Tensor) -> None:
    if ident.dtype != torch.int32:
        raise TypeError(f"ident must be int32, got {ident.dtype}")
    if matches.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"matches must be bool or uint8, got {matches.dtype}")
    if ident.dim() != 1 or matches.dim() != 2 \
            or matches.shape[0] != ident.shape[0]:
        raise ValueError(f"shapes: ident {tuple(ident.shape)} and matches "
                         f"{tuple(matches.shape)}; want [N] and [N, W]")
    if ident.device != matches.device:
        raise ValueError("ident and matches are on different devices")
    if not (ident.is_contiguous() and matches.is_contiguous()):
        raise ValueError("ident and matches must be contiguous")
    if ident.shape[0] >= 1 << 31 or matches.shape[1] >= 1 << 31:
        raise ValueError("N and W must fit in int32")


def _library():
    lib = kernels.load("rank_totals")
    if lib.rank_totals_launch.argtypes is None:  # no 32-bit pointers
        lib.rank_totals_launch.argtypes = [ctypes.c_void_p] * 4 \
            + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
        lib.rank_totals_launch.restype = ctypes.c_int
        lib.rank_totals_workspace_bytes.argtypes = [ctypes.c_int] * 2
        lib.rank_totals_workspace_bytes.restype = ctypes.c_size_t
    return lib


#: (device index, stream) -> zero-initialised uint8 workspace
_workspaces: dict[tuple[int, int], torch.Tensor] = {}


def _workspace(lib, dev: torch.device, stream: int, n: int, w: int):
    """The kernel's workspace for this device and stream, grown (zeroed)
    when (n, w) needs more; the kernel leaves it reusable."""
    nbytes = lib.rank_totals_workspace_bytes(n, w)
    ws = _workspaces.get((dev.index, stream))
    if ws is None or ws.numel() < nbytes:
        ws = torch.zeros(nbytes, dtype=torch.uint8, device=dev)
        _workspaces[(dev.index, stream)] = ws
    return ws


def rank_totals(ident: torch.Tensor, matches: torch.Tensor):
    """``(r, t)`` as int32[N, W]: the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    _check(ident, matches)
    dev = ident.device
    if dev.type == "cpu":
        return rank_totals_plain(ident, matches)
    if dev.type != "cuda":
        raise ValueError(f"rank_totals: unsupported device {dev}")
    n, w = matches.shape
    r = torch.empty((n, w), dtype=torch.int32, device=dev)
    t = torch.empty((n, w), dtype=torch.int32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws = _workspace(lib, dev, stream, n, w)
        err = lib.rank_totals_launch(ident.data_ptr(), matches.data_ptr(),
                                     r.data_ptr(), t.data_ptr(), n, w,
                                     ws.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rank_totals kernel launch failed: cudaError {err}")
    rank_totals.launches += 1
    return r, t


#: kernel launches since the last reset (launches only, not plain runs)
rank_totals.launches = 0
