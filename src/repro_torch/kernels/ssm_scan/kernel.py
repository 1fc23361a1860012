"""Wrappers of the ``selective_scan`` CUDA kernels: the forward
(``csrc/selective_scan.cu``; replaces the TPU kernel
``selective_scan_kernel`` of ``repro/kernels/ssm_scan/kernel.py``) and
its gradient (``csrc/selective_scan_bwd.cu``; no TPU counterpart: the
reference differentiates its jnp scan), joined by the autograd
``SelectiveScan``."""
from __future__ import annotations

import torch

from repro_torch.device import refuse_detached
from repro_torch.kernels import build
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

MAX_STATE = 64                    # states a channel holds in registers
CHUNK = 32                        # steps a checkpoint (csrc kChunk)
_ENTRY = {(torch.float32, torch.float32): "ss_launch_f32_f32",
          (torch.float32, torch.bfloat16): "ss_launch_f32_bf16",
          (torch.bfloat16, torch.bfloat16): "ss_launch_bf16_bf16"}
_ARGS = (build.PTR,) * 8 + (build.INT,) * 4 + (build.PTR,)
_CKPT_ENTRY = {k: v.replace("ss_launch", "ss_ckpt_launch")
               for k, v in _ENTRY.items()}
_CKPT_ARGS = (build.PTR,) * 9 + (build.INT,) * 4 + (build.PTR,)
_BWD_ENTRY = {k: v.replace("ss_launch", "ssb_launch")
              for k, v in _ENTRY.items()}
_BWD_ARGS = (build.PTR,) * 17 + (build.INT,) * 5 + (build.PTR,)


BWD_CLUSTER = 8                   # blocks whose dB/dC one part sums


def bwd_lanes(n: int) -> int:
    """Threads sharing a channel's states in the backward (two states a
    thread, at least four lanes): 4 up to N = 8, then 8, 16, 32."""
    return 4 if n <= 8 else 8 if n <= 16 else 16 if n <= 32 else 32


def bwd_channels(n: int) -> int:
    """Channels whose dB/dC partial sums one part of the backward's
    scratch holds (csrc/selective_scan_bwd.cu): a cluster of BWD_CLUSTER
    blocks of 128 / bwd_lanes(n) channels (128 channels at N = 16)."""
    return BWD_CLUSTER * (128 // bwd_lanes(n))


def bwd_scratch_shapes(bsz: int, seq: int, d: int, n: int) -> dict:
    """The float32 scratch the backward's wrapper allocates: the dB and dC
    partials, (parts, B, L, N) each with parts = ceil(D / bwd_channels),
    and dA's per-row sums, (B, D, N)."""
    parts = -(-d // bwd_channels(n))
    return {"part_b": (parts, bsz, seq, n), "part_c": (parts, bsz, seq, n),
            "part_a": (bsz, d, n)}


def bwd_blocks_per_sm(dt_dtype, x_dtype, n: int) -> int:
    """Blocks of the backward kernel that fit on one SM of the current
    card (cudaOccupancyMaxActiveBlocksPerMultiprocessor with its shared
    memory): CUDA only, builds the kernels."""
    fn = build.c_function("ssb_blocks_per_sm", (build.INT,) * 3)
    return fn(int(dt_dtype == torch.bfloat16),
              int(x_dtype == torch.bfloat16), n)


def _check(dt, x, b_mat, c_mat, a, h0=None):
    """The CUDA kernels' argument checks (h0's where given) -> (B, L, D,
    N)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"selective_scan: unsupported device {dev}")
    bsz, seq, d = x.shape
    n = a.shape[1]
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"selective_scan: d_state {n}; the kernel holds "
                         f"1 to {MAX_STATE} states a channel")
    if (dt.dtype, x.dtype) not in _ENTRY:
        raise TypeError(f"selective_scan: dt {dt.dtype} with x {x.dtype}; "
                        f"the kernel takes {sorted(map(str, _ENTRY))}")
    f32 = torch.float32
    for t, what, dtype, shape in (
            (dt, "dt", dt.dtype, (bsz, seq, d)),
            (x, "x", x.dtype, (bsz, seq, d)),
            (b_mat, "b_mat", f32, (bsz, seq, n)),
            (c_mat, "c_mat", f32, (bsz, seq, n)),
            (a, "a", f32, (d, n)), (h0, "h0", f32, (bsz, d, n))):
        if t is None:
            continue
        build.check_tensor(t, what, dtype=dtype, shape=shape, device=dev)
    return bsz, seq, d, n


def _forward(dt, x, b_mat, c_mat, a, h0, with_chunks: bool):
    """Launch the forward on CUDA tensors -> (y, h_last, h_chunk or
    None); h_chunk is (B, ceil(L / CHUNK), D, N) float32, the state
    entering every CHUNK-th step."""
    bsz, seq, d, n = _check(dt, x, b_mat, c_mat, a, h0)
    dev = x.device
    y = torch.empty_like(x)
    h_last = torch.empty((bsz, d, n), dtype=torch.float32, device=dev)
    args = [dt.data_ptr(), x.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
            a.data_ptr(), h0.data_ptr(), y.data_ptr(), h_last.data_ptr()]
    h_chunk = None
    if with_chunks:
        h_chunk = torch.empty((bsz, -(-seq // CHUNK), d, n),
                              dtype=torch.float32, device=dev)
        args.append(h_chunk.data_ptr())
        fn = build.c_function(_CKPT_ENTRY[(dt.dtype, x.dtype)], _CKPT_ARGS)
    else:
        fn = build.c_function(_ENTRY[(dt.dtype, x.dtype)], _ARGS)
    with torch.cuda.device(dev):
        rc = fn(*args, bsz, seq, d, n, build.stream_ptr(dev))
    build.check_launch(rc, "selective_scan")
    selective_scan_kernel.launches += 1
    return y, h_last, h_chunk


def selective_scan_kernel(dt: torch.Tensor, x: torch.Tensor,
                          b_mat: torch.Tensor, c_mat: torch.Tensor,
                          a: torch.Tensor, h0: torch.Tensor):
    """dt/x: (B, L, D) (dt float32 with x float32 or bfloat16, or both
    bfloat16); b_mat/c_mat: (B, L, N), a: (D, N), h0: (B, D, N) float32
    -> (y (B, L, D) in x's dtype, h_last (B, D, N) float32).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel on the current stream (four threads share a (b, d)
    channel's states, N <= 64; every tensor contiguous).

    Its result carries no gradient: a CUDA input that requires one, with
    grad enabled, raises ``NotImplementedError``; ``ops.selective_scan``
    takes such inputs through ``SelectiveScan``.
    """
    if x.device.type == "cpu":
        return selective_scan_ref(dt, x, b_mat, c_mat, a, h0)
    refuse_detached("selective_scan", dt, x, b_mat, c_mat, a, h0,
                    item="B10: call ops.selective_scan, whose "
                    "SelectiveScan has the backward")
    return _forward(dt, x, b_mat, c_mat, a, h0, False)[:2]


selective_scan_kernel.launches = 0


def selective_scan_bwd_kernel(dt, x, b_mat, c_mat, a, h_chunk, dy,
                              dh_last=None):
    """The gradient of ``selective_scan_kernel``: its inputs (but h0),
    the forward's checkpoints ``h_chunk`` (B, ceil(L / CHUNK), D, N)
    float32, ``dy`` (B, L, D) in x's dtype, the gradient of y, and
    ``dh_last`` (B, D, N) float32 or None (zero), the gradient of h_last
    -> (ddt in dt's dtype, dx in x's, dB, dC (B, L, N), dA (D, N), dh0
    (B, D, N) float32).  CUDA tensors only (the CPU's gradient is
    autograd through the plain version): the backward kernel, then the
    folds of dB, dC and dA, on the current stream.  Deterministic: no
    atomics, every sum in a fixed order."""
    bsz, seq, d, n = _check(dt, x, b_mat, c_mat, a)
    dev, f32 = x.device, torch.float32
    build.check_tensor(h_chunk, "h_chunk", dtype=f32,
                       shape=(bsz, -(-seq // CHUNK), d, n), device=dev)
    build.check_tensor(dy, "dy", dtype=x.dtype, shape=(bsz, seq, d),
                       device=dev)
    if dh_last is not None:
        build.check_tensor(dh_last, "dh_last", dtype=f32, shape=(bsz, d, n),
                           device=dev)
    scratch = bwd_scratch_shapes(bsz, seq, d, n)
    parts = scratch["part_b"][0]
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    db, dc = (torch.empty((bsz, seq, n), dtype=f32, device=dev)
              for _ in range(2))
    da = torch.empty((d, n), dtype=f32, device=dev)
    dh0 = torch.empty((bsz, d, n), dtype=f32, device=dev)
    part_b, part_c, part_a = (torch.empty(shape, dtype=f32, device=dev)
                              for shape in scratch.values())
    fn = build.c_function(_BWD_ENTRY[(dt.dtype, x.dtype)], _BWD_ARGS)
    with torch.cuda.device(dev):
        rc = fn(dt.data_ptr(), x.data_ptr(), b_mat.data_ptr(),
                c_mat.data_ptr(), a.data_ptr(), h_chunk.data_ptr(),
                dy.data_ptr(),
                None if dh_last is None else dh_last.data_ptr(),
                ddt.data_ptr(), dx.data_ptr(), db.data_ptr(), dc.data_ptr(),
                da.data_ptr(), dh0.data_ptr(), part_b.data_ptr(),
                part_c.data_ptr(), part_a.data_ptr(), bsz, seq, d, n, parts,
                build.stream_ptr(dev))
    build.check_launch(rc, "selective_scan_bwd")
    selective_scan_bwd_kernel.launches += 1
    return ddt, dx, db, dc, da, dh0


selective_scan_bwd_kernel.launches = 0


class SelectiveScan(torch.autograd.Function):
    """B10 with its gradient, on CUDA tensors: the forward kernel keeps
    the state entering every ``CHUNK``-th step beside (y, h_last), and
    the backward kernel recomputes each chunk's states from it.
    ``SelectiveScan.apply(dt, x, b_mat, c_mat, a, h0) -> (y, h_last)``;
    the CPU's counterpart is autograd through ``selective_scan_ref``."""

    @staticmethod
    def forward(ctx, dt, x, b_mat, c_mat, a, h0):
        y, h_last, h_chunk = _forward(dt, x, b_mat, c_mat, a, h0, True)
        ctx.save_for_backward(dt, x, b_mat, c_mat, a, h_chunk)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        dt, x, b_mat, c_mat, a, h_chunk = ctx.saved_tensors
        dy = (torch.zeros_like(x) if dy is None
              else dy.to(x.dtype).contiguous())
        if dh_last is not None:
            dh_last = dh_last.float().contiguous()
        return selective_scan_bwd_kernel(dt, x, b_mat, c_mat, a, h_chunk,
                                         dy, dh_last)
