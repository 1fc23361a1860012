"""Wrapper of the ``selective_scan`` CUDA kernel
(``csrc/selective_scan.cu``; replaces the TPU kernel
``selective_scan_kernel`` of ``repro/kernels/ssm_scan/kernel.py``)."""
from __future__ import annotations

import torch

from repro_torch.device import refuse_detached
from repro_torch.kernels import build
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

MAX_STATE = 64                    # states a channel holds in registers
_ENTRY = {(torch.float32, torch.float32): "ss_launch_f32_f32",
          (torch.float32, torch.bfloat16): "ss_launch_f32_bf16",
          (torch.bfloat16, torch.bfloat16): "ss_launch_bf16_bf16"}
_ARGS = (build.PTR,) * 8 + (build.INT,) * 4 + (build.PTR,)


def selective_scan_kernel(dt: torch.Tensor, x: torch.Tensor,
                          b_mat: torch.Tensor, c_mat: torch.Tensor,
                          a: torch.Tensor, h0: torch.Tensor):
    """dt/x: (B, L, D) (dt float32 with x float32 or bfloat16, or both
    bfloat16); b_mat/c_mat: (B, L, N), a: (D, N), h0: (B, D, N) float32
    -> (y (B, L, D) in x's dtype, h_last (B, D, N) float32).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel on the current stream (four threads share a (b, d)
    channel's states, N <= 64; every tensor contiguous).
    """
    dev = x.device
    if dev.type == "cpu":
        return selective_scan_ref(dt, x, b_mat, c_mat, a, h0)
    if dev.type != "cuda":
        raise ValueError(f"selective_scan: unsupported device {dev}")
    refuse_detached("selective_scan", dt, x, b_mat, c_mat, a, h0, item="A4c")
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
        build.check_tensor(t, what, dtype=dtype, shape=shape, device=dev)
    y = torch.empty_like(x)
    h_last = torch.empty((bsz, d, n), dtype=f32, device=dev)
    fn = build.c_function(_ENTRY[(dt.dtype, x.dtype)], _ARGS)
    with torch.cuda.device(dev):
        rc = fn(dt.data_ptr(), x.data_ptr(), b_mat.data_ptr(),
                c_mat.data_ptr(), a.data_ptr(), h0.data_ptr(), y.data_ptr(),
                h_last.data_ptr(), bsz, seq, d, n, build.stream_ptr(dev))
    build.check_launch(rc, "selective_scan")
    selective_scan_kernel.launches += 1
    return y, h_last


selective_scan_kernel.launches = 0
