"""Public API: calibrated square-wave load generation (port of
``repro/kernels/squarewave/ops.py``).

The paper calibrates a double-precision vector-FMA kernel so that its
HBM data movement and its arithmetic take the same time, pinning the GPU
at TDP (§IV-B).  ``calibrated_fma_count`` keeps the reference's formula
with the H100's own rates (H100 SXM5 datasheet, without tensor cores).
"""
from __future__ import annotations

import torch

from repro_torch.device import refuse_unported
from repro_torch.kernels.squarewave.kernel import squarewave_kernel

H100_HBM_BW = 3.35e12          # H100 SXM5 datasheet: HBM3, bytes/s
# Vector (non-tensor-core) FLOP/s of each type's FMA: float64 and float32
# from the H100 SXM5 datasheet, bfloat16 from the H100 whitepaper (packed
# HFMA2, twice the float32 rate).  The rate a kernel's bound uses.
H100_VECTOR_FLOPS = {torch.float64: 34e12, torch.float32: 67e12,
                     torch.bfloat16: 134e12}
# The calibration's peak: bfloat16 is calibrated against the float32
# rate, as the reference calibrates every dtype against one peak.
H100_PEAK_FLOPS = {**H100_VECTOR_FLOPS,
                   torch.bfloat16: H100_VECTOR_FLOPS[torch.float32]}


def calibrated_fma_count(dtype=torch.float32, balance_factor=1.0) -> int:
    """FMA-chain length so FLOPs/byte ~= balance_factor x machine balance.

    Each element moves 2*itemsize bytes (read+write) and runs 2*K FLOPs,
    so K = balance_factor * (peak/bw) * itemsize."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    k = balance_factor * (H100_PEAK_FLOPS[dtype] / H100_HBM_BW) * itemsize
    return max(int(round(k)), 1)


def squarewave_load(x: torch.Tensor, *, fma_chain: int,
                    interpret: bool = False,
                    use_kernel: bool = True) -> torch.Tensor:
    """One active-phase burst of the square-wave workload on ``x``'s
    device: the ``squarewave`` kernel on a CUDA tensor, its plain version
    on a CPU tensor.  x: (rows, width); ``interpret=True`` and
    ``use_kernel=False`` are not ported."""
    refuse_unported("squarewave_load", interpret=interpret,
                    use_kernel=use_kernel)
    if x.dim() != 2:
        raise ValueError(f"squarewave_load: x must be (rows, width), got "
                         f"shape {tuple(x.shape)}")
    x = x.contiguous()
    if x.is_cuda and x.data_ptr() % 16:
        x = x.clone()                # a fresh allocation is aligned
    return squarewave_kernel(x, fma_chain=fma_chain)
