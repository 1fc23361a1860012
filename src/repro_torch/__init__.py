"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

The windowed fused-attribution pipeline
(``fleet.attribute_energy_fused_streaming``), the batch align-and-fuse
path and ``fleet.api``, the §V-B mixed-precision case study (``hpl``)
and continuous-batching serving (``serve`` on ``models``) run on the
card, with hand-written CUDA kernels in ``kernels`` (sources in
``csrc``).  The package imports torch and numpy only;
the JAX package ``repro`` stays the reference its tests compare with.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
where every kernel wrapper takes its plain PyTorch version.
"""
from repro_torch.device import resolve_device  # noqa: F401
