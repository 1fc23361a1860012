"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

The windowed fused-attribution pipeline
(``fleet.attribute_energy_fused_streaming``) runs on the card, with
hand-written CUDA kernels for its three hot spots
(``kernels.power_reconstruct``, ``kernels.grid_resample``,
``kernels.xcorr_align``).  The package imports torch and numpy only;
the JAX package ``repro`` stays the reference its tests compare with.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
where every kernel wrapper takes its plain PyTorch version.
"""
from repro_torch.device import resolve_device  # noqa: F401
