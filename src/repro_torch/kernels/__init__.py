"""Hand-written Hopper kernels of the port, each beside its plain version.

Per kernel package: ``ref.py`` (the plain PyTorch version, same
arithmetic as the reference's ``ref.py``), ``kernel.py`` (the wrapper:
the CUDA kernel for a CUDA tensor, the plain version for a CPU tensor,
an error otherwise; it counts its launches) and, where the reference
has one, ``ops.py`` (the public op with its padding).  The CUDA sources
live in ``repro_torch/csrc`` and are built by ``kernels.build``.

  power_reconstruct — wrap-corrected dE/dt: per-row periods (rows), the
                      fused fleet front end (fleet), one scalar period
  grid_resample     — masked lower bound + hold/linear regrid
  xcorr_align       — lag-bank normalized cross-correlation
  phase_integrate   — per-phase energy of sample-and-hold power rows
  fleet_attribute   — dE/dt and per-phase integration fused on counters
  squarewave        — the calibrated vector-FMA load of the square wave
  flash_attention   — causal or full GQA attention, online softmax, cap
  ssm_scan          — the Mamba-1 selective-scan recurrence
"""
