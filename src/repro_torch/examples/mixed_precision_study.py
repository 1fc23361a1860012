"""The paper's §V-B case study: full- vs mixed-precision energy, decomposed
into time-to-solution vs instantaneous power (Figs. 7/8 + energy table);
port of ``examples/mixed_precision_study.py``.

Runs HPL / HPL-MxP and HPG-MxP (full + mixed) analogues with traced phases
on the device, synthesizes the node sensor fabric over the measured
timeline, attributes per-phase energy, and prints the savings
decomposition.  The systems are drawn on the host from ``seed`` (the same
matrices whichever device solves them).

  PYTHONPATH=src python -m repro_torch.examples.mixed_precision_study \\
      [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.core import split_energy_savings
from repro_torch.device import resolve_device
from repro_torch.hpl import (hpg_solve, hpl_mxp_solve, hpl_solve,
                             make_dd_system, make_poisson, make_system)
# energy accounting lives in repro_torch.hpl.energy; fleet_energize
# batches nodes
from repro_torch.hpl.energy import OCC, energize  # noqa: F401

HOST = "cpu"


def main(device=None, *, n: int = 384, nb: int = 64, nx: int = 64,
         n_iters: int = 80, seed: int = 0) -> dict:
    """Print the reference's report -> {"hpl": ..., "hpg": ...}, each
    with the solvers' residuals (and HPL-MxP's IR iterations), the
    savings decomposition and the two runs' traced phases
    (``RegionTracer.to_arrays()``: the energies follow the wall clock)."""
    dev = resolve_device(device)
    print(f"== HPL vs HPL-MxP (n={n}) ==")
    a, b, _ = make_system(n, seed, device=HOST)
    _, full_info = hpl_solve(a.to(dev), b.to(dev), nb=nb)
    ad, bd, _ = make_dd_system(n, seed, device=HOST)
    _, mxp_info = hpl_mxp_solve(ad.to(dev), bd.to(dev), nb=nb)
    pe_full = energize(full_info["tracer"], device=dev)
    pe_mxp = energize(mxp_info["tracer"], device=dev)
    dec = split_energy_savings(pe_full, pe_mxp)
    print(f"  full residual {full_info['residual']:.2e}  "
          f"mxp residual {mxp_info['residual']:.2e} "
          f"(IR iters {mxp_info['ir_iters']})")
    print(f"  node energy: {dec['energy_full_j']:.1f} J -> "
          f"{dec['energy_mixed_j']:.1f} J   saving "
          f"{dec['saving_frac']*100:.0f}%")
    print(f"  decomposition: time x{dec['time_ratio']:.2f}, "
          f"power x{dec['power_ratio']:.2f} "
          "(saving dominated by time-to-solution, as in the paper)")
    hpl = {"full_residual": float(full_info["residual"]),
           "mxp_residual": float(mxp_info["residual"]),
           "ir_iters": int(mxp_info["ir_iters"]), "savings": dec,
           "phases_full": full_info["tracer"].to_arrays(),
           "phases_mixed": mxp_info["tracer"].to_arrays()}

    print(f"\n== HPG-MxP full vs mixed ({nx}^3 grid) ==")
    rhs = make_poisson(nx, seed, device=HOST).to(dev)
    _, f_info = hpg_solve(rhs, n_iters=n_iters, mixed=False)
    _, m_info = hpg_solve(rhs, n_iters=n_iters, mixed=True)
    pe_f = energize(f_info["tracer"], device=dev)
    pe_m = energize(m_info["tracer"], device=dev)
    dec = split_energy_savings(pe_f, pe_m)
    print(f"  residuals: full {f_info['residual']:.2e}  "
          f"mixed {m_info['residual']:.2e}")
    print(f"  node energy: {dec['energy_full_j']:.1f} J -> "
          f"{dec['energy_mixed_j']:.1f} J   saving "
          f"{dec['saving_frac']*100:.0f}%")
    print(f"  decomposition: time x{dec['time_ratio']:.2f}, "
          f"power x{dec['power_ratio']:.2f}")
    hpg = {"full_residual": float(f_info["residual"]),
           "mixed_residual": float(m_info["residual"]), "savings": dec,
           "phases_full": f_info["tracer"].to_arrays(),
           "phases_mixed": m_info["tracer"].to_arrays()}
    return {"hpl": hpl, "hpg": hpg}


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
