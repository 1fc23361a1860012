"""Fused fleet accounting's error against the truth as a run grows longer.

Replays an HPL-MxP-shaped timeline (``mxp_factorize`` of each given
length, then a 0.057 s ``mxp_refine``) through ``fused_fleet_energize``
over simulated nodes, and prints, per length, the worst node total and
the worst per-phase error against the synthetic truth: the numbers
``chip_smoke.py``'s fused energy gates read, each also as seconds of
its phase's (or the run's) own power, the unit of ``FUSED_EDGE_S``.  Either package runs it, on
the CPU, one package per process; ``--save`` also keeps each node's
phase energies and its streams' estimated delays (``align_and_fuse`` on
the same node streams), and ``--compare`` sets two saved runs side by
side, node by node:

    PYTHONPATH=src python scripts/fused_error_vs_length.py --package repro \\
        --save ref.npz
    PYTHONPATH=src python scripts/fused_error_vs_length.py \\
        --package repro_torch --save port.npz
    python scripts/fused_error_vs_length.py --compare ref.npz port.npz
"""
import argparse
import importlib
import json
import time

import numpy as np

REFINE_S = 0.057


def stream_delays(pkg: str, tracer, n_nodes: int, kw: dict):
    """(nodes, 3) estimated delays of the streams ``fused_fleet_energize``
    fuses (chip0 counter, chip0 power, off-chip PM), from the same node
    simulations."""
    core = importlib.import_module(f"{pkg}.core")
    align = importlib.import_module(f"{pkg}.align")
    energy = importlib.import_module(f"{pkg}.hpl.energy")
    calib = importlib.import_module(f"{pkg}.core.calibration")
    _, truth = energy.phases_and_truth(tracer)
    wanted = ["chip0_energy", "chip0_power_inst", "pm_accel0_power"]
    groups = []
    for node in range(n_nodes):
        traces = core.NodeFabric(chip_truths=[truth] * 4).sample_all(
            core.ToolSpec(), seed=node)
        groups.append([traces[n] for n in wanted])
    fused = align.align_and_fuse(groups, reference=truth,
                                 corrections=calib.nic_rail_corrections(),
                                 **kw)
    return np.array([fs.delays for fs in fused])


def compare(path_a: str, path_b: str):
    a, b = np.load(path_a), np.load(path_b)
    for i, length in enumerate(a["lengths"]):
        ea, eb = a["energies"][i], b["energies"][i]
        rel = np.abs(ea - eb) / np.maximum(np.abs(ea), 1.0)
        tot = np.abs(ea.sum(1) - eb.sum(1)) / ea.sum(1)
        nodes = np.flatnonzero(rel.max(1) > 1e-5)
        da, db = a["delays"][i], b["delays"][i]
        print(json.dumps({
            "factorize_s": float(length),
            "nodes_differing_over_1e-5": nodes.tolist(),
            "worst_phase_rel": float(rel.max()),
            "worst_node_total_rel": float(tot.max()),
            "pm_delays_over_100ms": [int((np.abs(d[:, 2]) > 0.1).sum())
                                     for d in (da, db)],
            "pm_delay_extremes_s": [[float(d[:, 2].min()),
                                     float(d[:, 2].max())] for d in (da, db)],
            "pm_delay_s_on_differing_nodes": [[float(da[n, 2]),
                                               float(db[n, 2])]
                                              for n in nodes],
            "worst_chip_delay_diff_s": float(np.abs(da[:, :2]
                                                    - db[:, :2]).max())}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("repro", "repro_torch"),
                    default="repro")
    ap.add_argument("--nodes", type=int, default=128)
    ap.add_argument("--lengths", type=float, nargs="+",
                    default=[5.25, 5.5, 8.5])
    ap.add_argument("--save", help="npz of per-node energies and delays")
    ap.add_argument("--compare", nargs=2, metavar="NPZ")
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    tracing = importlib.import_module(f"{args.package}.core.tracing")
    energy = importlib.import_module(f"{args.package}.hpl.energy")
    kw = {"device": "cpu"} if args.package == "repro_torch" else {}
    saved = {"lengths": [], "energies": [], "delays": []}
    for length in args.lengths:
        tracer = tracing.RegionTracer()
        tracer.add_region("mxp_factorize", 0.0, length)
        tracer.add_region("mxp_refine", length, length + REFINE_S)
        t0 = time.perf_counter()
        rows = energy.fused_fleet_energize(tracer, args.nodes, **kw)
        wall = time.perf_counter() - t0
        shifted, truth = energy.phases_and_truth(tracer)
        e_true = np.array([truth.energy_between(a, b)
                           for _, a, b in shifted])
        got = np.array([[pe.energy_j for pe in row] for row in rows])
        total = np.abs(got.sum(1) - e_true.sum()) / e_true.sum()
        per = (np.abs(got - e_true[None]) / e_true[None]).max(0)
        dur = np.array([b - a for _, a, b in shifted])
        print(json.dumps({
            "package": args.package, "nodes": args.nodes,
            "factorize_s": length,
            "worst_node_total": float(total.max()),
            "worst_per_phase": {n: float(e) for (n, _, _), e in
                                zip(shifted, per)},
            "worst_node_total_s": float(total.max() * dur.sum()),
            "worst_per_phase_s": {n: float(e * d) for (n, _, _), e, d in
                                  zip(shifted, per, dur)},
            "wall_s": wall}))
        if args.save:
            saved["lengths"].append(length)
            saved["energies"].append(got)
            saved["delays"].append(stream_delays(args.package, tracer,
                                                 args.nodes, kw))
    if args.save:
        np.savez(args.save, **{k: np.array(v) for k, v in saved.items()})


if __name__ == "__main__":
    main()
