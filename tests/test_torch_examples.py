"""PyTorch port, the reference's five examples (``repro_torch.examples``):
each run with ``device="cpu"`` against the reference's example or its
calls on the same inputs.

- quickstart: the printed report line for line against the reference's
  script, and every printed number at 1e-5 against the reference's calls
  on the same seed.
- mixed_precision_study (at a reduced size): residuals and IR iterations
  at the reference's bounds against its solvers on the same systems; the
  energies and the saving split through the reference's ``energize`` and
  ``split_energy_savings`` on the port run's own phases, at 1e-5.
- serve_demo (4 requests): on the reference's weights carried across in
  float32, the greedy tokens equal the reference engine's; the per-phase
  and per-request energies within 1e-5 x max(|E|, 1 J) of the
  reference's attribution of the port's own timeline (poll and chunk
  counts follow the reader threads and are not compared).
- train_lm (2 x 32 tokens): the first three losses at 1e-5 of the
  reference's jitted step on carried weights, the loss falling, and a
  resume from the checkpoint it wrote.
- fault_tolerance_demo: the printed events and straggler line equal to
  the reference's script's.
"""
import contextlib
import dataclasses
import io
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch, reduced as jax_reduced
from repro.core import NodeFabric as JNodeFabric
from repro.core import ToolSpec as JToolSpec
from repro.core import characterize_sensor as j_characterize
from repro.core import phase_power as j_phase_power
from repro.core import split_energy_savings as j_split
from repro.core.power_model import occupancy_power as j_occupancy_power
from repro.core.tracing import RegionTracer as JRegionTracer
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.fleet.config import PipelineConfig as JPipelineConfig
from repro.fleet.config import StreamConfig as JStreamConfig
from repro.fleet.pipeline import SlotSegment as JSlotSegment
from repro.hpl import energy as jenergy
from repro.hpl import hpg_mxp as jhpg
from repro.hpl import hpl as jhpl
from repro.hpl import hpl_mxp as jmxp
from repro.models import Model as JModel
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.train import loop as JL
from repro.train import optimizer as JO
from repro_torch.examples import (fault_tolerance_demo, mixed_precision_study,
                                  quickstart, serve_demo, train_lm)
from repro_torch.interop import model_params_from_arrays

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

CPU = "cpu"
REL = 1e-5
EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    return np.asarray(t)


def _printed(fn, *args, **kwargs):
    """-> (fn's result, the lines it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue().splitlines()


def _reference_script(name: str) -> dict:
    """The reference's example as a module namespace (``main`` not run;
    a script without one runs while it loads)."""
    return runpy.run_path(str(EXAMPLES / f"{name}.py"),
                          run_name=f"reference_{name}")


def _jax_tracer(arrays) -> JRegionTracer:
    """A reference tracer holding the events of ``to_arrays()``."""
    tracer = JRegionTracer()
    names = list(arrays["names"])
    for i in range(len(arrays["name_id"])):
        tracer.add_region(names[int(arrays["name_id"][i])],
                          float(arrays["t_start"][i]),
                          float(arrays["t_end"][i]),
                          depth=int(arrays["depth"][i]),
                          device=int(arrays["device"][i]),
                          step=int(arrays["step"][i]),
                          slot=int(arrays["slot"][i]))
    return tracer


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert err.max(initial=0.0) <= rel, err.max()


# ------------------------------------------------------------ quickstart

def test_quickstart_prints_the_reference_report():
    """The report line for line (the script runs as it loads), and every
    printed number at 1e-5 of the reference's calls on the same seed."""
    ref, want_lines = _printed(_reference_script, "quickstart")
    out, got_lines = _printed(quickstart.main, CPU)
    assert got_lines == want_lines
    traces = ref["traces"]
    for name in quickstart.SENSORS:
        rec = j_characterize(traces[name], ref["edges_up"],
                             ref["edges_down"])
        got = out["characterization"][name]
        _close([got["observed_interval_s"], got["delay_s"], got["rise_s"],
                got["fall_s"]],
               [rec["update_intervals"]["observed"]["median"],
                rec["step_response"]["delay_s"],
                rec["step_response"]["rise_s"],
                rec["step_response"]["fall_s"]])
    _close([out["derived_w"], out["averaged_w"]],
           [np.mean(ref["derived"].watts[ref["active"]]),
            np.mean(ref["averaged"].watts[ref["active_avg"]])])


# ------------------------------------------------- mixed_precision_study

MXP_SIZE = dict(n=128, nb=32, nx=16, n_iters=10)


def test_mixed_precision_study_matches_reference():
    """Residuals at the reference's bounds (HPL and HPL-MxP < 1e-4,
    ``tests/test_system.py``; IR iterations within one of the
    reference's solver on the same system and HPG-MxP's residuals within
    1e-4 / 2e-2 of its own, ``tests/test_torch_hpl.py``'s bounds); the
    node energies and the saving split of both studies through the
    reference's ``energize`` and ``split_energy_savings`` on the port
    run's own phases, at 1e-5."""
    from repro_torch.hpl import make_dd_system, make_poisson, make_system
    out, lines = _printed(mixed_precision_study.main, CPU, **MXP_SIZE)
    assert lines[0] == f"== HPL vs HPL-MxP (n={MXP_SIZE['n']}) =="
    assert any(ln.startswith("== HPG-MxP full vs mixed") for ln in lines)
    n, nb = MXP_SIZE["n"], MXP_SIZE["nb"]
    hpl, hpg = out["hpl"], out["hpg"]
    assert hpl["full_residual"] < 1e-4 and hpl["mxp_residual"] < 1e-4
    a, b, _ = make_system(n, 0, device=CPU)
    ad, bd, _ = make_dd_system(n, 0, device=CPU)
    _, jfull = jhpl.hpl_solve(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                              nb=nb)
    _, jmx = jmxp.hpl_mxp_solve(jnp.asarray(ad.numpy()),
                                jnp.asarray(bd.numpy()), nb=nb)
    assert jfull["residual"] < 1e-4
    assert abs(hpl["ir_iters"] - jmx["ir_iters"]) <= 1
    rhs = jnp.asarray(make_poisson(MXP_SIZE["nx"], 0, device=CPU).numpy())
    for key, mixed, tol in (("full_residual", False, 1e-4),
                            ("mixed_residual", True, 2e-2)):
        _, ji = jhpg.hpg_solve(rhs, n_iters=MXP_SIZE["n_iters"],
                               mixed=mixed)
        assert abs(hpg[key] - ji["residual"]) <= tol * ji["residual"]
    for study in (hpl, hpg):
        want = j_split(jenergy.energize(_jax_tracer(study["phases_full"])),
                       jenergy.energize(_jax_tracer(study["phases_mixed"])))
        assert set(study["savings"]) == set(want)
        for k, v in want.items():
            assert abs(study["savings"][k] - v) <= REL * max(abs(v), 1.0), k


# ------------------------------------------------------------ serve_demo

SERVE_REQUESTS = 4


def test_serve_demo_matches_reference():
    """Carried float32 weights: the reference engine's greedy tokens; its
    attribution of the port's own timeline (the same fabric, bit for
    bit) per phase and per request within 1e-5 x max(|E|, 1 J)."""
    cj = dataclasses.replace(jax_reduced(jax_get_arch("llama3.2-3b")),
                             compute_dtype="float32")
    jm = JModel(cj)
    params = jm.init(jax.random.key(0))
    tp = model_params_from_arrays(_np_tree(params),
                                  serve_demo.config("float32"), device=CPU)
    out, lines = _printed(serve_demo.main, CPU, params=tp,
                          compute_dtype="float32",
                          n_requests=SERVE_REQUESTS)
    assert lines[0].startswith(f"served {SERVE_REQUESTS} requests")
    assert "  conservation: async totals == unwrapped counter ΔE ✓" in lines

    ref = JServeEngine(jm, params, batch_slots=4, max_len=64)
    rng = np.random.default_rng(0)
    want = ref.run([JRequest(rid=i, prompt=rng.integers(0, cj.vocab_size,
                                                        8 + 2 * i),
                             max_new_tokens=12)
                    for i in range(SERVE_REQUESTS)])
    assert out["tokens"] == want

    # the reference attributes the port run's timeline
    ref.tracer = _jax_tracer(out["phases_arrays"])
    ref.segments = [JSlotSegment(**s) for s in out["segments"]]
    lead = out["lead"]
    shifted = [(n, a + lead, b + lead)
               for n, a, b in ref.tracer.phases(depth=0)]
    assert [p[0] for p in shifted] == [p[0] for p in out["phases"]]
    watts = {n: {"watts": j_occupancy_power(*serve_demo.OCC[n])}
             for n, _, _ in shifted}
    truth = j_phase_power([("__lead__", 0.0, lead)] + shifted,
                          {**watts, "__lead__": {"watts": 55.0}})
    traces = JNodeFabric(chip_truths=[truth] * 4).sample_all(JToolSpec(),
                                                             seed=0)
    chip = {n: tr for n, tr in traces.items()
            if tr.spec.is_cumulative and n.startswith("chip")}
    traces = {n: tr for n, tr in traces.items() if len(tr.t_read)}

    def energies(rows):
        return {k: [p.energy_j for p in row] for k, row in rows.items()}

    counters = energies(ref.attribute_phases(chip, t_shift=lead))
    assert list(out["counters"]) == list(counters)
    _close(list(out["counters"].values()), list(counters.values()))
    fused = energies(ref.attribute_phases(traces, t_shift=lead, fuse=True,
                                          reference=truth))
    assert list(out["fused"]) == list(fused)
    _close(list(out["fused"].values()), list(fused.values()))
    with pytest.warns(DeprecationWarning):
        bills = ref.attribute_requests(traces, t_shift=lead,
                                       reference=truth, track=False)
    assert [r["rid"] for r in out["requests"]] == \
        [r.rid for r in bills.requests] == list(range(SERVE_REQUESTS))
    assert [r["tokens"] for r in out["requests"]] == \
        [r.tokens for r in bills.requests]
    _close([r["energy_j"] for r in out["requests"]],
           [r.energy_j for r in bills.requests])
    stream = energies(ref.attribute_phases(
        traces, t_shift=lead, fuse=True, reference=truth, streaming=True,
        config=JPipelineConfig(stream=JStreamConfig(chunk=512))))
    assert list(out["fused_streaming"]) == list(stream)
    _close(list(out["fused_streaming"].values()), list(stream.values()))


# -------------------------------------------------------------- train_lm

TRAIN_SIZE = dict(batch=2, seq=32, compute_dtype="float32")


def test_train_lm_matches_reference_and_resumes(tmp_path):
    """Carried weights, float32: the first three losses at 1e-5 of the
    reference's jitted step on the same batches, the loss falling over
    26 steps (a checkpoint at step 25), then a run of 30 steps resumed
    from it whose first loss is the uninterrupted run's at step 25."""
    ref = _reference_script("train_lm")
    cj = dataclasses.replace(ref["config"](False), compute_dtype="float32")
    jm = JModel(cj)
    params = jm.init(jax.random.key(0))
    tp = model_params_from_arrays(_np_tree(params),
                                  train_lm.config(False, "float32"),
                                  device=CPU)
    ckpt = tmp_path / "ckpt"
    out, lines = _printed(train_lm.main, CPU, steps=26, ckpt_dir=ckpt,
                          params=tp, **TRAIN_SIZE)
    assert lines[0] == "llama-demo: 3.4M params, 26 steps"
    assert out["start"] == 0 and len(out["losses"]) == 26
    assert out["losses"][-1] < out["losses"][0]

    opt = JO.optimizer_for(cj)
    step_fn = jax.jit(JL.make_train_step(
        jm, opt, JO.schedule_for(cj.name, base_lr=3e-3, total=52)))
    data = JSyntheticLM(JDataConfig(cj.vocab_size, 32, 2, seed=0))
    p, o = params, opt.init(params)
    for s in range(3):
        batch = {k: jnp.asarray(v) for k, v in data.batch(s).items()}
        p, o, m = step_fn(p, o, batch, jnp.asarray(s, jnp.int32))
        got = out["losses"][s]
        assert abs(got - float(m["loss"])) <= REL * abs(float(m["loss"]))

    again, lines = _printed(train_lm.main, CPU, steps=30, ckpt_dir=ckpt,
                            params=tp, **TRAIN_SIZE)
    assert "resumed from checkpoint step 25" in lines
    assert again["start"] == 25 and len(again["losses"]) == 5
    assert again["losses"][0] == out["losses"][25]


# -------------------------------------------------- fault_tolerance_demo

def test_fault_tolerance_demo_prints_the_reference_events():
    """The supervision events (less their wall times), the completion
    line and the straggler eviction, line for line."""
    ref = _reference_script("fault_tolerance_demo")
    _, want = _printed(ref["main"])
    out, got = _printed(fault_tolerance_demo.main, CPU)
    assert got == want
    assert out["faults"] == 2 and out["step"] == 25
    assert [h for h, _, _ in out["evicted"]] == [3]
    kinds = [e["kind"] for e in out["events"]]
    assert kinds.count("fault") == 2 and "skip_batch" in kinds
