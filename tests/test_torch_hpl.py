"""PyTorch port, the §V-B mixed-precision case study: the square-wave
load (plain version on the CPU), HPL, HPL-MxP and HPG-MxP, the node
fabric and calibration corrections, ``corrections=`` on the batch and
windowed entry points, and the fleet energy accounting — each against
the JAX package on the same inputs (numpy from a seed, or the
reference's own matrices carried across with ``interop``)."""
import dataclasses
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from repro import align as jalign
from repro import fleet as jfleet
from repro.core import NodeFabric as JNodeFabric
from repro.core import ToolSpec as JToolSpec
from repro.core.calibration import apply_corrections as j_apply
from repro.core.calibration import nic_rail_corrections as j_nic
from repro.core.tracing import RegionTracer as JRegionTracer
from repro.fleet import pipeline as jpl
from repro.hpl import energy as jenergy
from repro.hpl import hpg_mxp as jhpg
from repro.hpl import hpl as jhpl
from repro.hpl import hpl_mxp as jmxp
from repro.kernels.squarewave.ops import squarewave_load as j_sw_load
from repro.kernels.squarewave.ref import squarewave_ref as j_sw_ref
from repro_torch import align as talign
from repro_torch import fleet as tfleet
from repro_torch import interop
from repro_torch.core import (NodeFabric, RegionTracer, ToolSpec,
                              apply_corrections)
from repro_torch.core import nic_rail_corrections
from repro_torch.fleet import pipeline as tpl
from repro_torch.hpl import energy as tenergy
from repro_torch.hpl import hpg_mxp as thpg
from repro_torch.hpl import hpl as thpl
from repro_torch.hpl import hpl_mxp as tmxp
from repro_torch.kernels.squarewave import (calibrated_fma_count,
                                            squarewave_load)

CPU = "cpu"
REL = 1e-5

# the test workers share the machine's cores: keep torch from taking them all
torch.set_num_threads(2)


def _port_trace(tr):
    return interop.trace_from_fields(tr.name, dataclasses.asdict(tr.spec),
                                     tr.t_read, tr.t_measured, tr.value)


def _energies(rows):
    return np.array([[pe.energy_j for pe in row] for row in rows])


def _assert_energy_close(got, want, rel=REL):
    """Per-phase energies within ``rel`` x max(|E|, 1 J), same phases."""
    assert [[p.phase for p in r] for r in got] \
        == [[p.phase for p in r] for r in want]
    g, w = _energies(got), _energies(want)
    assert g.shape == w.shape and np.isfinite(g).all()
    err = np.abs(g - w) / np.maximum(np.abs(w), 1.0)
    assert err.max() <= rel, err.max()


# ------------------------------------------------ square-wave load (B8)

@pytest.mark.parametrize("fma_chain", [17, 80])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(256, 128), (512, 256), (1024, 64)])
def test_squarewave_plain_matches_jax(shape, dtype, fma_chain):
    """The plain version against the reference's kernel (interpret mode)
    and its oracle.  Both round twice per step, as the plain version
    does; the bound is the kernel's (one rounding per step): K * 2**-23
    in float32, the reference's own 2e-2 in bfloat16."""
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    got = squarewave_load(tx, fma_chain=fma_chain).float().numpy()
    rtol = fma_chain * 2.0 ** -23 if dtype == "float32" else 2e-2
    for want in (j_sw_load(jx, fma_chain=fma_chain, interpret=True),
                 j_sw_ref(jx, fma_chain=fma_chain)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=rtol)


@pytest.mark.parametrize("fma_chain", [17, 80])
@pytest.mark.parametrize("shape", [(256, 128), (512, 256), (1024, 64)])
def test_squarewave_plain_float64_bit_exact(shape, fma_chain):
    """float64, the paper's own generator: the plain version is the
    numpy float64 loop, bit for bit."""
    x = np.random.default_rng(1).normal(size=shape)
    got = squarewave_load(torch.as_tensor(x), fma_chain=fma_chain).numpy()
    a, b, acc = np.float64(1.000000119), x * 1e-6, x
    for _ in range(fma_chain):
        acc = acc * a + b
    np.testing.assert_array_equal(got, acc)


def _round_f32(v):
    """The float32 nearest the rational ``v``, ties to even."""
    f = np.float32(float(v))
    near = [np.nextafter(f, np.float32(-np.inf)), f,
            np.nextafter(f, np.float32(np.inf))]
    return min(near, key=lambda c: (abs(Fraction(float(c)) - v),
                                    int(np.array(c).view(np.int32)) & 1))


def _exact_fma(acc, a, b, dtype):
    """acc * a + b in exact rationals, rounded once to ``dtype``."""
    exact = [Fraction(float(x)) * Fraction(float(a)) + Fraction(float(y))
             for x, y in zip(acc, b)]
    if dtype == np.float64:
        return np.array([float(v) for v in exact])   # correctly rounded
    return np.array([_round_f32(v) for v in exact], np.float32)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_squarewave_fused_ref_rounds_once(dtype):
    """The kernel's plain twin rounds each step once: single steps over
    many exponents and a whole K = 17 chain match exact rational
    arithmetic rounded once, bit for bit.  The float32 case includes a
    sum that a float64 sum then a cast would round twice, and wrongly."""
    from repro_torch.kernels.squarewave.ref import (_fma_f64, _odd_sum,
                                                    _split,
                                                    squarewave_fused_ref)
    npt = getattr(np, dtype)
    rng = np.random.default_rng(7)
    acc = (rng.normal(size=2000)
           * 2.0 ** rng.integers(-20, 20, 2000)).astype(npt)
    b = (rng.normal(size=2000)
         * 2.0 ** rng.integers(-80, 5, 2000)).astype(npt)
    a = npt(1.000000119)
    if dtype == "float32":
        acc = np.concatenate([acc, np.float32([1.5, -1.5])])
        b = np.concatenate([b, np.float32([-2.0 ** -60, 2.0 ** -60])])
        got = _odd_sum(torch.as_tensor(acc).double() * float(a),
                       torch.as_tensor(b).double()).float().numpy()
        twice = (torch.as_tensor(acc[-2:]).double() * float(a)
                 + torch.as_tensor(b[-2:]).double()).float().numpy()
        assert not np.array_equal(twice, got[-2:])
    else:
        ta = torch.full(acc.shape, float(a), dtype=torch.float64)
        got = _fma_f64(torch.as_tensor(acc), _split(ta),
                       torch.as_tensor(b)).numpy()
    np.testing.assert_array_equal(got, _exact_fma(acc, a, b, npt))
    x = rng.normal(size=300).astype(npt)
    want, bx = x, (torch.as_tensor(x) * 1e-6).numpy()
    for _ in range(17):
        want = _exact_fma(want, a, bx, npt)
    np.testing.assert_array_equal(
        squarewave_fused_ref(torch.as_tensor(x), fma_chain=17).numpy(),
        want)


def test_squarewave_bfloat16_chain_cannot_move():
    """In bfloat16 ``a`` rounds to 1.0 and ``b = x * 1e-6`` lies below
    half an ulp of ``x``: both plain versions return ``x`` for any K, so
    a bfloat16 comparison checks the kernel's layout, not its chain."""
    from repro_torch.kernels.squarewave import (squarewave_fused_ref,
                                                squarewave_ref)
    x = torch.as_tensor(np.random.default_rng(3).normal(size=(64, 40)),
                        dtype=torch.bfloat16)
    assert torch.equal(squarewave_fused_ref(x, fma_chain=80), x)
    assert torch.equal(squarewave_ref(x, fma_chain=80), x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_calibrated_fma_count_matches_h100_balance(dtype):
    """FLOPs per byte moved, 2K / (2 * itemsize), is the H100's balance
    (peak / 3.35 TB/s) to within one FMA; bfloat16 half of float32."""
    from repro_torch.kernels.squarewave.ops import (H100_HBM_BW,
                                                    H100_PEAK_FLOPS)
    k = calibrated_fma_count(dtype)
    size = torch.empty((), dtype=dtype).element_size()
    balance = H100_PEAK_FLOPS[dtype] / H100_HBM_BW
    assert abs(2 * k / (2 * size) - balance) < 1.0
    assert abs(calibrated_fma_count(torch.float32)
               - 2 * calibrated_fma_count(torch.bfloat16)) <= 2
    assert calibrated_fma_count(dtype, balance_factor=2.0) \
        in (2 * k - 1, 2 * k, 2 * k + 1)


# ------------------------------------------------ HPL, HPL-MxP, HPG-MxP

@pytest.fixture(scope="module")
def hpl_case():
    a, b, x_true = jhpl.make_system(128)
    ta, tb, tx = interop.system_from_arrays(
        np.asarray(a), np.asarray(b), np.asarray(x_true), device=CPU)
    return dict(a=a, b=b, ta=ta, tb=tb, tx=tx)


def test_lu_factor_blocked_matches_jax(hpl_case):
    """Same pivots; LU within 1e-5 of the reference's largest entry (the
    trailing products sum in another order)."""
    lu_j, perm_j = jhpl.lu_factor_blocked(hpl_case["a"], nb=32)
    lu_t, perm_t = thpl.lu_factor_blocked(hpl_case["ta"], nb=32)
    np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm_j))
    w = np.asarray(lu_j)
    assert np.abs(lu_t.numpy() - w).max() <= REL * np.abs(w).max()


def test_lu_factor_blocked_float64_matches_scipy(hpl_case):
    """float64 (the H100's rocHPL baseline): the same pivots as LAPACK's
    getrf and LU within 1e-12."""
    a64 = hpl_case["ta"].to(torch.float64)
    lu, perm = thpl.lu_factor_blocked(a64, nb=32)
    lu_s, piv = scipy.linalg.lu_factor(a64.numpy())
    want = np.arange(128)
    for i, r in enumerate(piv):
        want[[i, r]] = want[[r, i]]
    np.testing.assert_array_equal(perm.numpy(), want)
    assert np.abs(lu.numpy() - lu_s).max() <= 1e-12


def test_hpl_solve_matches_jax(hpl_case):
    xj, ij = jhpl.hpl_solve(hpl_case["a"], hpl_case["b"], nb=32)
    xt, it = thpl.hpl_solve(hpl_case["ta"], hpl_case["tb"], nb=32)
    assert np.abs(xt.numpy() - np.asarray(xj)).max() <= 1e-4
    assert it["residual"] < 1e-4 and it["flops"] == ij["flops"]
    assert [e.name for e in it["tracer"].events] \
        == [e.name for e in ij["tracer"].events] \
        == ["hpl_factorize", "hpl_solve", "hpl_verify"]


def test_hpl_mxp_solve_matches_jax():
    a, b, _ = jmxp.make_dd_system(128)
    ta, tb, _ = interop.system_from_arrays(np.asarray(a), np.asarray(b),
                                           None, device=CPU)
    xj, ij = jmxp.hpl_mxp_solve(a, b, nb=32)
    xt, it = tmxp.hpl_mxp_solve(ta, tb, nb=32)
    assert np.abs(xt.numpy() - np.asarray(xj)).max() <= 1e-5
    assert abs(it["ir_iters"] - ij["ir_iters"]) <= 1
    assert it["residual"] < 1e-5
    assert [e.name for e in it["tracer"].events] \
        == ["mxp_factorize", "mxp_refine"]


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("bfloat16", 2e-2)])
def test_apply_stencil_matches_jax(dtype, tol):
    u = np.random.default_rng(2).normal(size=(16, 16, 16)).astype(
        np.float32)
    want = np.asarray(jhpg._apply_stencil(jnp.asarray(u),
                                          getattr(jnp, dtype)))
    got = thpg._apply_stencil(torch.as_tensor(u),
                              getattr(torch, dtype)).numpy()
    assert got.dtype == np.float32
    assert (np.abs(got - want) / np.maximum(np.abs(want), 1.0)).max() <= tol


@pytest.mark.parametrize("n_iters,mixed,tol", [(10, False, 1e-4),
                                               (20, False, 1e-4),
                                               (10, True, 2e-2)])
def test_hpg_solve_matches_jax(n_iters, mixed, tol):
    """Residual and the last three residual norms against the reference:
    1e-4 relative in float32.  With the bf16 matvec the two runs' dot
    products sum in different orders and each bf16 rounding of p can
    flip, so the trajectories part at bf16's resolution (the stencil's
    own 2e-2 bound)."""
    b = np.asarray(jhpg.make_poisson(16))
    _, ij = jhpg.hpg_solve(jnp.asarray(b), n_iters=n_iters, mixed=mixed)
    _, it = thpg.hpg_solve(torch.as_tensor(b.copy()), n_iters=n_iters,
                           mixed=mixed)
    assert abs(it["residual"] - ij["residual"]) <= tol * ij["residual"]
    assert len(it["conv"]) == 3
    for g, w in zip(it["conv"], ij["conv"]):
        assert abs(g - w) <= tol * abs(w)
    assert (it["flops"], it["bytes"]) == (ij["flops"], ij["bytes"])


def test_make_functions_draw_from_a_torch_generator():
    """The port's make_* functions are seeded torch draws: same seed, same
    system; the reference's structure (diagonal dominance, b = A 1)."""
    a1, b1, x1 = thpl.make_system(64, seed=3, device=CPU)
    a2, _, _ = thpl.make_system(64, seed=3, device=CPU)
    assert torch.equal(a1, a2) and not torch.equal(
        a1, thpl.make_system(64, seed=4, device=CPU)[0])
    assert float(a1.min()) >= -0.5 and float(a1.max()) < 0.5
    torch.testing.assert_close(b1, a1 @ x1)
    a64, b64, _ = thpl.make_system(64, seed=3, dtype=torch.float64,
                                   device=CPU)
    assert a64.dtype == b64.dtype == torch.float64
    assert torch.equal(a64, a1.double())
    ad, bd, _ = tmxp.make_dd_system(64, seed=3, device=CPU)
    off = ad - torch.diag(torch.diagonal(ad))
    assert bool((torch.diagonal(ad).abs() > off.abs().sum(1)).all())
    p = thpg.make_poisson(8, seed=3, device=CPU)
    assert p.shape == (8, 8, 8) and p.dtype == torch.float32


# ------------------------------------------------ fabric and corrections

def _tracers():
    """The full and the mixed run's phases, timed by hand (>= 0.5 s
    each, as the reference's own §V-B tests keep them)."""
    full, mxp = JRegionTracer(), JRegionTracer()
    for tr, spans in ((full, [("hpl_factorize", 0.0, 1.3),
                              ("hpl_solve", 1.3, 1.85),
                              ("hpl_verify", 1.85, 2.4)]),
                      (mxp, [("mxp_factorize", 0.0, 0.6),
                             ("mxp_refine", 0.6, 1.15)])):
        for name, a, b in spans:
            tr.add_region(name, a, b)
    return full, mxp


@pytest.fixture(scope="module")
def fabric_case():
    full, mxp = _tracers()
    shifted, truth = jenergy.phases_and_truth(full)
    nodes = [JNodeFabric(chip_truths=[truth] * 4).sample_all(
        JToolSpec(), seed=s) for s in range(2)]
    wanted = ["chip0_energy", "chip0_power_inst", "pm_accel0_power"]
    groups = [[nd[n] for n in wanted] for nd in nodes]
    return dict(full=full, mxp=mxp, shifted=shifted, truth=truth,
                nodes=nodes, groups=groups,
                port_groups=[[_port_trace(t) for t in g] for g in groups],
                port_truth=interop.power_from_arrays(truth.times,
                                                     truth.watts),
                counters=[nd[n] for nd in nodes
                          for n in ("chip0_energy", "pm_accel0_energy",
                                    "pm_accel2_energy")])


def test_tracer_round_trip_and_phases_and_truth(fabric_case):
    tracer = interop.tracer_from_arrays(fabric_case["full"].to_arrays())
    assert tracer.phases(depth=0) == fabric_case["full"].phases(depth=0)
    got = interop.tracer_from_arrays(tracer.to_arrays()).to_arrays()
    for k, v in fabric_case["full"].to_arrays().items():
        np.testing.assert_array_equal(got[k], v)
    shifted, truth = tenergy.phases_and_truth(tracer)
    assert shifted == fabric_case["shifted"]
    np.testing.assert_array_equal(truth.times, fabric_case["truth"].times)
    np.testing.assert_array_equal(truth.watts, fabric_case["truth"].watts)


def test_port_tracer_regions_nest_like_the_reference():
    t = iter(np.arange(0.0, 10.0, 0.5))
    port = RegionTracer(timebase=lambda: next(t), max_events=2)
    with port.region("outer"):
        with port.region("inner", device=1, step=2):
            pass
    port.add_region("late", 5.0, 6.0)
    assert port.dropped == 1
    assert [(e.name, e.depth) for e in port.events] == [("outer", 0),
                                                       ("late", 0)]
    assert port.phases(depth=0, name="outer") == [("outer", 0.5, 2.0)]
    assert len(port.flush()) == 2 and not port.events


def test_node_fabric_traces_bit_identical(fabric_case):
    """Every sensor of a node: the same seeded streams as the
    reference's fabric."""
    truth = fabric_case["port_truth"]
    got = NodeFabric(chip_truths=[truth] * 4).sample_all(ToolSpec(),
                                                         seed=1)
    want = fabric_case["nodes"][1]
    assert list(got) == list(want)
    for name, tr in want.items():
        for f in ("t_read", "t_measured", "value"):
            np.testing.assert_array_equal(getattr(got[name], f),
                                          getattr(tr, f))


def test_apply_corrections_bit_identical(fabric_case):
    node = fabric_case["nodes"][0]
    changed = 0
    for name in ("chip0_energy", "pm_accel0_power", "pm_accel0_energy",
                 "pm_accel1_power", "pm_accel2_energy"):
        want = j_apply(node[name], j_nic())
        got = apply_corrections(_port_trace(node[name]),
                                nic_rail_corrections())
        np.testing.assert_array_equal(got.value, want.value)
        np.testing.assert_array_equal(got.t_measured, want.t_measured)
        changed += not np.array_equal(got.value, node[name].value)
    assert changed == 4       # every PM view; the on-chip counter as is
    assert dataclasses.asdict(nic_rail_corrections()) \
        == dataclasses.asdict(j_nic())


def test_corrections_on_fleet_power_series_and_fleet_energy(fabric_case):
    counters = fabric_case["counters"]
    port = [_port_trace(tr) for tr in counters]
    got = tfleet.fleet_power_series(port, corrections=nic_rail_corrections(),
                                    device=CPU)
    want = jfleet.fleet_power_series(counters, corrections=j_nic())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.t, w.t)
        assert (np.abs(g.watts - w.watts)
                <= REL * np.maximum(np.abs(w.watts), 1.0)).all()
    phases = fabric_case["shifted"]
    got = tfleet.attribute_energy_fleet(port, phases, device=CPU,
                                        corrections=nic_rail_corrections())
    want = jfleet.attribute_energy_fleet(counters, phases,
                                         corrections=j_nic())
    _assert_energy_close(got, want)
    plain = tfleet.attribute_energy_fleet(port, phases, device=CPU)
    assert not np.allclose(_energies(plain)[1], _energies(got)[1])


def test_corrections_on_series_rows_and_stream_rows(fabric_case):
    flat = [tr for g in fabric_case["groups"] for tr in g]
    port = [tr for g in fabric_case["port_groups"] for tr in g]
    jrows = jalign.series_rows_from_traces(flat, corrections=j_nic())
    trows = talign.series_rows_from_traces(
        port, corrections=nic_rail_corrections(), device=CPU)
    for f in ("times", "values", "n", "first"):
        np.testing.assert_array_equal(getattr(trows, f), getattr(jrows, f))
    rj = jpl.pack_stream_rows(flat, corrections=j_nic())
    rt = tpl.pack_stream_rows(port, corrections=nic_rail_corrections())
    for f in ("times", "values", "kind_row", "n_samples"):
        np.testing.assert_array_equal(getattr(rt, f), getattr(rj, f))
    assert rt.t0 == rj.t0
    plain = tpl.pack_stream_rows(port)
    assert not np.array_equal(plain.values, rt.values)


def test_corrections_on_align_and_fuse(fabric_case):
    """Estimated delays within 1e-2 of a grid step (the off-chip PM row,
    read every 100 ms, has a flat correlation peak, so the sub-sample
    interpolation magnifies the scores' rounding: 2.2e-6 s here, 4e-3 of
    a step); with the grid and delays fixed, masks identical and fused
    watts within 1e-5."""
    est = jalign.align_and_fuse(fabric_case["groups"],
                                reference=fabric_case["truth"],
                                corrections=j_nic())
    got_est = talign.align_and_fuse(fabric_case["port_groups"], device=CPU,
                                    reference=fabric_case["port_truth"],
                                    corrections=nic_rail_corrections())
    grid = est[0].grid
    step = float(np.median(np.diff(grid)))
    delays = np.concatenate([fs.delays for fs in est])
    assert np.abs(np.concatenate([fs.delays for fs in got_est])
                  - delays).max() <= 1e-2 * step
    want = jalign.align_and_fuse(fabric_case["groups"], grid=grid,
                                 delays=delays, corrections=j_nic())
    got = talign.align_and_fuse(fabric_case["port_groups"], grid=grid,
                                delays=delays, device=CPU,
                                corrections=nic_rail_corrections())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.mask, w.mask)
        np.testing.assert_array_equal(g.stream_values, w.stream_values)
        np.testing.assert_allclose(g.watts, w.watts, rtol=REL, atol=1e-6)


@pytest.mark.parametrize("streaming", [False, True])
def test_corrections_on_attribute_energy_fused(fabric_case, streaming):
    phases = fabric_case["shifted"]
    if streaming:
        want = jpl.attribute_energy_fused_streaming(
            fabric_case["groups"], phases, reference=fabric_case["truth"],
            corrections=j_nic())
        got = tfleet.attribute_energy_fused_streaming(
            fabric_case["port_groups"], phases, device=CPU,
            reference=fabric_case["port_truth"],
            corrections=nic_rail_corrections())
    else:
        want = jalign.attribute_energy_fused(
            fabric_case["groups"], phases, reference=fabric_case["truth"],
            corrections=j_nic())
        got = talign.attribute_energy_fused(
            fabric_case["port_groups"], phases, device=CPU,
            reference=fabric_case["port_truth"],
            corrections=nic_rail_corrections())
    _assert_energy_close(got, want)


# ------------------------------------------------ the slice as a whole

def _port_tracer(jtracer):
    return interop.tracer_from_arrays(jtracer.to_arrays())


def test_energize_matches_jax(fabric_case):
    for seed in (0, 1):
        got = tenergy.energize(_port_tracer(fabric_case["full"]),
                               seed=seed, device=CPU)
        want = jenergy.energize(fabric_case["full"], seed=seed)
        _assert_energy_close([got], [want])


@pytest.mark.parametrize("use_fleet", [True, False])
def test_fleet_energize_matches_jax(fabric_case, use_fleet):
    got = tenergy.fleet_energize(_port_tracer(fabric_case["full"]), 2,
                                 use_fleet=use_fleet, device=CPU)
    want = jenergy.fleet_energize(fabric_case["full"], 2,
                                  use_fleet=use_fleet)
    _assert_energy_close(got, want)
    oracle = [tenergy.energize(_port_tracer(fabric_case["full"]), seed=k,
                               device=CPU) for k in range(2)]
    _assert_energy_close(got, oracle)


@pytest.mark.parametrize("streaming", [False, True])
def test_fused_fleet_energize_matches_jax(fabric_case, streaming):
    got = tenergy.fused_fleet_energize(_port_tracer(fabric_case["full"]), 2,
                                       streaming=streaming, device=CPU)
    want = jenergy.fused_fleet_energize(fabric_case["full"], 2,
                                        streaming=streaming)
    _assert_energy_close(got, want)


@pytest.mark.parametrize("use_fused", [False, True])
def test_mxp_energy_report_matches_jax(fabric_case, use_fused):
    full, mxp = fabric_case["full"], fabric_case["mxp"]
    got = tenergy.mxp_energy_report(_port_tracer(full), _port_tracer(mxp),
                                    2, use_fused=use_fused, device=CPU)
    want = jenergy.mxp_energy_report(full, mxp, 2, use_fused=use_fused)
    for key in ("per_node_full_j", "per_node_mxp_j"):
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert (np.abs(g - w) <= REL * np.maximum(np.abs(w), 1.0)).all()
    assert abs(got["saving"] - want["saving"]) <= REL
    assert set(got["decomposition"]) == set(want["decomposition"])
    for k, w in want["decomposition"].items():
        assert abs(got["decomposition"][k] - w) <= REL * max(abs(w), 1.0), k
    assert 0.0 < got["saving"] < 1.0
