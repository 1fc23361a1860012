"""PyTorch port, kernel modules: the plain versions (which the wrappers run
on CPU tensors) against the JAX reference's oracles on the same seeded
inputs, the ops' padding, and — on a card only — each CUDA kernel
against its plain version."""
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.align.delay import estimate_delays as jax_estimate_delays
from repro.kernels.flash_attention.ref import (flash_attention_ref as
                                               jax_flash_attention_ref)
from repro.kernels.ssm_scan.ref import (selective_scan_ref as
                                        jax_selective_scan_ref)
from repro.models.layers import attention as jax_attention
from repro.models.mamba import _chunk_scan as jax_chunk_scan
from repro.kernels.grid_resample.ref import (grid_resample_ref as
                                             jax_grid_resample_ref)
from repro.kernels.grid_resample.ref import (searchsorted_rows as
                                             jax_searchsorted_rows)
from repro.kernels.fleet_attribute.ref import (fleet_attribute_ref as
                                              jax_fleet_attribute_ref)
from repro.kernels.phase_integrate.ref import (phase_energies_ref as
                                              jax_phase_energies_ref)
from repro.kernels.power_reconstruct.ref import (
    reconstruct_power_fleet_ref as jax_reconstruct_fleet_ref)
from repro.kernels.power_reconstruct.ref import (
    reconstruct_power_ref as jax_reconstruct_power_ref)
from repro.kernels.power_reconstruct.ref import (
    reconstruct_power_rows_ref as jax_reconstruct_rows_ref)
from repro.kernels.xcorr_align.ops import make_refbank as jax_make_refbank
from repro.kernels.xcorr_align.ref import (xcorr_scores_ref as
                                           jax_xcorr_scores_ref)
from repro_torch.align.delay import estimate_delays, peak_to_delay
from torch_cases import (FA_EDGES, PHASE_EDGES, PR_EDGES, WRAP_26,
                         _attention_case, _counter_rows, _fa_edge_case,
                         _fleet_rows, _phase_edge_case, _phase_table,
                         _power_rows, _pr_edge_case, _regrid_case,
                         _regrid_edge_case, _scan_case, _t, _xcorr_case,
                         _xcorr_edge_case)

# the test workers share the machine's cores: keep torch from taking them all
torch.set_num_threads(2)
from repro_torch.kernels.grid_resample import (grid_resample,
                                               grid_resample_ref,
                                               searchsorted_rows,
                                               searchsorted_rows_sorted)
from repro_torch.kernels.fleet_attribute import (fleet_attribute,
                                                 fleet_attribute_kernel,
                                                 fleet_attribute_ref)
from repro_torch.kernels.phase_integrate import (phase_energies,
                                                 phase_energies_ref,
                                                 phase_integrate_kernel)
from repro_torch.kernels.power_reconstruct import (
    power_reconstruct_fleet_kernel, power_reconstruct_kernel,
    power_reconstruct_rows_kernel, reconstruct_power)
from repro_torch.kernels.power_reconstruct.ref import (
    reconstruct_power_fleet_ref, reconstruct_power_ref,
    reconstruct_power_rows_ref)
from repro_torch.kernels.xcorr_align import (make_refbank,
                                             xcorr_align_kernel,
                                             xcorr_scores, xcorr_scores_ref)
from repro_torch.kernels.xcorr_align.kernel import (MAX_CHUNKS, STAGE,
                                                    split_plan)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_kernel,
                                                 flash_attention_ref)
from repro_torch.kernels.ssm_scan import (selective_scan,
                                          selective_scan_kernel,
                                          selective_scan_ref)

# ------------------------------------------------------------------ B1

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_power_rows_plain_matches_reference_exactly(seed):
    e, t, w = _counter_rows(seed)
    assert (np.diff(e[0]) < 0).any(), "rows must really wrap"
    got = reconstruct_power_rows_ref(torch.from_numpy(e),
                                     torch.from_numpy(t),
                                     torch.from_numpy(w)).numpy()
    want = np.asarray(jax_reconstruct_rows_ref(jnp.asarray(e),
                                               jnp.asarray(t),
                                               jnp.asarray(w)))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_power_rows_wrapper_runs_plain_on_cpu_and_counts_nothing():
    e, t, w = (torch.from_numpy(a) for a in _counter_rows(3))
    before = power_reconstruct_rows_kernel.launches
    out = power_reconstruct_rows_kernel(e, t, w)
    assert torch.equal(out, reconstruct_power_rows_ref(e, t, w))
    assert power_reconstruct_rows_kernel.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        power_reconstruct_rows_kernel(e.to("meta"), t.to("meta"),
                                      w.to("meta"))


# ------------------------------------------------------------------ B5

@pytest.mark.parametrize("mode", ["hold", "linear"])
@pytest.mark.parametrize("sorted_search", [False, True])
def test_grid_resample_plain_matches_reference(mode, sorted_search):
    t, v, n, first, grid, d = _regrid_case(7)
    out, mask = grid_resample_ref(_t(t), _t(v), _t(n), _t(first),
                                  _t(grid), _t(d), mode=mode,
                                  sorted_search=sorted_search)
    w_out, w_mask = jax_grid_resample_ref(
        jnp.asarray(t), jnp.asarray(v), jnp.asarray(n), jnp.asarray(first),
        jnp.asarray(grid), jnp.asarray(d), mode=mode)
    w_out, w_mask = np.asarray(w_out), np.asarray(w_mask)
    np.testing.assert_array_equal(mask.numpy(), w_mask)
    assert mask.numpy().any() and not mask.numpy().all()
    if mode == "hold":
        np.testing.assert_array_equal(out.numpy(), w_out)
    else:
        np.testing.assert_allclose(out.numpy(), w_out, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("mode", ["hold", "linear"])
@pytest.mark.parametrize("kind", ["straddle", "duplicates", "sentinel"])
def test_grid_resample_plain_matches_reference_on_edges(kind, mode):
    """What the CUDA kernel must keep, on the JAX oracle: queries before
    t[first] and after t[n-1] with unsorted junk outside [first, n),
    runs of equal timestamps with grid points on them, and the -inf
    sentinel column; both of the port's searches."""
    t, v, n, first, grid, d = _regrid_edge_case(kind)
    w_out, w_mask = jax_grid_resample_ref(
        jnp.asarray(t), jnp.asarray(v), jnp.asarray(n), jnp.asarray(first),
        jnp.asarray(grid), jnp.asarray(d), mode=mode)
    w_out, w_mask = np.asarray(w_out), np.asarray(w_mask)
    q = grid[:, 0][None, :] + d
    rows = np.arange(t.shape[0])
    start = t[rows, first[:, 0]]            # past the sentinel, if any
    start = np.where(np.isfinite(start), start, t[rows, first[:, 0] + 1])
    assert (q < start[:, None]).any(1).all()
    assert (q > t[rows, n[:, 0] - 1][:, None]).any(1).all()
    for sorted_search in (False, True):
        out, mask = grid_resample_ref(_t(t), _t(v), _t(n), _t(first),
                                      _t(grid), _t(d), mode=mode,
                                      sorted_search=sorted_search)
        np.testing.assert_array_equal(mask.numpy(), w_mask)
        assert mask.numpy().any() and not mask.numpy().all()
        if mode == "hold":
            np.testing.assert_array_equal(out.numpy(), w_out)
        else:
            np.testing.assert_allclose(out.numpy(), w_out, rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_lower_bound_loop_sorted_and_reference_identical(seed):
    t, _, n, first, grid, d = _regrid_case(seed)
    q = grid[:, 0][None, :] + d
    loop = searchsorted_rows(_t(t), _t(q), _t(first), _t(n)).numpy()
    srt = searchsorted_rows_sorted(_t(t), _t(q), _t(first), _t(n)).numpy()
    ref = np.asarray(jax_searchsorted_rows(jnp.asarray(t), jnp.asarray(q),
                                           jnp.asarray(first),
                                           jnp.asarray(n)))
    np.testing.assert_array_equal(loop, ref)
    np.testing.assert_array_equal(srt, ref)
    # on unmasked rows it is torch.searchsorted's left insertion point
    full = (first[:, 0] == 0) & (n[:, 0] == t.shape[1])
    plain = torch.searchsorted(_t(t[full]), _t(q[full])).numpy()
    np.testing.assert_array_equal(loop[full], plain)


def test_grid_resample_op_pads_the_grid_and_slices_back():
    t, v, n, first, grid, d = _regrid_case(4, sentinel=False)
    out, mask = grid_resample(_t(t), _t(v), _t(n), _t(first), _t(grid),
                              _t(d))
    assert out.shape == (t.shape[0], grid.shape[0])
    ref_out, ref_mask = grid_resample_ref(_t(t), _t(v), _t(n), _t(first),
                                          _t(grid), _t(d))
    assert torch.equal(out, ref_out) and torch.equal(mask, ref_mask)


# ------------------------------------------------------------------ B4

def test_make_refbank_matches_reference():
    _, _, ref, _, max_lag = _xcorr_case(0)
    got = make_refbank(torch.tensor(ref, dtype=torch.float32),
                       max_lag=max_lag).numpy()
    want = np.asarray(jax_make_refbank(jnp.asarray(ref, jnp.float32),
                                       max_lag=max_lag))
    assert got.shape == (2 * max_lag + 1, len(ref))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_xcorr_plain_matches_reference(seed):
    x, m, ref, _, max_lag = _xcorr_case(seed)
    bank = np.asarray(jax_make_refbank(jnp.asarray(ref, jnp.float32),
                                       max_lag=max_lag))
    got = xcorr_scores_ref(_t(x), _t(m), _t(bank)).numpy()
    want = np.asarray(jax_xcorr_scores_ref(jnp.asarray(x), jnp.asarray(m),
                                           jnp.asarray(bank)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the op's LAG_ALIGN / ROW_ALIGN padding changes no score
    padded = xcorr_scores(_t(x), _t(m), _t(bank)).numpy()
    assert padded.shape == got.shape
    np.testing.assert_allclose(padded, got, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("g", [1, 700])
@pytest.mark.parametrize("lags", [1, 129])
def test_xcorr_plain_matches_reference_on_edges(lags, g):
    """The plain version against the JAX oracle on the card tests' edge
    rows: one lag or 129, an all-masked row (scores exactly 0) and a row
    offset by 1e4 W."""
    x, m, ref, max_lag = _xcorr_edge_case(9, g, lags)
    bank = np.asarray(jax_make_refbank(jnp.asarray(ref, jnp.float32),
                                       max_lag=max_lag))
    got = xcorr_scores_ref(_t(x), _t(m), _t(bank)).numpy()
    want = np.asarray(jax_xcorr_scores_ref(jnp.asarray(x), jnp.asarray(m),
                                           jnp.asarray(bank)))
    assert got.shape == (9, lags)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert not got[0].any() and not want[0].any()


@pytest.mark.parametrize("g", [0, 1, 31, 32, 33, 700, 2048, 15912, 16384,
                               100000])
def test_xcorr_split_plan_covers_g_in_whole_stages(g):
    per, chunks = split_plan(g)
    stages = -(-g // STAGE)
    assert 1 <= chunks <= MAX_CHUNKS and per >= 1
    assert (chunks - 1) * per < max(stages, 1) <= chunks * per


def test_xcorr_split_plan_is_a_function_of_g_alone():
    """The split's points depend on G alone (the row count is not an
    argument), so a row's summation order never depends on F; the main
    path's shapes get 16 chunks of 4 stages and 2 of 249."""
    assert list(inspect.signature(split_plan).parameters) == ["g"]
    assert split_plan(2048) == (4, 16)
    assert split_plan(15912) == (249, 2)


def test_estimate_delays_matches_reference():
    x, m, ref, lag, max_lag = _xcorr_case(5)
    step = 5e-4
    got = estimate_delays(_t(x), _t(m), ref, step=step, max_lag=max_lag)
    want = jax_estimate_delays(x, m, ref, step=step, max_lag=max_lag,
                               interpret=True, block_rows=8)
    np.testing.assert_allclose(got.delay_s.numpy() / step,
                               np.asarray(want.delay_s) / step, atol=1e-3)
    np.testing.assert_allclose(got.peak_corr.numpy(), want.peak_corr,
                               atol=1e-5)
    assert np.all(np.abs(got.lag_steps.numpy() - lag) < 0.6)


def test_peak_to_delay_matches_reference_on_edges_and_ties():
    from repro.align.delay import peak_to_delay as jax_peak_to_delay
    rng = np.random.default_rng(11)
    s = rng.uniform(-1.0, 1.0, (40, 9))
    s[0, 0] = s[1, -1] = 2.0                          # peaks at the edges
    s[2, 3:6] = 1.5                                   # a flat top
    s[3, [2, 6]] = 1.7                                # a tie
    got = peak_to_delay(torch.from_numpy(s), 1e-3, 4)
    want = jax_peak_to_delay(s, 1e-3, 4)
    np.testing.assert_array_equal(got.lag_steps.numpy(), want.lag_steps)
    np.testing.assert_array_equal(got.peak_corr.numpy(), want.peak_corr)
    np.testing.assert_array_equal(got.delay_s.numpy(), want.delay_s)


def test_xcorr_wrapper_rejects_other_devices():
    x, m, ref, _, max_lag = _xcorr_case(1)
    bank = make_refbank(torch.tensor(ref, dtype=torch.float32),
                        max_lag=max_lag)
    with pytest.raises(ValueError, match="unsupported device"):
        xcorr_align_kernel(_t(x).to("meta"), _t(m).to("meta"),
                           bank.to("meta"), n_lags=bank.shape[0])


# ------------------------------------------------------------------ B2

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_power_fleet_plain_matches_reference_exactly(seed):
    """Power, ``valid`` and ``reordered`` bit-identical to the JAX oracle,
    on rows with duplicates, short rows, wraps and reordered reads."""
    e, t, w, n = _fleet_rows(seed)
    got = reconstruct_power_fleet_ref(_t(e), _t(t), _t(w), _t(n))
    want = jax_reconstruct_fleet_ref(jnp.asarray(e), jnp.asarray(t),
                                     jnp.asarray(w), jnp.asarray(n))
    for g, x in zip(got, want):
        assert g.shape == tuple(x.shape)
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    reordered = got[2].numpy()[:, 0]
    assert reordered[[2, 9]].all() and reordered.sum() == 2
    assert not got[1].numpy().all() and got[1].numpy().any()


@pytest.mark.parametrize("kind", PR_EDGES)
def test_power_fleet_plain_matches_reference_on_edges(kind):
    """What the CUDA kernel must keep, on the JAX oracle, bit for bit:
    rows with no read or one, every row cut short (n at every residue mod
    4), reads out of order inside and past n, duplicate runs, wraps, S =
    300 .. 303, and S = 3 and 1."""
    e, t, w, n = _pr_edge_case(kind)
    got = reconstruct_power_fleet_ref(_t(e), _t(t), _t(w), _t(n))
    want = jax_reconstruct_fleet_ref(jnp.asarray(e), jnp.asarray(t),
                                     jnp.asarray(w), jnp.asarray(n))
    for g, x in zip(got, want):
        assert g.shape == tuple(x.shape)
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    valid, reordered = got[1].numpy(), got[2].numpy()[:, 0]
    assert not valid[:, 0].any()
    assert not valid[n[:, 0] <= 1].any()
    if kind == "reordered":
        assert reordered.tolist() == [r % 4 != 3 for r in range(len(n))]
    if kind == "s1":
        assert not valid.any() and not reordered.any()
    elif kind not in ("n0",):
        assert valid.any()


# ------------------------------------------------------------------ B3

@pytest.mark.parametrize("wrap", [0.0, WRAP_26, 7.5])
def test_power_scalar_wrap_plain_matches_reference_exactly(wrap):
    """The unreassociated ``de + wrap`` form, bit for bit."""
    e, t, _ = _counter_rows(4)
    if wrap:
        e = np.mod(e.astype(np.float64), wrap).astype(np.float32)
        assert (np.diff(e, axis=1) < -0.5 * wrap).any()
    got = reconstruct_power(_t(e), _t(t), wrap_period=wrap).numpy()
    want = np.asarray(jax_reconstruct_power_ref(jnp.asarray(e),
                                                jnp.asarray(t),
                                                wrap_period=wrap))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        reconstruct_power_ref(_t(e), _t(t), wrap_period=wrap).numpy(), got)


# ------------------------------------------------------------------ B6

def _energy_close(got, want):
    """Per-phase energies within 1e-5 x max(|E|, 1 J): the summation
    order differs from the reference's reduction."""
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want)
    assert (err <= 1e-5 * np.maximum(np.abs(want), 1.0)).all(), err.max()


@pytest.mark.parametrize("seed", [0, 1])
def test_phase_integrate_plain_matches_reference(seed):
    t, w = _power_rows(seed)
    ph = _phase_table(seed)
    got = phase_energies(_t(t), _t(w), _t(ph)).numpy()
    want = np.asarray(jax_phase_energies_ref(jnp.asarray(t), jnp.asarray(w),
                                             jnp.asarray(ph)))
    assert got.shape == (t.shape[0], 32) and np.isfinite(got).all()
    assert (got[:, :5] > 0).any() and (got[:, 5:] == 0).all()
    _energy_close(got, want)


@pytest.mark.parametrize("kind", PHASE_EDGES)
def test_phase_integrate_plain_matches_reference_on_edges(kind):
    """What the CUDA kernel must keep, on the JAX oracle: NaN and inf
    watts and a NaN time (non-finite in every phase of their rows, NaN at
    the same places), the -inf carry column, 32 overlapping unsorted
    windows, empty windows between real ones, and 39 windows."""
    t, w, ph = _phase_edge_case(kind)
    got = phase_energies(_t(t), _t(w), _t(ph)).numpy()
    want = np.asarray(jax_phase_energies_ref(jnp.asarray(t), jnp.asarray(w),
                                             jnp.asarray(ph)))
    assert got.shape == (t.shape[0], ph.shape[0])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    inf = np.isinf(want)
    np.testing.assert_array_equal(got[inf], want[inf])
    fin = np.isfinite(want)
    _energy_close(got[fin], want[fin])
    bad = ~np.isfinite(got).all(1)
    if kind == "nonfinite":
        assert bad.nonzero()[0].tolist() == [2, 5, 9]
        assert not np.isfinite(got[[2, 5, 9]]).any()
    else:
        assert not bad.any() and (got > 0).any()


# ------------------------------------------------------------------ B7

@pytest.mark.parametrize("seed", [0, 1])
def test_fleet_attribute_plain_matches_reference(seed):
    e, t, w = _counter_rows(seed)
    ph = _phase_table(seed)
    got = fleet_attribute(_t(t), _t(e), _t(w), _t(ph)).numpy()
    want = np.asarray(jax_fleet_attribute_ref(jnp.asarray(t), jnp.asarray(e),
                                              jnp.asarray(w),
                                              jnp.asarray(ph)))
    assert np.isfinite(got).all() and (got[:, :5] > 0).any()
    _energy_close(got, want)


def test_fleet_attribute_duplicates_add_exactly_zero():
    """A duplicate read (same t, same E) is a zero-width interval: it adds
    exactly 0 J, and the rows around it keep their energy."""
    e, t, w = _counter_rows(5, f=4, s=100)
    ph = _phase_table(5, t_hi=0.1)
    dup_t = np.insert(t, 40, t[:, 39], axis=1)
    dup_e = np.insert(e, 40, e[:, 39], axis=1)
    pair = fleet_attribute_ref(_t(dup_t[:, 39:41]), _t(dup_e[:, 39:41]),
                               _t(w), _t(ph))
    assert torch.equal(pair, torch.zeros_like(pair))
    a = fleet_attribute_ref(_t(t), _t(e), _t(w), _t(ph)).numpy()
    b = fleet_attribute_ref(_t(dup_t), _t(dup_e), _t(w), _t(ph)).numpy()
    _energy_close(b, a)


@pytest.mark.parametrize("kind", FA_EDGES)
def test_fleet_attribute_plain_matches_reference_on_edges(kind):
    """What the CUDA kernel must keep, on the JAX oracle: NaN and inf
    reads (NaN and inf at the same places), the carry column of
    ``FleetStream``'s first update and a -inf one, wraps inside every
    slice, counters stepping back by less than half the wrap (negative
    power), duplicate runs, 32 overlapping windows, empty windows between
    real ones, and 39 windows."""
    t, e, w, ph = _fa_edge_case(kind)
    got = fleet_attribute(_t(t), _t(e), _t(w), _t(ph)).numpy()
    want = np.asarray(jax_fleet_attribute_ref(jnp.asarray(t), jnp.asarray(e),
                                              jnp.asarray(w),
                                              jnp.asarray(ph)))
    assert got.shape == (t.shape[0], ph.shape[0])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    inf = np.isinf(want)
    np.testing.assert_array_equal(got[inf], want[inf])
    fin = np.isfinite(want)
    _energy_close(got[fin], want[fin])
    bad = ~np.isfinite(got).all(1)
    if kind == "nonfinite":
        # an inf time gives its two intervals 0 J (p = dE/inf, and an
        # overlap of -inf clamped to 0): row 11 stays finite
        assert bad.nonzero()[0].tolist() == [2, 5, 9]
    else:
        assert not bad.any() and (got > 0).any()
    if kind == "stepback":
        p = reconstruct_power_rows_ref(_t(e), _t(t), _t(w)).numpy()
        assert (p < 0).any()
    if kind == "carry":
        assert (t[:, 0] == t[:, 1]).all() and (got[6] == 0).all()


# ------------------------------------------- the wrappers on the CPU

def _wrapper_cases():
    e, t, w, n = (torch.from_numpy(a) for a in _fleet_rows(6))
    tp, wp = (torch.from_numpy(a) for a in _power_rows(6))
    ph = torch.from_numpy(_phase_table(6))
    return [
        (power_reconstruct_fleet_kernel, (e, t, w, n), {},
         reconstruct_power_fleet_ref),
        (power_reconstruct_kernel, (e, t), {"wrap_period": 7.5},
         reconstruct_power_ref),
        (phase_integrate_kernel, (tp, wp, ph), {}, phase_energies_ref),
        (fleet_attribute_kernel, (t, e, w, ph), {}, fleet_attribute_ref),
        (flash_attention_kernel,
         tuple(torch.from_numpy(a) for a in _attention_case(6, s=40)),
         {"causal": True, "logit_cap": 50.0}, flash_attention_ref),
        (selective_scan_kernel,
         tuple(torch.from_numpy(a) for a in _scan_case(6, seq=20)), {},
         selective_scan_ref),
    ]


@pytest.mark.parametrize("case", range(6))
def test_new_wrappers_run_plain_on_cpu_and_raise_elsewhere(case):
    """On CPU tensors each wrapper is its plain version and counts no
    launch; on any other device (not CUDA) it raises."""
    fn, args, kw, plain = _wrapper_cases()[case]
    before = fn.launches
    got, want = fn(*args, **kw), plain(*args, **kw)
    for g, x in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, x)
    assert fn.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        fn(*(a.to("meta") for a in args), **kw)


# ------------------------------------------------------------------ B9

def _bf16_np(a):
    """float32 numpy -> (jnp bfloat16, torch bfloat16), the same values."""
    return (jnp.asarray(a, jnp.bfloat16),
            torch.from_numpy(a).to(torch.bfloat16))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("cap", [0.0, 50.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_reference(dtype, cap, causal):
    """S = 200 (not a multiple of the reference kernel's 128 block), GQA
    4/2; float32 within 1e-5 of the largest output, bfloat16 at the
    reference's bf16 bounds."""
    q, k, v = _attention_case(0, s=200)
    if dtype == "float32":
        jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    else:
        (jq, tq), (jk, tk), (jv, tv) = (_bf16_np(a) for a in (q, k, v))
    want = np.asarray(jax_flash_attention_ref(jq, jk, jv, causal=causal,
                                              logit_cap=cap), np.float32)
    got = flash_attention(tq, tk, tv, causal=causal, logit_cap=cap)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    got = got.float().numpy()
    if dtype == "float32":
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, atol=5e-2, rtol=1e-2)


def test_flash_attention_plain_takes_the_model_layout():
    """The model hands (B, S, H, D) activations over transposed; the
    plain version gives the same as on contiguous (B, H, S, D) input."""
    q, k, v = (torch.from_numpy(a) for a in _attention_case(1, s=33))
    qt, kt, vt = (x.transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (q, k, v))
    assert not qt.is_contiguous()
    torch.testing.assert_close(flash_attention(qt, kt, vt),
                               flash_attention(q, k, v), rtol=0, atol=0)


@pytest.mark.parametrize("sq,sk", [(1, 40), (17, 40), (40, 7), (33, 33)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_kv_length_matches_reference(dtype, sq, sk):
    """Non-causal with a key length of its own (whisper's
    cross-attention) against the reference's ``attention`` (the jnp form
    its models run), GQA 4/2; float32 within 1e-5 of the largest
    output, bfloat16 at the reference's bf16 bounds."""
    q = _attention_case(10, s=sq)[0]
    _, k, v = _attention_case(11, s=sk)
    if dtype == "float32":
        jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    else:
        (jq, tq), (jk, tk), (jv, tv) = (_bf16_np(a) for a in (q, k, v))
    want = np.asarray(jax_attention(*(x.swapaxes(1, 2)
                                      for x in (jq, jk, jv)),
                                    causal=False).swapaxes(1, 2),
                      np.float32)
    got = flash_attention(tq, tk, tv, causal=False)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    got = got.float().numpy()
    if dtype == "float32":
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, atol=5e-2, rtol=1e-2)


@pytest.mark.parametrize("cap", [0.0, 50.0])
@pytest.mark.parametrize("window", [1, 5, 16, 40, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_window_matches_reference(dtype, window, cap):
    """Causal with a sliding window (gemma2's local layers) against the
    reference's ``attention`` at the same window and cap (a window of
    at least S masks nothing)."""
    q, k, v = _attention_case(12, s=40)
    if dtype == "float32":
        jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    else:
        (jq, tq), (jk, tk), (jv, tv) = (_bf16_np(a) for a in (q, k, v))
    want = np.asarray(jax_attention(*(x.swapaxes(1, 2)
                                      for x in (jq, jk, jv)),
                                    causal=True, window=window,
                                    logit_cap=cap).swapaxes(1, 2),
                      np.float32)
    got = flash_attention(tq, tk, tv, logit_cap=cap, window=window)
    got = got.float().numpy()
    if dtype == "float32":
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, atol=5e-2, rtol=1e-2)
    if window >= 40:
        torch.testing.assert_close(
            flash_attention(tq, tk, tv, logit_cap=cap, window=window),
            flash_attention(tq, tk, tv, logit_cap=cap), rtol=0, atol=0)


def test_flash_attention_refuses_causal_kv_length_and_open_window():
    """A window needs causality and an offset must be >= 0: both raise
    before any device is chosen.  A causal call with a key length of its
    own is no longer refused: row i sits at position q_offset + i (0
    here), as in the reference's ``attention``, within 1e-5."""
    q = torch.from_numpy(_attention_case(13, s=8)[0])
    _, k, v = (torch.from_numpy(a) for a in _attention_case(13, s=12))
    want = np.asarray(jax_attention(
        *(jnp.asarray(x.numpy().swapaxes(1, 2)) for x in (q, k, v)),
        causal=True)).swapaxes(1, 2)
    got = flash_attention_kernel(q, k, v, causal=True).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    with pytest.raises(ValueError, match="needs causal"):
        flash_attention_kernel(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention_kernel(q, k, v, causal=True, q_offset=-1)


def test_flash_attention_refuses_unported_options():
    q, k, v = (torch.from_numpy(a) for a in _attention_case(2, s=8))
    with pytest.raises(NotImplementedError, match="interpret=True"):
        flash_attention(q, k, v, interpret=True)
    with pytest.raises(NotImplementedError, match="use_kernel=False"):
        flash_attention(q, k, v, use_kernel=False)


# ------------------------------------------------------------------ B10

@pytest.mark.parametrize("seed,n", [(0, 8), (1, 16)])
def test_selective_scan_plain_matches_reference(seed, n):
    dt, x, bm, cm, a, h0 = _scan_case(seed, n=n)
    y, h = selective_scan(*(torch.from_numpy(v) for v in
                            (dt, x, bm, cm, a, h0)))
    wy, wh = jax_selective_scan_ref(*(jnp.asarray(v) for v in
                                      (dt, x, bm, cm, a, h0)))
    wy, wh = np.asarray(wy), np.asarray(wh)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    assert np.abs(y.numpy() - wy).max() <= 1e-5 * np.abs(wy).max()
    assert np.abs(h.numpy() - wh).max() <= 1e-5 * np.abs(wh).max()


def test_selective_scan_plain_matches_model_chunk_scan():
    """Against the Mamba layer's own scan, chunk by chunk with the carry
    (four 24-step chunks), as ``mamba_apply`` runs it."""
    dt, x, bm, cm, a, h0 = _scan_case(2, seq=96)
    y, h = selective_scan(*(torch.from_numpy(v) for v in
                            (dt, x, bm, cm, a, h0)))
    hc = jnp.asarray(h0)
    ys = []
    for i in range(0, 96, 24):
        dtc, bc, cc, xc = (jnp.asarray(v[:, i:i + 24])
                           for v in (dt, bm, cm, x))
        yc, hc = jax_chunk_scan(dtc, bc, cc, jnp.asarray(a), xc, hc)
        ys.append(np.asarray(yc))
    wy, wh = np.concatenate(ys, axis=1), np.asarray(hc)
    assert np.abs(y.numpy() - wy).max() <= 1e-5 * np.abs(wy).max()
    assert np.abs(h.numpy() - wh).max() <= 1e-5 * np.abs(wh).max()


def test_selective_scan_bf16_input_rounds_y_once():
    """x in bfloat16 (the model's compute dtype): y comes back bfloat16,
    the float32 result rounded once; the state stays float32."""
    dt, x, bm, cm, a, h0 = _scan_case(3, seq=40)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    args = [torch.from_numpy(v) for v in (dt, bm, cm, a, h0)]
    y, h = selective_scan(args[0], tx, *args[1:])
    y32, h32 = selective_scan(args[0], tx.float(), *args[1:])
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert torch.equal(y, y32.to(torch.bfloat16))
    assert torch.equal(h, h32)


# ------------------------------------------------------- B9's gradient

def _cotangent(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(
        np.float32)


@pytest.mark.parametrize("case", [
    # (form, Sq, Sk, causal, window, cap)
    ("ref", 40, 40, True, 0, 0.0), ("ref", 40, 40, True, 0, 50.0),
    ("ref", 33, 33, False, 0, 50.0),
    ("attend", 40, 40, True, 7, 0.0), ("attend", 40, 40, True, 16, 50.0),
    ("attend", 17, 40, False, 0, 0.0), ("attend", 40, 7, False, 0, 0.0)])
def test_flash_attention_plain_gradient_matches_reference(case):
    """The port's CPU gradient of B9 (autograd through its plain version,
    the backward the card's kernel is held to) against ``jax.grad`` of
    the reference's jnp forms: its ``flash_attention_ref`` (causal or
    not, cap) and its models' ``attention`` (a window; non-causal with a
    key length of its own), GQA 4/2, float32: dq/dk/dv within 1e-5 of
    each gradient's largest magnitude."""
    form, sq, sk, causal, window, cap = case
    q = _attention_case(30, s=sq)[0]
    _, k, v = _attention_case(31, s=sk)
    w = _cotangent(q.shape, 32)

    def jax_out(q, k, v):
        if form == "ref":
            return jax_flash_attention_ref(q, k, v, causal=causal,
                                           logit_cap=cap)
        return jax_attention(*(x.swapaxes(1, 2) for x in (q, k, v)),
                             causal=causal, window=window,
                             logit_cap=cap).swapaxes(1, 2)

    want = jax.grad(lambda q, k, v: jnp.sum(jax_out(q, k, v) * w),
                    argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal, logit_cap=cap,
                          window=window if causal else 0)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(w))
    for g, x in zip(got, want):
        x = np.asarray(x)
        assert g.shape == x.shape
        assert np.abs(g.numpy() - x).max() <= 1e-5 * np.abs(x).max()


def test_refuse_detached_raises_only_while_recording():
    """The guard every gradient-less kernel wrapper calls before a CUDA
    launch: it raises naming the ROADMAP item when autograd records and
    an input requires a gradient, and passes otherwise."""
    from repro_torch.device import refuse_detached
    x = torch.ones(3, requires_grad=True)
    item = "B10: call ops.selective_scan"
    with pytest.raises(NotImplementedError, match=rf"ROADMAP {item}"):
        refuse_detached("selective_scan", x, None, item=item)
    with torch.no_grad():
        refuse_detached("selective_scan", x, item=item)
    refuse_detached("selective_scan", x.detach(), 3, item=item)


def test_flash_attention_cpu_gradient_is_the_plain_versions():
    """On CPU tensors ``flash_attention`` is its plain version, autograd
    included: the same gradient, bit for bit, and no launch counted."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_kernel)
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _attention_case(33, s=24))
    n0 = (flash_attention_kernel.launches,
          flash_attention_bwd_kernel.launches)
    g1 = torch.autograd.grad(flash_attention(q, k, v, logit_cap=50.0).sum(),
                             (q, k, v))
    g2 = torch.autograd.grad(
        flash_attention_ref(q, k, v, logit_cap=50.0).sum(), (q, k, v))
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)
    assert (flash_attention_kernel.launches,
            flash_attention_bwd_kernel.launches) == n0
