"""PyTorch port, on the card only: each CUDA kernel against its plain
PyTorch version.  Imports nothing of JAX, so it runs on a machine with a
card and no JAX:

    PYTHONPATH=src python -m pytest tests/test_torch_gpu.py -m gpu -q

Without a card every test here skips (the kernels have no CPU mode).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.fleet_attribute import (fleet_attribute_kernel,
                                                 fleet_attribute_ref)
from repro_torch.kernels.grid_resample import (grid_resample_kernel,
                                               grid_resample_ref)
from repro_torch.kernels.phase_integrate import (phase_energies_ref,
                                                 phase_integrate_kernel)
from repro_torch.kernels.power_reconstruct import (
    power_reconstruct_fleet_kernel, power_reconstruct_kernel,
    power_reconstruct_rows_kernel)
from repro_torch.kernels.squarewave import (squarewave_fused_ref,
                                            squarewave_kernel,
                                            squarewave_load, squarewave_ref)
from repro_torch.kernels.power_reconstruct.ref import (
    reconstruct_power_fleet_ref, reconstruct_power_ref,
    reconstruct_power_rows_ref)
from repro_torch.kernels.xcorr_align import (LAG_ALIGN, make_refbank,
                                             xcorr_align_kernel,
                                             xcorr_scores, xcorr_scores_ref)
from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                 flash_attention_ref)
from repro_torch.kernels.ssm_scan import (selective_scan,
                                          selective_scan_bwd_kernel,
                                          selective_scan_kernel,
                                          selective_scan_ref)
from repro_torch.kernels import build
from torch_cases import (FA_EDGES, PHASE_EDGES, PR_EDGES, REGRID_EDGES,
                         WRAP_26, _attention_case, _counter_rows,
                         _fa_edge_case, _fleet_rows, _phase_edge_case,
                         _phase_partition, _phase_table, _power_rows,
                         _pr_edge_case, _regrid_case, _regrid_edge_case,
                         _scan_case, _t, _xcorr_case, _xcorr_edge_case)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_power_rows_matches_plain():
    dev = _cuda()
    e, t, w = (torch.from_numpy(a).to(dev) for a in _counter_rows(0))
    n0 = power_reconstruct_rows_kernel.launches
    k = power_reconstruct_rows_kernel(e, t, w)
    torch.cuda.synchronize()
    assert power_reconstruct_rows_kernel.launches == n0 + 1
    assert torch.equal(k, reconstruct_power_rows_ref(e, t, w))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["hold", "linear"])
def test_cuda_grid_resample_matches_plain(mode):
    dev = _cuda()
    t, v, n, first, grid, d = (_t(a).to(dev) for a in _regrid_case(2))
    ko, km = grid_resample_kernel(t, v, n[:, 0].contiguous(),
                                  first[:, 0].contiguous(),
                                  grid[:, 0].contiguous(),
                                  d[:, 0].contiguous(), mode=mode)
    po, pm = grid_resample_ref(t, v, n, first, grid, d, mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(km, pm)
    if mode == "hold":
        assert torch.equal(ko, po)
    else:
        torch.testing.assert_close(ko, po, rtol=1e-5, atol=1e-5,
                                   equal_nan=True)


@pytest.mark.gpu
def test_cuda_xcorr_matches_plain_and_ignores_row_count():
    dev = _cuda()
    x, m, ref, _, max_lag = _xcorr_case(3)
    bank = make_refbank(torch.tensor(ref, dtype=torch.float32, device=dev),
                        max_lag=max_lag)
    x, m = _t(x).to(dev), _t(m).to(dev)
    k = xcorr_scores(x, m, bank)
    torch.testing.assert_close(k, xcorr_scores_ref(x, m, bank), rtol=0,
                               atol=1e-5)
    # a row's score is bit-identical however many rows are scored
    assert torch.equal(xcorr_scores(x[:8], m[:8], bank), k[:8])


@pytest.mark.gpu
def test_cuda_xcorr_writes_zero_scores_for_padded_lags():
    dev = _cuda()
    x, m, ref, _, max_lag = _xcorr_case(4, f=40, g=700)
    bank = make_refbank(torch.tensor(ref, dtype=torch.float32, device=dev),
                        max_lag=max_lag)
    lags = bank.shape[0]
    padded = torch.cat([bank, bank.new_zeros((128 - lags, bank.shape[1]))])
    x, m = _t(x).to(dev), _t(m).to(dev)
    k = xcorr_align_kernel(x, m, padded, n_lags=lags)
    torch.cuda.synchronize()
    assert torch.equal(k[:, lags:], torch.zeros_like(k[:, lags:]))
    torch.testing.assert_close(k, xcorr_scores_ref(x, m, padded), rtol=0,
                               atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("lags", [1, 129, 1025])
@pytest.mark.parametrize("g", [1, 700, 2048, 16384])
@pytest.mark.parametrize("f", [1, 7, 9, 1024])
def test_cuda_xcorr_edges(f, g, lags):
    """Within 1e-5 of the plain version, exact zeros on the padded lags,
    and rows scored alone bit-identical to the same rows within F (an
    all-masked row 0 and a row offset by 1e4 W included)."""
    dev = _cuda()
    x, m, ref, max_lag = _xcorr_edge_case(f, g, lags)
    bank = make_refbank(torch.tensor(ref, dtype=torch.float32, device=dev),
                        max_lag=max_lag)
    bank = torch.cat([bank, bank.new_zeros(((-lags) % LAG_ALIGN, g))])
    x, m = _t(x).to(dev), _t(m).to(dev)
    k = xcorr_align_kernel(x, m, bank, n_lags=lags)
    torch.cuda.synchronize()
    assert torch.equal(k[:, lags:], torch.zeros_like(k[:, lags:]))
    torch.testing.assert_close(k, xcorr_scores_ref(x, m, bank), rtol=0,
                               atol=1e-5)
    for a, b in {(0, 1), (1, min(f, 8)), (f // 2, f)}:
        if a < b:
            alone = xcorr_align_kernel(x[a:b].contiguous(),
                                       m[a:b].contiguous(), bank,
                                       n_lags=lags)
            assert torch.equal(alone, k[a:b]), (a, b)


@pytest.mark.gpu
def test_cuda_power_fleet_matches_plain():
    dev = _cuda()
    args = tuple(_t(a).to(dev) for a in _fleet_rows(1))
    n0 = power_reconstruct_fleet_kernel.launches
    got = power_reconstruct_fleet_kernel(*args)
    want = reconstruct_power_fleet_ref(*args)
    torch.cuda.synchronize()
    assert power_reconstruct_fleet_kernel.launches == n0 + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert got[2][:, 0].sum().item() == 2


@pytest.mark.gpu
@pytest.mark.parametrize("wrap", [0.0, WRAP_26])
def test_cuda_power_scalar_wrap_matches_plain(wrap):
    dev = _cuda()
    e, t, _ = _counter_rows(2)
    if wrap:
        e = (e.astype("float64") % wrap).astype("float32")
    e, t = _t(e).to(dev), _t(t).to(dev)
    got = power_reconstruct_kernel(e, t, wrap_period=wrap)
    assert torch.equal(got, reconstruct_power_ref(e, t, wrap_period=wrap))


def _energy_close(got, want):
    err = (got.double() - want.double()).abs()
    assert (err <= 1e-5 * want.double().abs().clamp_min(1.0)).all(), \
        err.max().item()


@pytest.mark.gpu
def test_cuda_phase_integrate_matches_plain_and_ignores_row_count():
    dev = _cuda()
    t, w = (_t(a).to(dev) for a in _power_rows(2, f=40, s=3000))
    ph = _t(_phase_table(2, p=7, t_hi=3.0)).to(dev)
    got = phase_integrate_kernel(t, w, ph)
    _energy_close(got, phase_energies_ref(t, w, ph))
    # a row's energy is bit-identical however many rows go together
    assert torch.equal(phase_integrate_kernel(t[:8].contiguous(),
                                              w[:8].contiguous(), ph),
                       got[:8])
    # more than one 32-phase tile
    ph2 = torch.cat([ph, ph[:7]])
    _energy_close(phase_integrate_kernel(t, w, ph2),
                  phase_energies_ref(t, w, ph2))


@pytest.mark.gpu
def test_cuda_fleet_attribute_matches_plain_and_ignores_row_count():
    dev = _cuda()
    e, t, w = (_t(a).to(dev) for a in _counter_rows(3, f=40, s=2000))
    ph = _t(_phase_table(3, p=6, t_hi=2.0)).to(dev)
    got = fleet_attribute_kernel(t, e, w, ph)
    _energy_close(got, fleet_attribute_ref(t, e, w, ph))
    assert torch.equal(fleet_attribute_kernel(t[:8].contiguous(),
                                              e[:8].contiguous(),
                                              w[:8].contiguous(), ph),
                       got[:8])


@pytest.mark.gpu
def test_cuda_grid_resample_unstaged_rows_match_plain():
    """Rows of 7000 samples (56 KB of times and values, past the 48 KB
    a block has without the opt-in): staged in dynamic shared memory."""
    dev = _cuda()
    t, v, n, first, grid, d = (_t(a).to(dev) for a in
                               _regrid_case(5, f=24, s=7000, g=9000))
    for mode in ("hold", "linear"):
        ko, km = grid_resample_kernel(t, v, n[:, 0].contiguous(),
                                      first[:, 0].contiguous(),
                                      grid[:, 0].contiguous(),
                                      d[:, 0].contiguous(), mode=mode)
        po, pm = grid_resample_ref(t, v, n, first, grid, d, mode=mode)
        torch.cuda.synchronize()
        assert torch.equal(km, pm) and km.any()
        if mode == "hold":
            assert torch.equal(ko, po)
        else:
            torch.testing.assert_close(ko, po, rtol=1e-5, atol=1e-5,
                                       equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", REGRID_EDGES)
def test_cuda_grid_resample_edges_match_plain(kind):
    """The warp-range search on each edge case of
    ``torch_cases._regrid_edge_case``: chunks straddling t[first] and
    t[n-1] with junk outside [first, n), queries outside both ends,
    duplicate timestamps, the -inf sentinel, S = 301/302/303, 20000-sample
    rows, and grids out of order (the per-chunk order test sends those
    chunks to the full search).  Hold values and masks identical to both
    plain searches (the halving loop and torch.searchsorted), linear
    within 1e-5."""
    dev = _cuda()
    t, v, n, first, grid, d = (_t(a).to(dev)
                               for a in _regrid_edge_case(kind))
    n0 = grid_resample_kernel.launches
    for mode in ("hold", "linear"):
        ko, km = grid_resample_kernel(t, v, n[:, 0].contiguous(),
                                      first[:, 0].contiguous(),
                                      grid[:, 0].contiguous(),
                                      d[:, 0].contiguous(), mode=mode)
        for sorted_search in (False, True):
            po, pm = grid_resample_ref(t, v, n, first, grid, d, mode=mode,
                                       sorted_search=sorted_search)
            torch.cuda.synchronize()
            assert torch.equal(km, pm) and km.any() and not km.all()
            if mode == "hold":
                assert torch.equal(ko, po)
            else:
                torch.testing.assert_close(ko, po, rtol=1e-5, atol=1e-5,
                                           equal_nan=True)
    assert grid_resample_kernel.launches == n0 + 2


def _energies_match(got, want):
    """NaN and inf where the plain version has them, the rest within
    1e-5 x max(|E|, 1 J)."""
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    inf = torch.isinf(want)
    assert torch.equal(got[inf], want[inf])
    fin = torch.isfinite(want)
    _energy_close(got[fin], want[fin])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", PHASE_EDGES)
def test_cuda_phase_integrate_edges_match_plain(kind):
    """Each edge case of ``torch_cases._phase_edge_case``: non-finite
    watts and times (the dense branch: non-finite in every phase of
    their rows and only there), the -inf carry column, 32 overlapping
    unsorted windows, empty windows between real ones, P = 39."""
    dev = _cuda()
    t, w, ph = (_t(a).to(dev) for a in _phase_edge_case(kind))
    n0 = phase_integrate_kernel.launches
    got = phase_integrate_kernel(t, w, ph)
    want = phase_energies_ref(t, w, ph)
    torch.cuda.synchronize()
    assert phase_integrate_kernel.launches == n0 + 1
    _energies_match(got, want)
    bad = (~torch.isfinite(got).all(1)).nonzero().flatten().tolist()
    if kind == "nonfinite":
        assert bad == [2, 5, 9]
        assert not torch.isfinite(got[[2, 5, 9]]).any()
    else:
        assert bad == [] and (got > 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("r", [1, 8, 512])
def test_cuda_phase_integrate_rows_ignore_row_count(r):
    """At the batch path's width (4097 samples, 6 phases padded to 32) a
    row's energies are bit-identical whether R = 1, 8 or 512 rows are
    passed or 600."""
    dev = _cuda()
    t, w = (_t(a).to(dev) for a in _power_rows(4, f=600, s=4097))
    t_hi = t[torch.isfinite(t)].max().item()
    ph = _t(_phase_partition(t_hi).astype("float32")).to(dev)
    whole = phase_integrate_kernel(t, w, ph)
    _energies_match(whole, phase_energies_ref(t, w, ph))
    part = phase_integrate_kernel(t[:r].contiguous(), w[:r].contiguous(),
                                  ph)
    assert torch.equal(part, whole[:r])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", FA_EDGES)
def test_cuda_fleet_attribute_edges_match_plain(kind):
    """Each edge case of ``torch_cases._fa_edge_case``: NaN and inf reads
    (the NaN-propagating branch), the carry column of ``FleetStream``'s
    first update and a -inf one, wraps inside every slice, counters
    stepping back by less than half the wrap (negative power, so skipped
    terms are -0), duplicate runs, 32 overlapping unsorted windows, empty
    windows between real ones, P = 39."""
    dev = _cuda()
    t, e, w, ph = (_t(a).to(dev) for a in _fa_edge_case(kind))
    n0 = fleet_attribute_kernel.launches
    got = fleet_attribute_kernel(t, e, w, ph)
    want = fleet_attribute_ref(t, e, w, ph)
    torch.cuda.synchronize()
    assert fleet_attribute_kernel.launches == n0 + 1
    _energies_match(got, want)
    bad = (~torch.isfinite(got).all(1)).nonzero().flatten().tolist()
    if kind == "nonfinite":
        assert bad == [2, 5, 9]
    else:
        assert bad == [] and (got > 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 2, 3, 129, 130, 4097])
def test_cuda_fleet_attribute_short_and_long_rows(s):
    """Rows of one read (column 0's term alone), two, three, one interval
    past a warp's slice, and the 4097-column chunk (four slices a warp)."""
    dev = _cuda()
    e, t, w = (_t(a).to(dev) for a in _counter_rows(7, f=24, s=s))
    t_hi = t[torch.isfinite(t)].max().item()
    ph = _t(_phase_partition(max(t_hi, 1e-3)).astype("float32")).to(dev)
    ph[3] = float("nan")                 # a NaN edge: NaN in every row
    got = fleet_attribute_kernel(t, e, w, ph)
    _energies_match(got, fleet_attribute_ref(t, e, w, ph))
    assert torch.isnan(got[:, 3]).all()
    assert not torch.isnan(got[:, [0, 1, 2, 4, 5]]).any()


@pytest.mark.gpu
@pytest.mark.parametrize("r", [1, 8, 512])
def test_cuda_fleet_attribute_rows_ignore_row_count(r):
    """At the streaming chunk's width (1025 columns, 6 phases padded to
    32) a row's energies are bit-identical whether R = 1, 8 or 512 rows
    are passed or 600."""
    dev = _cuda()
    e, t, w = (_t(a).to(dev) for a in _counter_rows(8, f=600, s=1025))
    t_hi = t[torch.isfinite(t)].max().item()
    ph = _t(_phase_partition(t_hi).astype("float32")).to(dev)
    whole = fleet_attribute_kernel(t, e, w, ph)
    _energies_match(whole, fleet_attribute_ref(t, e, w, ph))
    part = fleet_attribute_kernel(t[:r].contiguous(), e[:r].contiguous(),
                                  w[:r].contiguous(), ph)
    assert torch.equal(part, whole[:r])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", PR_EDGES)
def test_cuda_power_fleet_edges_match_plain(kind):
    """Each edge case of ``torch_cases._pr_edge_case`` (rows with no read
    or one, n at every residue mod 4, reads out of order inside and past
    n, duplicate runs, wraps, S = 300 .. 303, S = 3 and 1): power, valid
    and reordered ``torch.equal`` to the plain version."""
    dev = _cuda()
    args = tuple(_t(a).to(dev) for a in _pr_edge_case(kind))
    n0 = power_reconstruct_fleet_kernel.launches
    got = power_reconstruct_fleet_kernel(*args)
    want = reconstruct_power_fleet_ref(*args)
    torch.cuda.synchronize()
    assert power_reconstruct_fleet_kernel.launches == n0 + 1
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and torch.equal(g, x)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_cuda_power_fleet_unaligned_views_match_plain(offset):
    """Inputs that start off a 16-byte boundary (contiguous views at an
    offset of 1-3 floats) take the scalar kernel: still equal."""
    dev = _cuda()
    e, t, w, n = (_t(a).to(dev) for a in _pr_edge_case("mod1"))
    f, s = e.shape
    views = []
    for x in (e, t):
        buf = torch.zeros(f * s + offset, dtype=x.dtype, device=dev)
        v = buf[offset:].view(f, s)
        v.copy_(x)
        assert v.is_contiguous() and v.data_ptr() % 16 != 0
        views.append(v)
    got = power_reconstruct_fleet_kernel(views[0], views[1], w, n)
    for g, x in zip(got, reconstruct_power_fleet_ref(e, t, w, n)):
        assert torch.equal(g, x)


@pytest.mark.gpu
def test_cuda_empty_launch_runs():
    """The empty kernel that times a launch's own cost launches at both
    of ``chip_smoke.py``'s grids and refuses a CPU device."""
    dev = _cuda()
    build.empty_launch(dev, 1, 32)
    build.empty_launch(dev, 512, 256)
    torch.cuda.synchronize()
    with pytest.raises(ValueError):
        build.empty_launch(torch.device("cpu"))


# rtol of the square-wave kernel (one rounding per step) against its plain
# version (two): K ulps relative; bf16 the reference's own bound
_SW_RTOL = {torch.float32: lambda k: k * 2.0 ** -23,
            torch.float64: lambda k: k * 2.0 ** -52,
            torch.bfloat16: lambda k: 2e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("fma_chain", [17, 80])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_cuda_squarewave_matches_plain(dtype, fma_chain):
    """Whole vectors plus a scalar tail (width 67 is no multiple of any
    vector width), and a misaligned view through the public op."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((256, 67), generator=gen, device=dev).to(dtype)
    n0 = squarewave_kernel.launches
    k = squarewave_kernel(x, fma_chain=fma_chain)
    p = squarewave_ref(x, fma_chain=fma_chain)
    torch.cuda.synchronize()
    assert squarewave_kernel.launches == n0 + 1
    assert k.dtype == dtype and k.shape == x.shape
    torch.testing.assert_close(k.double(), p.double(), atol=0.0,
                               rtol=_SW_RTOL[dtype](fma_chain))
    flat = torch.randn(4097, generator=gen, device=dev).to(dtype)
    view = flat[1:].view(64, 64)                  # not 16-byte aligned
    with pytest.raises(ValueError, match="aligned"):
        squarewave_kernel(view, fma_chain=fma_chain)
    torch.testing.assert_close(
        squarewave_load(view, fma_chain=fma_chain).double(),
        squarewave_ref(view, fma_chain=fma_chain).double(), atol=0.0,
        rtol=_SW_RTOL[dtype](fma_chain))


@pytest.mark.gpu
@pytest.mark.parametrize("fma_chain", [1, 17, 80])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_cuda_squarewave_rounds_once_per_step(dtype, fma_chain):
    """Bit for bit the plain one-rounding chain (``squarewave_fused_ref``):
    a float32 or float64 step moves a value by ~1.1e-6 relative, so a
    dropped or extra FMA fails here.  bfloat16 cannot show the chain
    (both versions return ``x``); there this checks the layout."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((256, 67), generator=gen, device=dev).to(dtype)
    got = squarewave_kernel(x, fma_chain=fma_chain)
    assert torch.equal(got, squarewave_fused_ref(x, fma_chain=fma_chain))


@pytest.mark.gpu
def test_cuda_squarewave_ignores_row_count():
    """A row's result does not depend on how many rows are launched."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((1024, 256), generator=gen, device=dev)
    whole = squarewave_kernel(x, fma_chain=80)
    part = squarewave_kernel(x[:256].contiguous(), fma_chain=80)
    torch.cuda.synchronize()
    assert torch.equal(whole[:256], part)


def _rel(got, want):
    """Largest difference relative to the plain output's largest
    magnitude (the gates of the serve path's kernels)."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("cap", [0.0, 50.0])
@pytest.mark.parametrize("d", [64, 128, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_matches_plain(dtype, d, cap, causal):
    """S = 200 (a masked tail tile), GQA 4/2: float32 within 1e-5 and
    bfloat16 within 8e-3 of the plain output's largest magnitude; heads
    of 16 and 32 run padded to 64 and 128 (``pad_heads``)."""
    dev = _cuda()
    q, k, v = (torch.from_numpy(a).to(dev, dtype)
               for a in _attention_case(0, s=200, d=d))
    n0 = flash_attention_kernel.launches
    got = flash_attention_kernel(q, k, v, causal=causal, logit_cap=cap)
    want = flash_attention_ref(q, k, v, causal=causal, logit_cap=cap)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == n0 + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert _rel(got, want) <= (1e-5 if dtype == torch.float32 else 8e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 63, 64, 65, 130])
def test_cuda_flash_attention_short_and_ragged_lengths(s):
    dev = _cuda()
    q, k, v = (torch.from_numpy(a).to(dev)
               for a in _attention_case(1, b=1, hq=6, hkv=2, s=s, d=128))
    got = flash_attention_kernel(q, k, v)
    assert _rel(got, flash_attention_ref(q, k, v)) <= 1e-5


@pytest.mark.gpu
def test_cuda_flash_attention_takes_strided_model_layout():
    """(B, S, H, D) activations transposed to (B, H, S, D) go in without
    a copy and come out in the same layout, equal to contiguous input."""
    dev = _cuda()
    q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16)
               for a in _attention_case(2, s=100, d=128))
    qt, kt, vt = (x.transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (q, k, v))
    got = flash_attention_kernel(qt, kt, vt)
    assert got.stride() == qt.stride()
    assert torch.equal(got, flash_attention_kernel(q, k, v))


@pytest.mark.gpu
@pytest.mark.parametrize("sk", [1, 63, 65, 1500])
@pytest.mark.parametrize("sq", [1, 17, 128, 200])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_kv_length_matches_plain(dtype, d, sq, sk):
    """Non-causal with a key length of its own (whisper's
    cross-attention: the prompt, or one position, against the encoder's
    frames): float32 within 1e-5, bfloat16 within 8e-3."""
    dev = _cuda()
    q = torch.from_numpy(_attention_case(5, b=2, hq=4, hkv=2, s=sq,
                                         d=d)[0]).to(dev, dtype)
    _, k, v = (torch.from_numpy(a).to(dev, dtype)
               for a in _attention_case(6, b=2, hq=4, hkv=2, s=sk, d=d))
    n0 = flash_attention_kernel.launches
    got = flash_attention_kernel(q, k, v, causal=False)
    want = flash_attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == n0 + 1
    assert got.shape == q.shape and got.dtype == dtype
    assert _rel(got, want) <= (1e-5 if dtype == torch.float32 else 8e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [0.0, 50.0])
@pytest.mark.parametrize("window", [1, 7, 64, 100, 129])
@pytest.mark.parametrize("s", [1, 65, 200, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_window_matches_plain(dtype, s, window, cap):
    """Causal with a sliding window (gemma2's local layers), windows
    inside a tile, on a tile edge and across tiles, so that whole key
    tiles left of the window are skipped: float32 within 1e-5, bfloat16
    within 8e-3."""
    dev = _cuda()
    q, k, v = (torch.from_numpy(a).to(dev, dtype)
               for a in _attention_case(7, b=1, hq=4, hkv=2, s=s, d=128))
    got = flash_attention_kernel(q, k, v, logit_cap=cap, window=window)
    want = flash_attention_ref(q, k, v, logit_cap=cap, window=window)
    torch.cuda.synchronize()
    assert _rel(got, want) <= (1e-5 if dtype == torch.float32 else 8e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_wide_window_is_no_window(dtype):
    """A window of at least S masks nothing: the same bits as the call
    without one."""
    dev = _cuda()
    q, k, v = (torch.from_numpy(a).to(dev, dtype)
               for a in _attention_case(8, b=1, hq=4, hkv=2, s=150, d=64))
    want = flash_attention_kernel(q, k, v, logit_cap=50.0)
    for w in (150, 151, 4096):
        assert torch.equal(flash_attention_kernel(q, k, v, logit_cap=50.0,
                                                  window=w), want)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [8, 16, 40])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.bfloat16)])
def test_cuda_selective_scan_matches_plain(dtypes, n):
    """D = 160, L = 96 (three 32-step tiles): y within 1e-5 (float32) or
    8e-3 (bfloat16) and h_last within 1e-5 of the plain output's largest
    magnitude."""
    dev = _cuda()
    dt, x, bm, cm, a, h0 = (torch.from_numpy(v).to(dev)
                            for v in _scan_case(0, n=n))
    dt, x = dt.to(dtypes[0]), x.to(dtypes[1])
    n0 = selective_scan_kernel.launches
    y, h = selective_scan_kernel(dt, x, bm, cm, a, h0)
    wy, wh = selective_scan_ref(dt, x, bm, cm, a, h0)
    torch.cuda.synchronize()
    assert selective_scan_kernel.launches == n0 + 1
    assert y.dtype == dtypes[1] and h.dtype == torch.float32
    assert _rel(y, wy) <= (1e-5 if dtypes[1] == torch.float32 else 8e-3)
    assert _rel(h, wh) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 3, 8])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 15, 16, 17, 63, 64, 65, 127, 128, 129,
                               1000])
def test_cuda_flash_attention_bf16_tensor_cores_edges(s, d, group, causal,
                                                      cap):
    """The bf16 path (mma.sync, P rounded to bf16) at every tile edge,
    both head widths, GQA groups 1/3/8, causal or not, with and without
    the cap: within 8e-3 of the plain output's largest magnitude."""
    dev = _cuda()
    q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16)
               for a in _attention_case(3, b=1, hq=2 * group, hkv=2, s=s,
                                        d=d))
    got = flash_attention_kernel(q, k, v, causal=causal, logit_cap=cap)
    want = flash_attention_ref(q, k, v, causal=causal, logit_cap=cap)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert _rel(got, want) <= 8e-3


@pytest.mark.gpu
def test_cuda_flash_attention_refuses_misaligned_bf16_views():
    """cp.async copies 16-byte rows: a bf16 view whose pointer or
    sequence stride is not 16-byte aligned is refused, not copied."""
    dev = _cuda()
    q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16)
               for a in _attention_case(4, b=1, hq=4, hkv=2, s=40, d=64))
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=dev)
    shifted = flat[1:].view(q.shape)               # pointer 2 bytes off
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_kernel(shifted, k, v)
    wide = torch.zeros((1, 40, 4 * 64 + 4), dtype=torch.bfloat16,
                       device=dev)                 # sequence stride 260
    wide[..., :4 * 64] = q.transpose(1, 2).reshape(1, 40, 4 * 64)
    strided = wide[..., :4 * 64].view(1, 40, 4, 64).transpose(1, 2)
    assert strided.stride(2) == 260
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_kernel(strided, k, v)
    # the same values, aligned, run
    torch.testing.assert_close(flash_attention_kernel(q, k, v),
                               flash_attention_kernel(q.clone(), k, v))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 37, 75), (1, 70, 33), (3, 5, 160)])
@pytest.mark.parametrize("n", [1, 8, 16, 40, 64])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.bfloat16)])
def test_cuda_selective_scan_lane_split_edges(dtypes, n, shape):
    """Four lanes a channel, N from 1 to 64 (states past N padded), D
    not a multiple of the block's 32 channels, L not a multiple of the
    tile: h_last bit-identical to the plain stepped recurrence (each
    lane steps its states in the plain version's order), y within 1e-5
    (float32 x) or 8e-3 (bfloat16 x)."""
    dev = _cuda()
    b, seq, d = shape
    dt, x, bm, cm, a, h0 = (torch.from_numpy(v).to(dev)
                            for v in _scan_case(2, b=b, seq=seq, d=d, n=n))
    dt, x = dt.to(dtypes[0]), x.to(dtypes[1])
    y, h = selective_scan_kernel(dt, x, bm, cm, a, h0)
    wy, wh = selective_scan_ref(dt, x, bm, cm, a, h0)
    torch.cuda.synchronize()
    assert torch.equal(h, wh)
    assert _rel(y, wy) <= (1e-5 if dtypes[1] == torch.float32 else 8e-3)


@pytest.mark.gpu
def test_cuda_selective_scan_refuses_large_state():
    dev = _cuda()
    dt, x, bm, cm, a, h0 = (torch.from_numpy(v).to(dev)
                            for v in _scan_case(1, seq=4, d=32, n=65))
    with pytest.raises(ValueError, match="d_state 65"):
        selective_scan_kernel(dt, x, bm, cm, a, h0)


# B10's backward against autograd through the plain version at phase 11's
# bounds: float32 gradients within 1e-5 of each one's largest magnitude;
# a gradient returned in bfloat16 (dx for a bf16 x, ddt for a bf16 dt)
# within two bf16 ulps of its largest (2 x 2**-8: each side rounds once)
SCAN_BWD_TOL = 1e-5
SCAN_BWD_BF16_TOL = 7.8125e-3


def _scan_grads(fn, args, dy, dh):
    """(y, h_last) of ``fn`` on fresh leaves of ``args`` and the six
    gradients of (y, h_last) against (dy, dh; dh may be None)."""
    ins = [t.detach().clone().requires_grad_() for t in args]
    y, h = fn(*ins)
    outs, cots = (y, h), (dy, dh)
    if dh is None:
        outs, cots = (y,), (dy,)
    return torch.autograd.grad(outs, ins, cots)


@pytest.mark.gpu
@pytest.mark.parametrize("with_dh", [True, False], ids=["dh", "no_dh"])
@pytest.mark.parametrize("seq", [1, 31, 32, 67])
@pytest.mark.parametrize("n", [1, 16, 40, 64])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.bfloat16)])
def test_cuda_selective_scan_backward_matches_plain(dtypes, n, seq,
                                                    with_dh):
    """``ops.selective_scan`` on CUDA leaves that require a gradient goes
    through ``SelectiveScan``: one forward launch (with checkpoints) and
    one backward launch; D = 75 (not a multiple of a block's channels),
    L at the 32-step chunk's edges, N from 1 to 64.  The six gradients
    against autograd through the plain version on the same CUDA tensors
    (float32 1e-5, bfloat16 outputs SCAN_BWD_BF16_TOL of the largest),
    and a second backward ``torch.equal`` to the first."""
    dev = _cuda()
    args = [torch.from_numpy(v).to(dev)
            for v in _scan_case(7, b=2, seq=seq, d=75, n=n)]
    args[0], args[1] = args[0].to(dtypes[0]), args[1].to(dtypes[1])
    gen = torch.Generator(device=dev).manual_seed(seq * 100 + n)
    dy = torch.randn(args[1].shape, generator=gen,
                     device=dev).to(dtypes[1])
    dh = (torch.randn(args[5].shape, generator=gen, device=dev)
          if with_dh else None)
    n0 = selective_scan_kernel.launches
    b0 = selective_scan_bwd_kernel.launches
    got = _scan_grads(selective_scan, args, dy, dh)
    torch.cuda.synchronize()
    assert selective_scan_kernel.launches == n0 + 1
    assert selective_scan_bwd_kernel.launches == b0 + 1
    again = _scan_grads(selective_scan, args, dy, dh)
    want = _scan_grads(selective_scan_ref, args, dy, dh)
    torch.cuda.synchronize()
    for name, g, r, w in zip(("ddt", "dx", "dB", "dC", "dA", "dh0"), got,
                             again, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        assert torch.equal(g, r), name
        tol = (SCAN_BWD_TOL if g.dtype == torch.float32
               else SCAN_BWD_BF16_TOL)
        assert _rel(g, w) <= tol, (name, _rel(g, w))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 16, 17, 33, 64])
@pytest.mark.parametrize("d", [75, 200])
@pytest.mark.parametrize("seq", [1, 31, 33, 1000])
def test_cuda_selective_scan_backward_edges(seq, d, n):
    """B10's backward at its edges: L of one step, one short of a chunk,
    one past it and many chunks; D not a multiple of a block's channels
    (75: odd, staged element by element; 200: even, staged by 16-byte
    pieces); N of 1, 16 and just past 16 and 32 (8, 16 and 32 lanes a
    channel) and 64; dt float32 with x bf16 (as trained), with dh_last
    and h0.  The six gradients against autograd through the plain
    version (float32 1e-5, bf16 SCAN_BWD_BF16_TOL of the largest), two
    runs torch.equal."""
    dev = _cuda()
    args = [torch.from_numpy(v).to(dev)
            for v in _scan_case(9, b=2, seq=seq, d=d, n=n)]
    args[1] = args[1].to(torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(seq + 1000 * n + d)
    dy = torch.randn(args[1].shape, generator=gen,
                     device=dev).to(torch.bfloat16)
    dh = torch.randn(args[5].shape, generator=gen, device=dev)
    got = _scan_grads(selective_scan, args, dy, dh)
    again = _scan_grads(selective_scan, args, dy, dh)
    want = _scan_grads(selective_scan_ref, args, dy, dh)
    torch.cuda.synchronize()
    for name, g, r, w in zip(("ddt", "dx", "dB", "dC", "dA", "dh0"), got,
                             again, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, r), name
        tol = (SCAN_BWD_TOL if g.dtype == torch.float32
               else SCAN_BWD_BF16_TOL)
        assert _rel(g, w) <= tol, (name, _rel(g, w))


@pytest.mark.gpu
def test_cuda_selective_scan_backward_fits_four_blocks_an_sm():
    """At N = 16 with x in bf16 (the hybrid's training step) the backward
    kernel fits four blocks (16 warps) on an SM, its shared memory
    included."""
    from repro_torch.kernels.ssm_scan.kernel import bwd_blocks_per_sm
    _cuda()
    assert bwd_blocks_per_sm(torch.float32, torch.bfloat16, 16) >= 4


@pytest.mark.gpu
def test_cuda_selective_scan_backward_at_the_hybrid_width():
    """The training step's shape, cut to 2 x 256 tokens: (2, 256, 16384,
    16), dt float32 and x bfloat16, as the hybrid's Mamba layers call it;
    the same bounds, and two runs ``torch.equal``."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    b, seq, d, n = 2, 256, 16384, 16
    args = [torch.nn.functional.softplus(randn(b, seq, d) - 1.0),
            randn(b, seq, d).to(torch.bfloat16), randn(b, seq, n),
            randn(b, seq, n), -torch.exp(0.5 * randn(d, n)),
            torch.zeros((b, d, n), device=dev)]
    dy = randn(b, seq, d).to(torch.bfloat16)
    got = _scan_grads(selective_scan, args, dy, None)
    again = _scan_grads(selective_scan, args, dy, None)
    want = _scan_grads(selective_scan_ref, args, dy, None)
    torch.cuda.synchronize()
    for name, g, r, w in zip(("ddt", "dx", "dB", "dC", "dA", "dh0"), got,
                             again, want):
        assert torch.equal(g, r), name
        tol = (SCAN_BWD_TOL if g.dtype == torch.float32
               else SCAN_BWD_BF16_TOL)
        assert _rel(g, w) <= tol, (name, _rel(g, w))


def _hybrid_smoke(head_dim=64):
    """The reduced Jamba hybrid with MoE dropped and B9's head width."""
    import dataclasses
    from repro_torch.configs import get_arch, reduced
    return dataclasses.replace(reduced(get_arch("jamba-1.5-large-398b")),
                               moe=None, head_dim=head_dim,
                               compute_dtype="float32")


@pytest.mark.gpu
def test_cuda_model_prefill_runs_the_kernels_and_matches_cpu():
    """A reduced hybrid's prefill on the card launches B9 once per
    attention layer and B10 once per Mamba layer, and its logits and
    cache match the same weights on the CPU (float32; the card's and the
    CPU's matrix products sum in other orders)."""
    from repro_torch.models import Model
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _hybrid_smoke()
    model = Model(cfg)
    cpu_p = model.init(3, device="cpu")

    def to(tree, d):
        return ({k: to(v, d) for k, v in tree.items()}
                if isinstance(tree, dict) else tree.to(d))
    card_p = to(cpu_p, dev)
    toks = torch.randint(0, cfg.vocab_size, (1, 70),
                         generator=torch.Generator().manual_seed(0))
    f0, s0 = flash_attention_kernel.launches, selective_scan_kernel.launches
    lg, cache = model.prefill(card_p, {"tokens": toks.to(dev)},
                              model.init_cache(1, 96))
    torch.cuda.synchronize()
    n_attn = sum(k == "attn" for k in cfg.blocks)
    assert flash_attention_kernel.launches - f0 == n_attn
    assert selective_scan_kernel.launches - s0 == cfg.num_layers - n_attn
    want, wcache = model.prefill(cpu_p, {"tokens": toks},
                                 model.init_cache(1, 96, device="cpu"))
    assert _rel(lg.cpu(), want) <= 1e-4
    ssm = cache["pos1"]["ssm"].cpu()
    assert _rel(ssm, wcache["pos1"]["ssm"]) <= 1e-4


@pytest.mark.gpu
def test_cuda_attention_refuses_what_has_no_kernel():
    """On the card, a kv mask and a query offset raise instead of falling
    back to the plain form; sliding-window attention (gemma2's local
    layers) and a key length of its own (whisper's cross-attention) have
    the kernel now and launch it."""
    from repro_torch.models.layers import attention
    dev = _cuda()
    q = torch.zeros((1, 8, 4, 64), device=dev)
    with pytest.raises(NotImplementedError, match="kv_len_mask"):
        attention(q, q, q, kv_len_mask=torch.ones((1, 8), dtype=torch.bool,
                                                  device=dev))
    with pytest.raises(NotImplementedError, match="q_offset"):
        attention(q, q, q, q_offset=3)
    n0 = flash_attention_kernel.launches
    attention(q, q, q, window=4)
    attention(q[:, :1], q, q, causal=False)
    assert flash_attention_kernel.launches == n0 + 2


def _health_groups(n_devices, faults, span_s=2.5):
    """The repo's test recipe on the port's own simulator (no JAX): per
    device a wrapping counter and a noisy power sensor, with faults
    injected by name."""
    from repro_torch.core import (FaultSpec, SensorSpec, ToolSpec,
                                  inject_fault, simulate_sensor,
                                  square_wave)
    truth = square_wave(span_s / 4.0, 3, lead_s=span_s / 8,
                        tail_s=span_s / 8)
    groups, delays = [], []
    for d in range(n_devices):
        specs = [SensorSpec(name=f"d{d}_energy", scope="chip",
                            kind="energy_cum", quantum=1e-6, wrap_bits=26,
                            delay_s=0.004 * (d % 5)),
                 SensorSpec(name=f"d{d}_power", scope="chip",
                            kind="power_inst", noise_w=3.0, quantum=1e-6,
                            delay_s=0.011 + 0.003 * (d % 3))]
        trs = [simulate_sensor(sp, ToolSpec(0.9e-3), truth,
                               seed=31 * d + i) for i, sp in enumerate(specs)]
        groups.append([inject_fault(tr, FaultSpec(**faults[tr.name]))
                       if tr.name in faults else tr for tr in trs])
        delays += [sp.delay_s for sp in specs]
    return truth, groups, delays


@pytest.mark.gpu
@pytest.mark.parametrize("faults", [
    {}, {"d1_power": dict(kind="stuck", t_start=1.0)},
    {"d2_power": dict(kind="step_drift", t_start=0.7, t_end=1.6,
                      magnitude_w=40.0)}],
    ids=["healthy", "stuck", "recovery"])
def test_cuda_health_matches_cpu(faults):
    """The health stage on the card (statistics block on the device)
    against the CPU plain versions: the same state sequences and events,
    energies within 1e-5; all-healthy totals equal the plain chain's."""
    import numpy as np
    from repro_torch.fleet import (PipelineConfig, StreamConfig,
                                   TrackConfig,
                                   attribute_energy_fused_streaming)
    from repro_torch.health import HealthConfig
    dev = _cuda()
    truth, groups, delays = _health_groups(3, faults)
    edges = np.linspace(truth.t0 + 0.05, truth.t1 - 0.05, 7)
    phases = [(f"p{k}", float(a), float(b))
              for k, (a, b) in enumerate(zip(edges[:-1], edges[1:]))]
    hcfg = HealthConfig(suspect_after=1, quarantine_after=1,
                        recover_after=1, rms_limit_w=60.0)
    cfg = PipelineConfig(stream=StreamConfig(chunk=257),
                         track=TrackConfig(track=False, delays=delays),
                         health=hcfg)
    res = {}
    for d in (dev, "cpu"):
        out, pipe = attribute_energy_fused_streaming(
            groups, phases, config=cfg, return_pipe=True, device=d)
        e = np.array([[p.energy_j for p in row] for row in out])
        res[str(d)] = (e, pipe.health_stage)
    (e, hs), (ec, hc) = res[str(dev)], res["cpu"]
    ev = [(x.kind, x.window, x.name, x.state_from, x.state_to, x.flags)
          for x in hs.events]
    assert ev == [(x.kind, x.window, x.name, x.state_from, x.state_to,
                   x.flags) for x in hc.events]
    assert (hs.state == hc.state).all() and hs.windows == hc.windows
    assert bool(faults) == bool(ev)
    assert (np.abs(e - ec) <= 1e-5 * np.maximum(np.abs(ec), 1.0)).all()
    if not faults:
        plain = attribute_energy_fused_streaming(
            groups, phases, config=PipelineConfig(
                stream=cfg.stream, track=cfg.track), device=dev)
        assert (e == np.array([[p.energy_j for p in row]
                               for row in plain])).all()


@pytest.mark.gpu
def test_cuda_metering_conserves_and_ignores_slot_order():
    """Per-request energies on the card: bit-identical under a
    permutation of the slot schedule, summing to the segment totals
    (1e-12) and within 1e-5 of the CPU plain versions'."""
    import numpy as np
    from repro_torch.align import group_traces_by_device
    from repro_torch.core import NodeFabric, ToolSpec, square_wave
    from repro_torch.fleet import (PipelineConfig, SlotSegment,
                                   TrackConfig,
                                   attribute_energy_fused_streaming)
    dev = _cuda()
    truth = square_wave(1.0, 2, lead_s=0.5, tail_s=0.5)
    traces = NodeFabric(chip_truths=[truth] * 2).sample_all(ToolSpec(),
                                                            seed=0)
    groups = list(group_traces_by_device(traces).values())
    phases = [("work", 0.5, 1.2), ("work", 1.2, 2.0)]
    segs_a = [SlotSegment(0.5, 1.2, (0, 1, 2), (3.0, 1.0, 2.0)),
              SlotSegment(1.2, 2.0, (1, 2), (2.0, 5.0))]
    segs_b = [SlotSegment(1.2, 2.0, (2, 1), (5.0, 2.0)),
              SlotSegment(0.5, 1.2, (2, 0, 1), (2.0, 3.0, 1.0))]
    cfg = PipelineConfig(track=TrackConfig(track=False))
    got = {}
    for key, segs, d in (("a", segs_a, dev), ("b", segs_b, dev),
                         ("cpu", segs_a, "cpu")):
        _, pipe = attribute_energy_fused_streaming(
            groups, phases, config=cfg, meter=segs, return_pipe=True,
            device=d)
        got[key] = (pipe.request_energies(),
                    pipe.meter_stage.segment_totals())
    (a, seg), (b, _), (c, _) = got["a"], got["b"], got["cpu"]
    assert sorted(a) == sorted(b) == sorted(c) == [0, 1, 2]
    for rid in a:
        assert np.array_equal(a[rid], b[rid]), rid
        np.testing.assert_allclose(a[rid], c[rid], rtol=1e-5)
    np.testing.assert_allclose(np.sum([a[r] for r in a], axis=0),
                               seg.sum(axis=1), rtol=1e-12)


class _Kill(Exception):
    pass


@pytest.mark.gpu
@pytest.mark.parametrize("health", [False, True], ids=["plain", "health"])
def test_cuda_checkpoint_kill_resume_bit_identical(tmp_path, health):
    """A tracked run on the card killed at window 7 (a checkpoint every
    3 windows) and resumed: totals ``torch.equal`` to the uninterrupted
    run's; and the card's checkpoint finishes on the CPU within 1e-5."""
    import numpy as np
    from repro_torch.fleet import (CheckpointConfig, PipelineConfig,
                                   StreamConfig, TrackConfig,
                                   attribute_energy_fused_streaming)
    dev = _cuda()
    truth, groups, _ = _health_groups(3, {})
    track = TrackConfig(window=512, hop=128)

    def run(device, on_window=None, **ck):
        cfg = PipelineConfig(stream=StreamConfig(chunk=257), track=track,
                             checkpoint=CheckpointConfig(**ck),
                             health=health or None)
        _, pipe = attribute_energy_fused_streaming(
            groups, [("a", 0.1, 1.2), ("b", 1.2, 2.4)], config=cfg,
            reference=truth, on_window=on_window, return_pipe=True,
            device=device)
        return pipe.totals()

    def kill(pipe, w):
        if w == 7:
            raise _Kill

    base = run(dev)
    with pytest.raises(_Kill):
        run(dev, kill, dir=str(tmp_path), every=3)
    resumed = run(dev, dir=str(tmp_path), resume=True)
    assert resumed.device.type == "cuda"
    assert torch.equal(resumed, base)
    on_cpu = run("cpu", dir=str(tmp_path), resume=True).numpy()
    want = base.cpu().numpy()
    assert np.abs(on_cpu - want).max() <= 1e-5 * max(np.abs(want).max(), 1)


@pytest.mark.gpu
def test_cuda_attribute_live_pump_drives_the_card():
    """A 1 s live capture on the card over a SimBackend: the pump thread
    hands its blocks to the card's pipeline, no poll goes unavailable,
    and the recorded blocks replayed through a fresh card pipeline give
    ``torch.equal`` totals."""
    import numpy as np
    import repro_torch.ingest.live as live
    from repro_torch.core import SensorSpec, SensorTrace
    from repro_torch.fleet.pipeline import StreamingFusedPipeline
    from repro_torch.ingest import AsyncFleetIngest, SimBackend
    dev = _cuda()
    blocks = []

    class Recording(AsyncFleetIngest):
        def __init__(self, readers, stream, *a, **k):
            class Rec:
                def update(self, *args):
                    blocks.append([np.array(x) for x in args])
                    return stream.update(*args)
            super().__init__(readers, Rec(), *a, **k)

    traces = {}
    t = np.arange(0.0, 1.5, 0.002)
    for d, p_w in enumerate((20.0, 35.0)):
        traces[f"d{d}.energy"] = SensorTrace(
            f"d{d}.energy", SensorSpec(name=f"d{d}.energy", scope="chip",
                                       kind="energy_cum", quantum=1e-6),
            t, t.copy(), p_w * t)
        traces[f"d{d}.power"] = SensorTrace(
            f"d{d}.power", SensorSpec(name=f"d{d}.power", scope="chip",
                                      kind="power_inst"),
            t, t.copy(), np.full_like(t, p_w))
    orig = live.AsyncFleetIngest
    live.AsyncFleetIngest = Recording
    try:
        res = live.attribute_live(
            [("a", 0.1, 0.5), ("b", 0.5, 0.9)], duration_s=1.0,
            backends=[SimBackend(traces, speed=1.0)],
            metrics=sorted(traces), chunk=16, interval_s=2e-3,
            reference=lambda x: np.ones_like(x), window=128, hop=64,
            max_lag=8, tail=64, settle_s=2.0)
    finally:
        live.AsyncFleetIngest = orig
    pipe = res.pipe
    assert pipe.device.type == "cuda" and pipe.align is not None
    assert sum(r.n_unavailable for r in res.readers) == 0
    assert res.pump.n_chunks == len(blocks) >= 3
    replay = StreamingFusedPipeline(
        pipe.group_sizes, [(0.1, 0.5), (0.5, 0.9)], grid_origin=0.0,
        grid_step=2e-3, kind_row=[True, False, True, False],
        wrap_period=[0.0] * 4, reference=lambda x: np.ones_like(x),
        window=128, hop=64, max_lag=8, tail=64,
        health_names=list(res.metrics), device=dev)
    for blk in blocks:
        replay.update(*blk)
    replay.finalize()
    assert torch.equal(replay.totals(), pipe.totals())
    for name in ("a", "b"):
        for d, p_w in enumerate((20.0, 35.0)):
            assert abs(res.energies()[name][f"d{d}"] - 0.4 * p_w) \
                <= 0.05 * 0.4 * p_w


def _fused_scan_case(tracked, n_devices=4):
    import numpy as np
    from repro_torch.fleet import PipelineConfig, StreamConfig, TrackConfig
    truth, groups, delays = _health_groups(n_devices, {})
    edges = np.linspace(truth.t0 + 0.05, truth.t1 - 0.05, 7)
    phases = [(f"p{k}", float(a), float(b))
              for k, (a, b) in enumerate(zip(edges[:-1], edges[1:]))]
    track = (TrackConfig(track=True, window=512, hop=128) if tracked
             else TrackConfig(track=False, delays=delays))
    cfg = PipelineConfig(stream=StreamConfig(engine="scan", chunk=256),
                         track=track)
    return truth, groups, phases, cfg


@pytest.mark.gpu
@pytest.mark.parametrize("tracked", [False, True],
                         ids=["untracked", "tracked"])
def test_cuda_scan_matches_cpu(tracked):
    """The scan engine on the card (B1, B4 and B5 launched) against the
    scan on the CPU's plain versions: per-phase energies within 1e-5."""
    import numpy as np
    from repro_torch.fleet import attribute_energy_fused_streaming
    dev = _cuda()
    truth, groups, phases, cfg = _fused_scan_case(tracked)
    before = (power_reconstruct_rows_kernel.launches,
              grid_resample_kernel.launches, xcorr_align_kernel.launches)
    res = {}
    for d in (dev, "cpu"):
        out = attribute_energy_fused_streaming(groups, phases, config=cfg,
                                               reference=truth, device=d)
        res[str(d)] = np.array([[p.energy_j for p in row] for row in out])
    after = (power_reconstruct_rows_kernel.launches,
             grid_resample_kernel.launches, xcorr_align_kernel.launches)
    ran = [b > a for a, b in zip(before, after)]
    assert ran == [True, tracked, tracked]
    e, ec = res[str(dev)], res["cpu"]
    assert (np.abs(e - ec) <= 1e-5 * np.maximum(np.abs(ec), 1.0)).all()


@pytest.mark.gpu
def test_cuda_scan_repeats_bit_identical():
    """Two runs of the scan on the card give equal totals (no float
    atomics in the step loop)."""
    from repro_torch.fleet import attribute_energy_fused_streaming
    dev = _cuda()
    truth, groups, phases, cfg = _fused_scan_case(True)
    runs = [torch.tensor([[p.energy_j for p in row] for row in
                          attribute_energy_fused_streaming(
                              groups, phases, config=cfg, reference=truth,
                              device=dev)], dtype=torch.float64)
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


@pytest.mark.gpu
def test_cuda_scan_eight_sensor_groups_stay_small():
    """k_max = 8 (256 coverage patterns a device) on 64 devices: the scan
    within 1e-5 of the windowed engine on the card, its peak memory below
    the (D, 2^K, K, B) float64 block an unrolled pattern einsum would
    build (printed)."""
    import numpy as np
    from repro_torch.core import (SensorSpec, ToolSpec, simulate_sensor,
                                  square_wave)
    from repro_torch.fleet import (PipelineConfig, StreamConfig,
                                   TrackConfig,
                                   attribute_energy_fused_streaming)
    dev = _cuda()
    n_dev, k, block = 64, 8, 512
    truth = square_wave(2.0 / 4.0, 3, lead_s=0.25, tail_s=0.25)
    groups, delays = [], []
    for d in range(n_dev):
        grp = []
        for j in range(k):
            kind = "energy_cum" if j % 2 == 0 else "power_inst"
            sp = SensorSpec(name=f"d{d}_{j}", scope="chip", kind=kind,
                            quantum=1e-6,
                            wrap_bits=26 if kind == "energy_cum" else 0,
                            noise_w=0.0 if kind == "energy_cum" else 3.0,
                            delay_s=0.002 * ((d * k + j) % 7))
            grp.append(simulate_sensor(sp, ToolSpec(0.9e-3), truth,
                                       seed=100 + 17 * (d * k + j)))
            delays.append(sp.delay_s)
        groups.append(grp)
    phases = [("a", truth.t0 + 0.3, truth.t0 + 1.1),
              ("b", truth.t0 + 1.1, truth.t1 - 0.3)]
    track = TrackConfig(track=False, delays=delays)
    out = {}
    for engine in ("windowed", "scan"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        rows = attribute_energy_fused_streaming(
            groups, phases, config=PipelineConfig(
                stream=StreamConfig(engine=engine), track=track),
            device=dev)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        out[engine] = np.array([[p.energy_j for p in r] for r in rows])
    unrolled = n_dev * (1 << k) * k * block * 8
    print(f"k_max=8, {n_dev} devices: scan peak {peak / 2**20:.1f} MiB; "
          f"a (D, 2^K, K, B) float64 block {unrolled / 2**20:.1f} MiB")
    assert peak < unrolled
    e, ew = out["scan"], out["windowed"]
    assert (np.abs(e - ew) <= 1e-5 * np.maximum(np.abs(ew), 1.0)).all()


# ------------------------------------------------- B9's backward kernel

def _grads(fn, q, k, v, do):
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = fn(qg, kg, vg)
    return out, torch.autograd.grad(out, (qg, kg, vg), do)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    # (B, Hq, Hkv, Sq, Sk, causal, window, cap)
    (1, 4, 2, 200, 200, True, 0, 0.0),
    (2, 6, 2, 65, 65, True, 0, 50.0),
    (1, 4, 4, 1, 1, True, 0, 0.0),
    (1, 4, 2, 17, 1500, False, 0, 0.0),
    (2, 2, 2, 130, 63, False, 0, 30.0),
    (1, 4, 2, 300, 300, True, 100, 50.0),
    (1, 8, 2, 129, 129, True, 7, 0.0)])
@pytest.mark.parametrize("d", [64, 128, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_backward_matches_plain_gradient(dtype, d,
                                                              case):
    """``FlashAttention`` (the forward with its lse, then the backward
    kernel) against autograd through the plain version: dq/dk/dv within
    1e-5 (float32) or 4 x 2**-8 (bfloat16, chip_smoke.BF16_BWD_TOL) of
    each gradient's largest magnitude, at tile edges, GQA groups 1-4,
    causal, windowed, non-causal with a key length of its own, with and
    without the cap; a second backward gives the same bits, and each
    call counts one launch of each kernel."""
    from repro_torch.kernels.flash_attention import (
        FlashAttention, flash_attention_bwd_kernel)
    dev = _cuda()
    b, hq, hkv, sq, sk, causal, window, cap = case
    q = torch.from_numpy(_attention_case(20, b=b, hq=hq, hkv=hkv, s=sq,
                                         d=d)[0]).to(dev, dtype)
    _, k, v = (torch.from_numpy(a).to(dev, dtype)
               for a in _attention_case(21, b=b, hq=hq, hkv=hkv, s=sk,
                                        d=d))
    do = torch.randn(q.shape, generator=torch.Generator(device=dev)
                     .manual_seed(3), device=dev).to(dtype)
    n0 = (flash_attention_kernel.launches,
          flash_attention_bwd_kernel.launches)
    got_out, got = _grads(lambda a, b_, c: FlashAttention.apply(
        a, b_, c, causal, cap, window), q, k, v, do)
    assert (flash_attention_kernel.launches,
            flash_attention_bwd_kernel.launches) == (n0[0] + 1, n0[1] + 1)
    _, again = _grads(lambda a, b_, c: FlashAttention.apply(
        a, b_, c, causal, cap, window), q, k, v, do)
    want_out, want = _grads(lambda a, b_, c: flash_attention_ref(
        a, b_, c, causal=causal, logit_cap=cap, window=window), q, k, v, do)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 4 * 2.0 ** -8
    assert _rel(got_out, want_out) <= (1e-5 if dtype == torch.float32
                                       else 8e-3)
    # a single key makes dq and dk identically zero (dP = delta): there
    # the kernel's rounding of dP - delta is held to the largest plain
    # gradient instead
    top = max(w.float().abs().max().item() for w in want)
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g, a)
        scale = w.float().abs().max().item() or top
        assert (g.float() - w.float()).abs().max().item() <= tol * scale


def _bwd_check(q, k, v, causal, window, cap):
    """FlashAttention's gradient (bf16) against autograd through the plain
    version on the same tensors, BF16_BWD_TOL (4 x 2**-8) of each
    gradient's largest magnitude; where one query or one key makes dq a
    sum that cancels (one key: dq = dk = 0; one query: sum_k dS_k = 0)
    it is held to the largest of the three gradients.  A second backward
    gives the same bits; one launch of each kernel a call."""
    from repro_torch.kernels.flash_attention import (
        FlashAttention, flash_attention_bwd_kernel)
    dev = q.device
    do = torch.randn(q.shape, generator=torch.Generator(device=dev)
                     .manual_seed(q.shape[2] + 7 * k.shape[2]),
                     device=dev).to(q.dtype)
    n0 = flash_attention_bwd_kernel.launches
    _, got = _grads(lambda a, b_, c: FlashAttention.apply(
        a, b_, c, causal, cap, window), q, k, v, do)
    assert flash_attention_bwd_kernel.launches == n0 + 1
    _, again = _grads(lambda a, b_, c: FlashAttention.apply(
        a, b_, c, causal, cap, window), q, k, v, do)
    _, want = _grads(lambda a, b_, c: flash_attention_ref(
        a, b_, c, causal=causal, logit_cap=cap, window=window), q, k, v, do)
    torch.cuda.synchronize()
    top = max(w.float().abs().max().item() for w in want)
    degenerate = 1 in (q.shape[2], k.shape[2])
    for g, a, w in zip(got, again, want):
        assert g.dtype == q.dtype and g.shape == w.shape
        assert torch.isfinite(g).all()
        assert torch.equal(g, a)
        scale = top if degenerate else w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= \
            4 * 2.0 ** -8 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sk", [63, 1500, 4097])
@pytest.mark.parametrize("sq", [1, 17, 128])
def test_cuda_flash_attention_backward_key_split(sq, sk, d):
    """bf16, non-causal, GQA 6/2: 63 keys take one dQ part, 1500 three and
    4097 nine (kernel.dq_key_parts; the parts' float32 partials folded in
    order), against the plain gradient, at query counts of 1, 17 (not a
    multiple of a 64-row tile) and 128 (one block of two warpgroups)."""
    from repro_torch.kernels.flash_attention.kernel import (
        dq_key_parts, flash_attention_bwd_kernel)
    dev = _cuda()
    parts = {63: 1, 1500: 3, 4097: 9}[sk]
    assert len(dq_key_parts(sk, False)) == parts
    q = torch.from_numpy(_attention_case(25, b=1, hq=6, hkv=2, s=sq,
                                         d=d)[0]).to(dev, torch.bfloat16)
    _, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16)
               for a in _attention_case(26, b=1, hq=6, hkv=2, s=sk, d=d))
    _bwd_check(q, k, v, False, 0, 0.0)
    assert flash_attention_bwd_kernel.dq_parts == parts


@pytest.mark.gpu
def test_cuda_flash_attention_backward_on_a_fresh_thread():
    """The bf16 backward makes its TMA tensor maps through libcuda's
    encoder, which needs the card's context current on the calling thread;
    autograd runs a backward on a thread of its own. A thread that has
    made no CUDA call yet gets the same gradients as the main thread."""
    import threading
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_kernel)
    from repro_torch.kernels.flash_attention.kernel import _forward
    dev = _cuda()
    q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16)
               for a in _attention_case(28, b=1, hq=4, hkv=2, s=130, d=128))
    do = torch.randn(q.shape, generator=torch.Generator(device=dev)
                     .manual_seed(4), device=dev).to(torch.bfloat16)
    out, lse = _forward(q, k, v, True, 0.0, 0, True)
    want = flash_attention_bwd_kernel(q, k, v, out, do, lse)
    got = []
    worker = threading.Thread(target=lambda: got.append(
        flash_attention_bwd_kernel(q, k, v, out, do, lse)))
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive()
    torch.cuda.synchronize()
    assert len(got) == 1
    for g, w in zip(got[0], want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("window", [0, 77])
@pytest.mark.parametrize("group", [1, 3, 8])
def test_cuda_flash_attention_backward_groups_and_window(group, window, d):
    """bf16, causal, S = 333 (neither a multiple of 64 nor of 128), GQA
    groups of 1, 3 and 8 query heads a kv head (dK/dV's sum over the
    group is the block's loop), with and without a window of 77 (its edge
    falls inside a 64-key tile), cap 30 where windowed."""
    dev = _cuda()
    q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16)
               for a in _attention_case(27, b=2, hq=2 * group, hkv=2,
                                        s=333, d=d))
    _bwd_check(q, k, v, True, window, 30.0 if window else 0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_lse_matches_logsumexp(dtype):
    """The forward's log-sum-exp rows against ``logsumexp`` of the plain
    scores (float32, the window and cap applied): 1e-5 of the largest."""
    from repro_torch.kernels.flash_attention.kernel import _forward
    dev = _cuda()
    q, k, v = (torch.from_numpy(a).to(dev, dtype)
               for a in _attention_case(22, b=1, hq=4, hkv=2, s=150, d=64))
    out, lse = _forward(q, k, v, True, 50.0, 40, True)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     k.float().repeat_interleave(2, dim=1)) / 8.0
    s = 50.0 * torch.tanh(s / 50.0)
    i = torch.arange(150, device=dev)[:, None]
    j = torch.arange(150, device=dev)[None, :]
    s = torch.where((i >= j) & (i - j < 40), s, -1e30)
    assert lse.shape == (1, 4, 150) and lse.dtype == torch.float32
    assert _rel(lse, torch.logsumexp(s, dim=-1)) <= 1e-5
    assert torch.equal(out, flash_attention_kernel(q, k, v, logit_cap=50.0,
                                                   window=40))


# ------------------------------------- B9 in float32: 3xTF32, key splits

def _f32_grads_checked(q, k, v, causal, window, cap):
    """FlashAttention (float32) against autograd through the plain
    version: the output within 1e-5, dq/dk/dv within 1e-5 of each
    gradient's largest magnitude (of the largest of the three where one
    query makes dq a sum that cancels), two backward runs torch.equal ->
    (out, lse, (dq, dk, dv))."""
    from repro_torch.kernels.flash_attention import FlashAttention
    from repro_torch.kernels.flash_attention.kernel import _forward
    dev = q.device
    do = torch.randn(q.shape, generator=torch.Generator(device=dev)
                     .manual_seed(11), device=dev)
    out, got = _grads(lambda a, b_, c: FlashAttention.apply(
        a, b_, c, causal, cap, window), q, k, v, do)
    _, again = _grads(lambda a, b_, c: FlashAttention.apply(
        a, b_, c, causal, cap, window), q, k, v, do)
    want_out, want = _grads(lambda a, b_, c: flash_attention_ref(
        a, b_, c, causal=causal, logit_cap=cap, window=window), q, k, v, do)
    with torch.no_grad():
        _, lse = _forward(q, k, v, causal, cap, window, True)
    torch.cuda.synchronize()
    assert _rel(out, want_out) <= 1e-5
    top = max(w.abs().max().item() for w in want)
    for g, a, w in zip(got, again, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert torch.equal(g, a)
        scale = top if 1 in (q.shape[2], k.shape[2]) else \
            w.abs().max().item()
        assert (g - w).abs().max().item() <= 1e-5 * scale
    return out, lse, got


@pytest.mark.gpu
@pytest.mark.parametrize("sq", [1, 5, 128])
def test_cuda_flash_attention_f32_key_split(sq):
    """Float32, non-causal, 1, 5 and 128 queries against 1500 keys, D 64,
    GQA 4/2: the forward splits the keys into 3 parts (fwd_key_parts,
    folded in order) and so does dQ (dq_key_parts); output and lse within
    1e-5 of plain, gradients within 1e-5, two runs torch.equal."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_kernel)
    dev = _cuda()
    q = torch.from_numpy(_attention_case(30, b=1, hq=4, hkv=2, s=sq,
                                         d=64)[0]).to(dev)
    _, k, v = (torch.from_numpy(a).to(dev)
               for a in _attention_case(31, b=1, hq=4, hkv=2, s=1500, d=64))
    _, lse, _ = _f32_grads_checked(q, k, v, False, 0, 0.0)
    assert flash_attention_kernel.key_parts == 3
    assert flash_attention_bwd_kernel.dq_parts == 3
    s = torch.einsum("bhqd,bhkd->bhqk", q,
                     k.repeat_interleave(2, dim=1)) / 8.0
    assert _rel(lse, torch.logsumexp(s, dim=-1)) <= 1e-5
    assert torch.equal(flash_attention_kernel(q, k, v, causal=False),
                       flash_attention_kernel(q, k, v, causal=False))


@pytest.mark.gpu
@pytest.mark.parametrize("sq, sk, causal", [(1, 1500, False),
                                            (128, 1500, False),
                                            (200, 200, True)])
def test_cuda_flash_attention_f32_row_alone_equals_batch(sq, sk, causal):
    """The split plan is a function of the lengths, never of the batch or
    heads: head 5 of batch 1 computed alone (with its kv head) gives the
    bits it has inside a call of 2 batches and 8 heads over 2 kv heads,
    for the output, the lse and dq."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_kernel)
    from repro_torch.kernels.flash_attention.kernel import _forward
    dev = _cuda()
    q = torch.from_numpy(_attention_case(32, b=2, hq=8, hkv=2, s=sq,
                                         d=64)[0]).to(dev)
    _, k, v = (torch.from_numpy(a).to(dev)
               for a in _attention_case(33, b=2, hq=8, hkv=2, s=sk, d=64))
    do = torch.randn(q.shape, generator=torch.Generator(device=dev)
                     .manual_seed(12), device=dev)
    out, lse = _forward(q, k, v, causal, 0.0, 0, True)
    dq = flash_attention_bwd_kernel(q, k, v, out, do, lse, causal=causal)[0]
    one = (slice(1, 2), slice(5, 6))
    kv = (slice(1, 2), slice(1, 2))        # head 5 reads kv head 5 // 4
    q1, do1 = q[one].contiguous(), do[one].contiguous()
    k1, v1 = k[kv].contiguous(), v[kv].contiguous()
    out1, lse1 = _forward(q1, k1, v1, causal, 0.0, 0, True)
    dq1 = flash_attention_bwd_kernel(q1, k1, v1, out1, do1, lse1,
                                     causal=causal)[0]
    torch.cuda.synchronize()
    assert torch.equal(out1, out[one])
    assert torch.equal(lse1, lse[one])
    assert torch.equal(dq1, dq[one])


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_f32_odd_strides(causal):
    """Float32 in the model's (B, S, H, D) layout with a row offset: q, k
    and v are columns of packed rows of H D + 3 floats, starting one float
    in (no 16-byte alignment anywhere: the 4-byte copies); output and
    gradients equal, bit for bit, the same values laid out
    contiguously, and hold the plain version to 1e-5."""
    from repro_torch.kernels.flash_attention import FlashAttention
    dev = _cuda()
    b, hq, hkv, s, d = 2, 4, 2, 130, 64
    q, k, v = (torch.from_numpy(a).to(dev) for a in
               _attention_case(34, b=b, hq=hq, hkv=hkv, s=s, d=d))

    def packed(x):
        """x's values in packed rows; the rows (the leaf) and the view"""
        h = x.shape[1]
        rows = torch.zeros((b, s, h * d + 3), device=dev)
        rows[:, :, 1:1 + h * d] = x.transpose(1, 2).reshape(b, s, h * d)
        rows.requires_grad_()
        view = rows[:, :, 1:1 + h * d].view(b, s, h, d).transpose(1, 2)
        assert view.stride(2) == h * d + 3 and view.data_ptr() % 16 == 4
        return rows, view
    (rq, qs), (rk, ks), (rv, vs) = (packed(x) for x in (q, k, v))
    do = torch.randn(q.shape, generator=torch.Generator(device=dev)
                     .manual_seed(11), device=dev)
    out = FlashAttention.apply(qs, ks, vs, causal, 0.0, 0)
    grads = [g[:, :, 1:1 + x.shape[1] * d].reshape(b, s, x.shape[1], d)
             .transpose(1, 2) for g, x in zip(
                 torch.autograd.grad(out, (rq, rk, rv), do), (q, k, v))]
    want_out, _, want = _f32_grads_checked(q, k, v, causal, 0, 0.0)
    torch.cuda.synchronize()
    assert torch.equal(out, want_out)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_cuda_flash_attention_backward_takes_any_output_gradient():
    """The incoming gradient may be any view (a broadcast from
    ``out.sum()``, a transposed layout): the wrapper copies it to a
    layout the kernel takes, and the result equals the contiguous
    gradient's."""
    from repro_torch.kernels.flash_attention import flash_attention
    dev = _cuda()
    q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16)
               .requires_grad_() for a in _attention_case(23, s=70, d=64))
    out = flash_attention(q, k, v)
    (g_sum,) = torch.autograd.grad(out.float().sum(), (q,))
    (g_ones,) = torch.autograd.grad(
        flash_attention(q, k, v), (q,), torch.ones_like(out))
    assert torch.equal(g_sum, g_ones)


# ---------------------------------------- kernels that drop gradients

@pytest.mark.gpu
def test_cuda_kernels_without_backward_refuse_to_record():
    """Each ctypes kernel without a backward, given a CUDA input that
    requires a gradient with grad enabled, raises naming its ROADMAP
    item instead of returning a detached result; under ``no_grad`` the
    same call launches."""
    from repro_torch.kernels.flash_attention import flash_attention
    dev = _cuda()
    q, k, v = (torch.from_numpy(a).to(dev) for a in _attention_case(
        24, s=40))
    dt, x, bm, cm, a, h0 = (torch.from_numpy(t).to(dev)
                            for t in _scan_case(6, seq=20))
    e, t, w = (torch.from_numpy(z).to(dev) for z in _counter_rows(0))
    cases = [
        ("B10: call ops.selective_scan",
         lambda r: selective_scan_kernel(dt, x.requires_grad_(r), bm, cm, a,
                                         h0)),
        ("B9", lambda r: flash_attention_kernel(q.requires_grad_(r), k, v)),
        ("B1", lambda r: power_reconstruct_rows_kernel(
            e.requires_grad_(r), t, w)),
        ("B3", lambda r: power_reconstruct_kernel(e.requires_grad_(r), t)),
        ("B8", lambda r: squarewave_kernel(
            torch.ones((8, 64), device=dev).requires_grad_(r),
            fma_chain=2)),
    ]
    for item, call in cases:
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            call(True)
        with torch.no_grad():
            call(True)
        call(False)
    # the public ops take a gradient through FlashAttention and
    # SelectiveScan instead
    out = flash_attention(q.requires_grad_(True), k, v)
    assert out.grad_fn is not None
    y, _ = selective_scan(dt, x.requires_grad_(True), bm, cm, a, h0)
    assert y.grad_fn is not None


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["whisper-base", "gemma2-27b",
                                  "moonshot-v1-16b-a3b", "xlstm-1.3b",
                                  "jamba-1.5-large-398b"])
def test_cuda_zoo_training_matches_cpu(arch):
    """``loss_and_grads`` on the card against the CPU on the same
    weights and batch, float32, at ``reduced()`` widths with heads of 64
    (B9's): whisper's encoder and its cross-attention (non-causal, 16
    keys to 64 queries, dk/dv flowing back into the encoder), gemma2's
    window and caps, MoE's router and experts, xLSTM's torch ops, the
    Mamba hybrid's scans (with its reduced MoE).  Loss within 1e-5, each
    gradient leaf within 1e-4 of its largest magnitude (the card's
    float32 sums in other orders, the bounds the port is held to against
    the reference); B9 once forward and once backward per attention call
    (never for xLSTM), B10 once forward and once backward per Mamba
    layer (the hybrid's only), and no other kernel."""
    import dataclasses
    from repro_torch.configs import get_arch, reduced
    from repro_torch.configs.base import ATTN, MAMBA
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_kernel)
    from repro_torch.models import Model
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.train.loop import loss_and_grads
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(reduced(get_arch(arch)), head_dim=64,
                              compute_dtype="float32")
    model = Model(cfg)
    host = model.init(0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    if cfg.family == "audio":
        batch["audio_frames"] = torch.from_numpy(rng.normal(
            0.0, 1.0, (2, cfg.num_audio_frames, cfg.d_model))
            .astype(np.float32))
    f0, s0 = flash_attention_kernel.launches, selective_scan_kernel.launches
    b0 = flash_attention_bwd_kernel.launches
    sb0 = selective_scan_bwd_kernel.launches
    loss_c, _, grads_c = loss_and_grads(
        model, tree_map(lambda t: t.to(dev), host),
        {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    fwd = flash_attention_kernel.launches - f0
    bwd = flash_attention_bwd_kernel.launches - b0
    assert fwd == bwd and (bwd > 0) == (cfg.family != "ssm")
    if cfg.family == "hybrid":
        assert bwd == cfg.blocks.count(ATTN)
    n_mamba = cfg.blocks.count(MAMBA)
    assert selective_scan_kernel.launches - s0 == n_mamba
    assert selective_scan_bwd_kernel.launches - sb0 == n_mamba
    assert (n_mamba > 0) == (cfg.family == "hybrid")
    loss_h, _, grads_h = loss_and_grads(model, host, batch)
    assert abs(loss_c.item() / loss_h.item() - 1.0) <= 1e-5
    for path, g, w in tree_leaves(tree_map(
            lambda p, g, w: ("/".join(p), g.cpu(), w), grads_c, grads_h,
            path=())):
        assert torch.isfinite(g).all(), path
        err = (g - w).abs().max() / w.abs().max().clamp_min(1e-30)
        assert err <= 1e-4, (path, err.item())


# B9 at the serving shapes of the four configurations that serve at
# full width in chip_smoke.py's phase 13b: minicpm-2b's 36/36 heads of
# 64, qwen1.5-32b's 40/40 of 128, qwen3-moe's 64/4 (16 query heads a kv
# head), 1000 tokens, causal
WIDE_ATTENTION = [(36, 36, 64), (40, 40, 128), (64, 4, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d", WIDE_ATTENTION)
def test_cuda_flash_attention_wide_serving_shapes(hq, hkv, d, dtype):
    """(1, Hq/Hkv, 1000, D) causal: float32 within 1e-5 and bfloat16
    within 8e-3 of the plain output's largest magnitude."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((1, h, 1000, d), generator=gen, device=dev)
               .mul_(s).to(dtype)
               for h, s in ((hq, 3.0), (hkv, 3.0), (hkv, 1.0)))
    n0 = flash_attention_kernel.launches
    got = flash_attention_kernel(q, k, v, causal=True)
    want = flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == n0 + 1
    assert _rel(got, want) <= (1e-5 if dtype == torch.float32 else 8e-3)


def _wide_first_layers(label):
    """The first layers of a phase-13b configuration at its published
    widths: one layer of minicpm-2b, qwen1.5-32b (QKV bias, its untied
    head) and qwen3-moe (128 experts top-8); Jamba 1.5 Large's first two
    (attention with its 16-expert MoE, then Mamba), in float32 compute."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ATTN, MAMBA
    arch = {"minicpm-2b": "minicpm-2b", "qwen1.5-32b": "qwen1.5-32b",
            "qwen3-moe": "qwen3-moe-235b-a22b",
            "jamba-moe": "jamba-1.5-large-398b"}[label]
    cfg = get_arch(arch)
    if label == "jamba-moe":
        cfg = dataclasses.replace(cfg, num_layers=2,
                                  block_pattern=(ATTN, MAMBA))
    else:
        cfg = dataclasses.replace(cfg, num_layers=1)
    return dataclasses.replace(cfg, compute_dtype="float32")


@pytest.mark.gpu
@pytest.mark.parametrize("label", ["minicpm-2b", "qwen1.5-32b", "qwen3-moe",
                                   "jamba-moe"])
def test_cuda_wide_config_first_layers_prefill_matches_cpu(label):
    """A 16-token prefill through the first layers at full width (weights
    stored in bf16 as served, computed in float32): B9 once per attention
    layer, B10 once per Mamba layer, and the last logits within 1e-4 of
    the same weights' prefill on the CPU (matrix products sum in other
    orders)."""
    from repro_torch.configs.base import ATTN, MAMBA
    from repro_torch.models import Model
    from repro_torch.models.layers import tree_map
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _wide_first_layers(label)
    model = Model(cfg)
    card_p = model.init(0, device=dev, cast_weights=True)
    toks = torch.randint(0, cfg.vocab_size, (1, 16),
                         generator=torch.Generator().manual_seed(0))
    f0, s0 = flash_attention_kernel.launches, selective_scan_kernel.launches
    lg, _ = model.prefill(card_p, {"tokens": toks.to(dev)},
                          model.init_cache(1, 32))
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches - f0 == cfg.blocks.count(ATTN)
    assert selective_scan_kernel.launches - s0 == cfg.blocks.count(MAMBA)
    lg = lg.cpu()
    cpu_p = tree_map(lambda t: t.cpu(), card_p)
    del card_p
    torch.cuda.empty_cache()
    want, _ = model.prefill(cpu_p, {"tokens": toks},
                            model.init_cache(1, 32, device="cpu"))
    assert torch.isfinite(lg).all()
    assert _rel(lg, want) <= 1e-4
