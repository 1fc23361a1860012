"""PyTorch port, on the card only: each CUDA kernel against its plain
PyTorch version.  Imports nothing of JAX, so it runs on a machine with a
card and no JAX:

    PYTHONPATH=src python -m pytest tests/test_torch_gpu.py -m gpu -q

Without a card every test here skips (the kernels have no CPU mode).
"""
import pytest
import torch

from repro_torch.kernels.grid_resample import (grid_resample_kernel,
                                               grid_resample_ref)
from repro_torch.kernels.power_reconstruct import (
    power_reconstruct_rows_kernel)
from repro_torch.kernels.power_reconstruct.ref import (
    reconstruct_power_rows_ref)
from repro_torch.kernels.xcorr_align import (make_refbank,
                                             xcorr_align_kernel,
                                             xcorr_scores, xcorr_scores_ref)
from torch_cases import _counter_rows, _regrid_case, _t, _xcorr_case


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
