"""PyTorch port, ``fleet.packing.pack_traces(out=)``: a previous pack of
the same shape and dtype lends its energy and times buffers (the
reference's streaming-ingest buffer reuse), and the contents equal a
fresh pack's and the reference's."""
import dataclasses

import numpy as np
import pytest

from multihost.simdata import sim_groups
from repro.fleet import packing as jpack
from repro_torch import interop
from repro_torch.fleet import packing as tpack


def _traces(seed):
    _, groups, _ = sim_groups(3, seed=seed, span_s=0.6)
    flat = [tr for g in groups for tr in g]
    port = [interop.trace_from_fields(tr.name, dataclasses.asdict(tr.spec),
                                      tr.t_read, tr.t_measured, tr.value)
            for tr in flat]
    return flat, port


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pack_traces_reuses_a_same_shaped_pack(dtype):
    """Two batches of the same fleet: the second pack, given the first
    as ``out``, keeps its energy and times arrays (the same objects) and
    holds what a fresh pack and the reference's hold, array for array;
    a pack of another dtype is not reused."""
    _, port0 = _traces(0)
    flat1, port1 = _traces(1)
    first = tpack.pack_traces(port0, dtype=dtype)
    # the same shape: the second batch cut to the first's longest trace
    s = first.shape[1]
    port1 = [dataclasses.replace(tr, t_read=tr.t_read[:s],
                                 t_measured=tr.t_measured[:s],
                                 value=tr.value[:s]) for tr in port1]
    flat1 = [dataclasses.replace(tr, t_read=tr.t_read[:s],
                                 t_measured=tr.t_measured[:s],
                                 value=tr.value[:s]) for tr in flat1]
    energy, times = first.energy, first.times
    again = tpack.pack_traces(port1, dtype=dtype, out=first)
    assert again.shape == first.shape
    assert again.energy is energy and again.times is times
    fresh = tpack.pack_traces(port1, dtype=dtype)
    want = jpack.pack_traces(flat1, dtype=dtype)
    for name in ("energy", "times", "n_samples", "wrap_period", "e0"):
        np.testing.assert_array_equal(getattr(again, name),
                                      getattr(fresh, name))
        np.testing.assert_array_equal(getattr(again, name),
                                      getattr(want, name))
    assert again.t0 == fresh.t0 == want.t0
    assert again.names == want.names
    other = np.float64 if dtype == np.float32 else np.float32
    assert tpack.pack_traces(port1, dtype=other, out=first).energy \
        is not energy
