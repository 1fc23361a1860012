"""Seeded inputs shared by the port's kernel tests (numpy only, so the
card-only tests can use them where JAX is not installed)."""
import numpy as np
import torch

WRAP_26 = float(2 ** 26) * 1e-6        # the 2^26 uJ counter, in joules


def _counter_rows(seed, f=16, s=300):
    """Cumulative counters: some wrap at 2^26 uJ (float32 values near the
    wrap), some at a small period, some never; jittered times with
    duplicates (dt = 0)."""
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.5e-3, 1.5e-3, (f, s))
    dt[:, ::17] = 0.0
    t = np.cumsum(dt, axis=1).astype(np.float32)
    de = rng.uniform(0.0, 0.4, (f, s))
    e = WRAP_26 - 30.0 + np.cumsum(de, axis=1)
    wrap = np.zeros((f, 1))
    wrap[: f // 2] = WRAP_26
    wrap[f // 2: 3 * f // 4] = 7.5
    e = np.where(wrap > 0, np.mod(e, np.where(wrap > 0, wrap, 1.0)), e)
    return e.astype(np.float32), t, wrap.astype(np.float32)


def _regrid_case(seed, f=12, s=200, g=333, sentinel=True):
    """Rows with a -inf sentinel column, first > 0 on some rows, n < S
    on others, duplicate times, per-row delays."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.0, 2e-3, (f, s)), axis=1)
    t[:, 5::11] = t[:, 4::11][:, :t[:, 5::11].shape[1]]   # equal times
    if sentinel:
        t[:, 0] = -np.inf
    v = rng.normal(100.0, 20.0, (f, s))
    n = np.full((f, 1), s, np.int32)
    n[::3] = rng.integers(s // 2, s, (len(n[::3]), 1))
    first = np.zeros((f, 1), np.int32)
    first[1::4] = rng.integers(1, 20, (len(first[1::4]), 1))
    grid = np.linspace(-0.01, float(np.nanmax(t[np.isfinite(t)])) + 0.01,
                       g)[:, None]
    d = rng.uniform(-3e-3, 3e-3, (f, 1))
    return (t.astype(np.float32), v.astype(np.float32), n, first,
            grid.astype(np.float32), d.astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _xcorr_case(seed, f=20, g=512, max_lag=16):
    rng = np.random.default_rng(seed)
    ref = np.where((np.arange(g) // 64) % 2 == 0, 55.0, 215.0)
    lag = rng.integers(-8, 9, f)
    x = np.stack([np.roll(ref, k) for k in lag]) \
        + rng.normal(0.0, 3.0, (f, g)) + rng.uniform(0, 50, (f, 1))
    m = (rng.random((f, g)) > 0.05).astype(np.float32)
    m[:, :10] = 0.0
    return x.astype(np.float32), m, ref, lag, max_lag


def _xcorr_edge_case(f, g, lags, seed=0):
    """B4 at an edge: ``f`` streams of ``g`` grid points against ``lags``
    real lags (max_lag = (lags - 1) // 2) of _xcorr_case's square wave;
    row 0 (of two or more) all masked, the last row offset by 1e4 W (the
    centring's precision)."""
    rng = np.random.default_rng(seed)
    ref = np.where((np.arange(g) // 64) % 2 == 0, 55.0, 215.0)
    shift = rng.integers(-8, 9, f)
    x = np.stack([np.roll(ref, k) for k in shift]) \
        + rng.normal(0.0, 3.0, (f, g)) + rng.uniform(0, 50, (f, 1))
    x[-1] += 1e4
    m = (rng.random((f, g)) > 0.05).astype(np.float32)
    if f > 1:
        m[0] = 0.0
    return x.astype(np.float32), m, ref, (lags - 1) // 2


def _fleet_rows(seed, f=16, s=300):
    """Raw padded counter reads for the fused fleet front end: the
    counter rows above plus per-row sample counts (some rows short) and,
    on rows 2 and 9, a timestamp that goes backwards."""
    e, t, w = _counter_rows(seed, f, s)
    rng = np.random.default_rng(seed + 100)
    n = np.full((f, 1), s, np.int32)
    n[1::3] = rng.integers(s // 2, s, (len(n[1::3]), 1))
    for r in (2, 9):
        j = int(rng.integers(10, s // 2))
        t[r, j] = t[r, j - 2]
    return e, t, w, n


def _phase_table(seed, p=5, t_hi=0.3):
    """(32, 2) float32 phase windows: ``p`` real ones (overlapping, one
    past the data) padded with zero-width rows."""
    rng = np.random.default_rng(seed + 200)
    a = np.sort(rng.uniform(0.0, t_hi, p))
    b = a + rng.uniform(0.01, t_hi / 2, p)
    ph = np.zeros((32, 2), np.float32)
    ph[:p, 0], ph[:p, 1] = a, b
    return ph


def _power_rows(seed, f=12, s=300):
    """Sample-and-hold power rows with a carry column: duplicates (zero
    width), and a -inf first edge on row 3."""
    rng = np.random.default_rng(seed + 300)
    t = np.cumsum(rng.uniform(0.0, 2e-3, (f, s)), axis=1)
    t[:, 7::13] = t[:, 6::13][:, :t[:, 7::13].shape[1]]
    t[3, 0] = -np.inf
    w = rng.uniform(40.0, 260.0, (f, s))
    return t.astype(np.float32), w.astype(np.float32)


def _attention_case(seed, b=2, hq=4, hkv=2, s=200, d=64):
    """q (B, Hq, S, D) and k/v (B, Hkv, S, D) float32, scaled so that the
    soft-cap at 50 bites on some scores."""
    rng = np.random.default_rng(seed + 400)
    q = rng.normal(0.0, 1.0, (b, hq, s, d)) * (8.0 / d ** 0.25)
    k = rng.normal(0.0, 1.0, (b, hkv, s, d)) * (8.0 / d ** 0.25)
    v = rng.normal(0.0, 1.0, (b, hkv, s, d))
    return (q.astype(np.float32), k.astype(np.float32),
            v.astype(np.float32))


def _scan_case(seed, b=2, seq=96, d=160, n=8):
    """Selective-scan inputs as Mamba builds them: dt > 0 (softplus),
    A < 0, x, B, C, and a non-zero carried state h0; float32."""
    rng = np.random.default_rng(seed + 500)
    dt = np.log1p(np.exp(rng.normal(-1.0, 1.0, (b, seq, d))))
    x = rng.normal(0.0, 1.0, (b, seq, d))
    bm = rng.normal(0.0, 1.0, (b, seq, n))
    cm = rng.normal(0.0, 1.0, (b, seq, n))
    a = -np.exp(rng.normal(0.0, 0.5, (d, n)))
    h0 = rng.normal(0.0, 1.0, (b, d, n))
    return tuple(v.astype(np.float32) for v in (dt, x, bm, cm, a, h0))


# Edge cases of the regrid (B5): per kind, (t, v, n, first, grid, d) as
# ``_regrid_case`` returns them.  Every row is sorted inside [first, n).
REGRID_EDGES = ("straddle", "duplicates", "sentinel", "mod1", "mod2",
                "mod3", "long", "xlong", "unsorted_grid", "swapped_grid")


def _regrid_edge_case(kind, seed=0, f=12, s=300):
    """``straddle``: first > 0 and n < S with unsorted junk outside
    [first, n), and a grid finer than the samples, so that 32-query chunks
    straddle t[first] and t[n-1] and queries fall before and after both;
    ``duplicates``: runs of equal timestamps, grid points on them;
    ``sentinel``: the -inf column the streaming tail prepends; ``mod1``,
    ``mod2``, ``mod3``: S = 301, 302, 303 (rows not 16-byte aligned);
    ``long``: rows of 20000 samples (160 KB of times and values, past
    the 48 KB a block has without the opt-in); ``xlong``: 32768 samples
    (256 KB: more than an H100 block's shared memory holds);
    ``unsorted_grid``: the grid shuffled, so no chunk is in order;
    ``swapped_grid``: a few neighbouring grid points swapped, so some
    chunks are in order and some are not."""
    rng = np.random.default_rng(seed + 600)
    if kind.startswith("mod"):
        s = 300 + int(kind[3:])
    elif kind == "long":
        f, s = 4, 20000
    elif kind == "xlong":
        f, s = 2, 32768
    dt = rng.uniform(0.2e-3, 2e-3, (f, s))
    if kind == "duplicates":
        dt[rng.random((f, s)) < 0.4] = 0.0
    t = np.cumsum(dt, axis=1)
    v = rng.normal(100.0, 20.0, (f, s))
    n = np.full((f, 1), s, np.int32)
    first = np.zeros((f, 1), np.int32)
    d = rng.uniform(-1e-3, 1e-3, (f, 1))
    lo = float(np.min(t[:, 1])) - 0.02
    hi = float(np.max(t[:, s - 1])) + 0.02
    if kind == "straddle":
        first[:, 0] = rng.integers(5, 40, f)
        n[:, 0] = s - rng.integers(5, 40, f)
        for r in range(f):
            t[r, :first[r, 0]] = rng.uniform(-1.0, 2.0, first[r, 0])
            t[r, n[r, 0]:] = rng.uniform(-1.0, 2.0, s - n[r, 0])
    if kind == "sentinel":
        t[:, 0] = -np.inf
    grid = np.linspace(lo, hi, int((hi - lo) / 3e-4))
    if kind == "duplicates":
        d[0] = 0.0
        grid = np.sort(np.concatenate([grid, t[0, ::7]]))
    grid = grid.astype(np.float32)
    if kind == "unsorted_grid":
        grid = rng.permutation(grid)
    elif kind == "swapped_grid":
        for j in rng.choice(len(grid) - 1, 12, replace=False):
            grid[j], grid[j + 1] = grid[j + 1], grid[j]
    return (t.astype(np.float32), v.astype(np.float32), n, first,
            grid[:, None], d.astype(np.float32))


# Edge cases of the phase integration (B6): per kind, (t, w, phases).
PHASE_EDGES = ("nonfinite", "carry", "overlap32", "zero_width", "p39")


def _phase_partition(t_hi, p=6, pad_to=32):
    """``p`` phases that partition [0.05, 0.95] x t_hi, padded to
    ``pad_to`` with empty [0, 0) windows as the pipeline pads them."""
    e = np.linspace(0.05 * t_hi, 0.95 * t_hi, p + 1)
    ph = np.zeros((max(p, pad_to), 2))
    ph[:p, 0], ph[:p, 1] = e[:-1], e[1:]
    return ph


def _phase_edge_case(kind, seed=0, f=16, s=1500):
    """``nonfinite``: a NaN watt in row 2, an inf watt in row 5 and a NaN
    time in row 9, among finite rows; ``carry``: the -inf carry column in
    every row; ``overlap32``: 32 real windows, overlapping and unsorted;
    ``zero_width``: empty windows (a == b, and one with a > b) between
    the real ones; ``p39``: 39 overlapping windows (two 32-window tiles).
    The rows are ``_power_rows``'s (duplicate times, -inf at t[3, 0])."""
    t, w = _power_rows(seed, f=f, s=s)
    rng = np.random.default_rng(seed + 700)
    t_hi = float(t[np.isfinite(t)].max())
    if kind == "nonfinite":
        w[2, s // 3] = np.nan
        w[5, s // 2] = np.inf
        t[9, 2 * s // 3] = np.nan
    elif kind == "carry":
        t[:, 0] = -np.inf
    return t, w, _edge_phases(kind, t_hi, rng)


def _edge_phases(kind, t_hi, rng):
    """The phase table of an edge case over a run ending near ``t_hi``:
    ``overlap32``/``p39``: 32/39 overlapping unsorted windows;
    ``zero_width``: the six real phases with empty windows between them;
    otherwise the six real phases padded to 32."""
    ph = _phase_partition(t_hi)
    if kind in ("overlap32", "p39"):
        p = 32 if kind == "overlap32" else 39
        a = rng.uniform(-0.1 * t_hi, 0.6 * t_hi, p)
        ph = np.stack([a, a + rng.uniform(0.2 * t_hi, 0.8 * t_hi, p)], 1)
    elif kind == "zero_width":
        real = _phase_partition(t_hi, pad_to=0)
        mids = 0.5 * (real[:, 0] + real[:, 1])
        empty = np.concatenate([np.stack([real[:, 1], real[:, 1]], 1),
                                np.stack([mids, mids], 1),
                                [[0.6 * t_hi, 0.4 * t_hi]]])
        ph = np.zeros((32, 2))
        ph[:len(real) + len(empty)] = np.concatenate([real, empty])[
            rng.permutation(len(real) + len(empty))]
    return ph.astype(np.float32)


# Edge cases of the fused counter attribution (B7): per kind, (t, e,
# wrap_row, phases).
FA_EDGES = ("nonfinite", "carry", "ninf_carry", "wrap", "stepback",
            "duplicates", "overlap32", "zero_width", "p39")


def _first_window(t, e, valid):
    """What ``FleetStream``'s first ``update`` hands the fused kernel: the
    sanitizing ingest's first closed window, whose column 0 is the carry
    each row was seeded with (its first valid read; the row's first slot
    where no read is valid), ahead of the chunk's repaired reads."""
    from repro_torch.fleet.pipeline import IngestStage
    ingest = IngestStage(t.shape[0], mode="sanitize", device="cpu")
    win = ingest.update(torch.from_numpy(t), torch.from_numpy(e),
                        torch.from_numpy(valid))
    return win.times.numpy().copy(), win.values.numpy().copy()


def _fa_edge_case(kind, seed=0, f=16, s=1025):
    """Counter chunks of ``s`` columns (the streaming chunk of 1024 reads
    and its carry column) from ``_counter_rows`` (wraps at 2^26 uJ and at
    7.5 J, zero-width intervals with dE != 0), then per kind:
    ``nonfinite``: a NaN energy in row 2, an inf energy in row 5, a NaN
    time in row 9, an inf time in row 11; ``carry``: the window
    ``FleetStream``'s first update passes (``_first_window``: invalid
    leading slots in rows 0-3, row 6 never valid, a read out of order in
    row 8); ``ninf_carry``: a -inf carry time in every row; ``wrap``:
    every row wrapping at 7.5 J several times inside each 128-read slice;
    ``stepback``: counters stepping back by less than half the wrap (and
    on rows that do not wrap), so some intervals have negative power;
    ``duplicates``: runs of repeated (t, E) reads; ``overlap32``,
    ``zero_width``, ``p39``: the phase tables of ``_edge_phases``."""
    e, t, w = _counter_rows(seed, f=f, s=s)
    rng = np.random.default_rng(seed + 800)
    if kind == "nonfinite":
        e[2, s // 3] = np.nan
        e[5, s // 2] = np.inf
        t[9, 2 * s // 3] = np.nan
        t[11, s // 4] = np.inf
    elif kind == "carry":
        valid = np.ones((f, s - 1), bool)
        for r in range(4):
            valid[r, :rng.integers(1, 40)] = False
        valid[6] = False
        t_in, e_in = t[:, 1:].copy(), e[:, 1:].copy()
        t_in[8, 300] = t_in[8, 290]
        t, e = _first_window(t_in, e_in, valid)
    elif kind == "ninf_carry":
        t[:, 0] = -np.inf
    elif kind == "wrap":
        w[:] = 7.5
        e = np.mod(np.cumsum(rng.uniform(0.0, 0.4, (f, s)), axis=1),
                   7.5).astype(np.float32)
    elif kind == "stepback":
        w[::2] = 7.5
        w[1::2] = 0.0
        e = np.cumsum(rng.uniform(0.0, 0.4, (f, s)), axis=1)
        back = rng.random((f, s)) < 0.2
        e = np.where(back, e - rng.uniform(0.01, 3.0, (f, s)), e)
        e = np.where(w > 0, np.mod(e, 7.5), e).astype(np.float32)
    elif kind == "duplicates":
        for r in range(f):
            for j in rng.choice(np.arange(1, s - 8), 40, replace=False):
                k = int(rng.integers(1, 8))
                t[r, j:j + k] = t[r, j - 1]
                e[r, j:j + k] = e[r, j - 1]
    t_hi = float(t[np.isfinite(t)].max())
    return t, e, w, _edge_phases(kind, t_hi, rng)


# Edge cases of the fused fleet front end (B2): per kind, (e, t, wrap_row,
# n_row).
PR_EDGES = ("n0", "n1", "short", "reordered", "duplicates", "wrap",
            "mod0", "mod1", "mod2", "mod3", "s3", "s1")


def _pr_edge_case(kind, seed=0, f=16, s=300):
    """``_fleet_rows`` (short rows, reads out of order in rows 2 and 9,
    wraps), then per kind: ``n0``/``n1``: rows with no read or one;
    ``short``: every row cut at its own n < S, from 2 to S - 1, at every
    residue mod 4; ``reordered``: reads out of order in every row, some
    at n - 1 and n and past n (which must not count); ``duplicates``:
    runs of repeated (t, E) reads; ``wrap``: every row wrapping at 7.5 J
    many times; ``mod0`` .. ``mod3``: S = 300 .. 303 (rows start 16-byte
    aligned only for S % 4 == 0); ``s3``, ``s1``: S = 3 and 1, shorter
    than one thread's run of 4 columns."""
    if kind.startswith("mod"):
        s = 300 + int(kind[3:])
    elif kind in ("s3", "s1"):
        s = int(kind[1:])
    e, t, w, n = _fleet_rows(seed, f=f, s=max(s, 40))
    e, t = e[:, :s].copy(), t[:, :s].copy()
    n = np.minimum(n, s).astype(np.int32)
    rng = np.random.default_rng(seed + 900)
    if kind == "n0":
        n[::3] = 0
    elif kind == "n1":
        n[::3] = 1
        n[1::3] = 2
    elif kind == "short":
        n[:, 0] = np.linspace(2, s - 1, f).astype(np.int32)
    elif kind == "reordered":
        n[:, 0] = rng.integers(s // 2, s, f)
        for r in range(f):
            nr = int(n[r, 0])
            for j in (int(rng.integers(2, nr - 1)), nr - 1, nr,
                      min(nr + 3, s - 1)):
                if r % 4 != 3 or j >= nr:
                    t[r, j] = t[r, j - 1] - 1e-4
    elif kind == "duplicates":
        for r in range(f):
            for j in rng.choice(np.arange(1, s - 8), 20, replace=False):
                k = int(rng.integers(1, 8))
                t[r, j:j + k] = t[r, j - 1]
                e[r, j:j + k] = e[r, j - 1]
    elif kind == "wrap":
        w[:] = 7.5
        e = np.mod(np.cumsum(rng.uniform(0.0, 0.4, (f, s)), axis=1),
                   7.5).astype(np.float32)
    return e, t, w, n
