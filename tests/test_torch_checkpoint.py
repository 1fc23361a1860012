"""PyTorch port, checkpoints: the on-disk format of ``train.checkpoint``
against the reference's (leaf order, bytes, retention, integrity), and
the windowed pipeline's ``checkpoint``/``restore``: a killed and resumed
port run bit-identical to its uninterrupted run, checkpoints crossing
between the packages in both directions (within 1e-5 of the reference's
uninterrupted run), the config refusal, the dense-vs-dict pattern sets,
and the reference's ``_unseeded`` property on both sides."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from multihost.simdata import (energy_matrix, shared_grid_and_phases,
                               sim_groups)
from repro.fleet import pipeline as jpl
from repro.train import checkpoint as jck
from repro_torch import interop
from repro_torch.fleet import pipeline as tpl
from repro_torch.train import checkpoint as tck

CPU = "cpu"
E_TOL = 1e-5

torch.set_num_threads(2)


class _Kill(Exception):
    pass


def _killer(at):
    def hook(pipe, w):
        if w == at:
            raise _Kill
    return hook


def _port_groups(groups):
    return [[interop.trace_from_fields(tr.name, dataclasses.asdict(tr.spec),
                                       tr.t_read, tr.t_measured, tr.value)
             for tr in g] for g in groups]


def _kw(kind, truth, delays):
    if kind == "fixed-delays":
        return dict(delays=delays)
    kw = dict(reference=truth, track=True)
    if kind == "tracked-health":
        kw["health"] = True
    return kw


def _config(mod, grid, delays=None, track=None, health=None,
            checkpoint_dir=None, checkpoint_every=0, resume=False):
    """The reference test's run as a ``PipelineConfig`` of package
    ``mod`` (``repro.fleet.config`` or ``repro_torch.fleet.config``)."""
    return mod.PipelineConfig(
        stream=mod.StreamConfig(chunk=257, grid=grid),
        track=mod.TrackConfig(track=track, delays=delays, window=512,
                              hop=128),
        checkpoint=mod.CheckpointConfig(dir=checkpoint_dir,
                                        every=checkpoint_every,
                                        resume=resume),
        health=health)


def _port(groups, phases, grid, reference=None, on_window=None, **kw):
    from repro_torch.fleet import config
    return energy_matrix(tpl.attribute_energy_fused_streaming(
        _port_groups(groups), phases, config=_config(config, grid, **kw),
        reference=reference, on_window=on_window, device=CPU))


def _ref(groups, phases, grid, reference=None, on_window=None, **kw):
    from repro.fleet import config
    return energy_matrix(jpl.attribute_energy_fused_streaming(
        groups, phases, config=_config(config, grid, **kw),
        reference=reference, on_window=on_window))


def _rel(got, want):
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)))


# ---------------------------------------------------------------- format

def _tree():
    rng = np.random.default_rng(0)
    # equal shapes under keys whose sorted order is not their insertion
    # order: a flattener in insertion order would swap them silently
    return {"ints": {"2": rng.normal(size=(3, 2)),
                     "10": rng.normal(size=(3, 2)),
                     "3": rng.normal(size=(3, 2))},
            "a": [np.arange(4, dtype=np.int64),
                  (np.ones((2,), np.float32), np.array([True, False]))],
            "none": None}


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    elif want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_flatten_order_and_treedef_match_reference():
    import jax
    tree = _tree()
    leaves, treedef = tck._flatten(tree)
    jleaves, jdef = jax.tree.flatten(tree)
    assert treedef == str(jdef)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_leaf_order_crosses_packages(tmp_path, direction):
    """A nested dict keyed "2", "10", "3" reads back equal in the other
    package: the leaves are numbered in sorted-key order on both sides."""
    tree = _tree()
    save, load = ((jck.save_checkpoint, tck.restore_checkpoint)
                  if direction == "ref_to_port"
                  else (tck.save_checkpoint, jck.restore_checkpoint))
    save(tmp_path, 4, tree, extra_meta={"who": direction})
    like = {"ints": {k: np.zeros((3, 2)) for k in ("3", "10", "2")},
            "a": [np.zeros(4, np.int64),
                  (np.zeros((2,), np.float32), np.zeros(2, bool))],
            "none": None}
    got, step, meta = load(tmp_path, like)
    assert step == 4 and meta == {"who": direction}
    _assert_tree_equal(got, tree)


def test_files_byte_identical_to_reference(tmp_path):
    tree = _tree()
    jck.save_checkpoint(tmp_path / "ref", 7, tree, extra_meta={"m": [1]})
    tck.save_checkpoint(tmp_path / "port", 7, tree, extra_meta={"m": [1]})
    a, b = tmp_path / "ref" / "step_00000007", tmp_path / "port" / \
        "step_00000007"
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_roundtrip_retention_and_tmp_sweep(tmp_path):
    tree = _tree()
    (tmp_path / "step_00000099.tmp").mkdir(parents=True)   # a crashed save
    for step in (1, 2, 3, 4):
        tck.save_checkpoint(tmp_path, step, tree, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000003", "step_00000004"]
    assert tck.latest_step(tmp_path) == 4
    meta, step = tck.checkpoint_meta(tmp_path)
    assert (meta, step) == ({}, 4)
    got, step, _ = tck.restore_checkpoint(tmp_path, tree, step=3)
    assert step == 3
    _assert_tree_equal(got, tree)
    assert tck.latest_step(tmp_path / "none") is None
    with pytest.raises(FileNotFoundError):
        tck.restore_checkpoint(tmp_path / "none", tree)


def test_tensor_leaves_save_as_numpy(tmp_path):
    t = torch.arange(6, dtype=torch.float64).reshape(2, 3)
    tck.save_checkpoint(tmp_path, 1, {"t": t})
    got, _, _ = jck.restore_checkpoint(tmp_path, {"t": np.zeros((2, 3))})
    np.testing.assert_array_equal(got["t"], t.numpy())


def test_checksum_mismatch_raises(tmp_path):
    tree = _tree()
    d = tck.save_checkpoint(tmp_path, 1, tree)
    leaf = d / "leaf_00000.npy"
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 0xFF
    leaf.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="checksum"):
        tck.restore_checkpoint(tmp_path, tree)


def test_dtype_mismatch_raises_unless_cast(tmp_path):
    tck.save_checkpoint(tmp_path, 1, {"x": np.arange(3.0)})
    like = {"x": np.zeros(3, np.float32)}
    with pytest.raises(TypeError, match="cast=True"):
        tck.restore_checkpoint(tmp_path, like)
    got, _, _ = tck.restore_checkpoint(tmp_path, like, cast=True)
    assert got["x"].dtype == np.float32
    np.testing.assert_array_equal(got["x"], [0.0, 1.0, 2.0])


# ---------------------------------------------------------------- pipeline

@pytest.fixture(scope="module")
def sim():
    truth, groups, delays = sim_groups(3)
    grid, phases = shared_grid_and_phases(groups)
    return truth, groups, delays, grid, phases


KINDS = ["fixed-delays", "tracked", "tracked-health"]


@pytest.mark.parametrize("kind", KINDS)
def test_kill_resume_bit_identical(tmp_path, sim, kind):
    """Kill at window 7 with a checkpoint every 3 windows (resumes from
    6): the port's resumed energies equal its uninterrupted run's to the
    bit."""
    truth, groups, delays, grid, phases = sim
    kw = _kw(kind, truth, delays)
    base = _port(groups, phases, grid, **kw)
    with pytest.raises(_Kill):
        _port(groups, phases, grid, checkpoint_dir=tmp_path,
              checkpoint_every=3, on_window=_killer(7), **kw)
    resumed = _port(groups, phases, grid, checkpoint_dir=tmp_path,
                    resume=True, **kw)
    np.testing.assert_array_equal(resumed, base)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_checkpoint_crosses_packages(tmp_path, sim, direction, kind):
    """A checkpoint written mid-run by one package finishes in the other,
    within 1e-5 of the reference's uninterrupted run."""
    truth, groups, delays, grid, phases = sim
    kw = _kw(kind, truth, delays)
    first, second = ((_ref, _port) if direction == "ref_to_port"
                     else (_port, _ref))
    base = _ref(groups, phases, grid, **kw)
    with pytest.raises(_Kill):
        first(groups, phases, grid, checkpoint_dir=tmp_path,
              checkpoint_every=3, on_window=_killer(7), **kw)
    resumed = second(groups, phases, grid, checkpoint_dir=tmp_path,
                     resume=True, **kw)
    assert _rel(resumed, base) <= E_TOL


def _metered(pkg, groups, phases, grid, delays, on_window=None, **ck):
    """A fixed-delay run of package ``pkg`` ("port" or "ref") with a
    metering stage -> (totals, {rid: per-device joules})."""
    if pkg == "port":
        from repro_torch.fleet import SlotSegment, config
        run, groups = tpl.attribute_energy_fused_streaming, \
            _port_groups(groups)
        kw = dict(device=CPU)
    else:
        from repro.fleet import config
        from repro.fleet.pipeline import SlotSegment
        run, kw = jpl.attribute_energy_fused_streaming, {}
    (_, a, m), (_, _, b) = phases[1], phases[-2]
    segs = [SlotSegment(a, m, (0, 1), (3.0, 1.0)),
            SlotSegment(m, b, (1, 2), (2.0, 5.0))]
    out, pipe = run(groups, phases,
                    config=_config(config, grid, delays=delays, **ck),
                    meter=segs, on_window=on_window, return_pipe=True,
                    **kw)
    return energy_matrix(out), pipe.request_energies()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_kill_resume_with_metering(tmp_path, sim, writer):
    """The metering stage's per-segment integrals checkpoint too: the
    port resumes a run killed in either package; its own kill/resume is
    bit-identical, the reference's within 1e-5."""
    truth, groups, delays, grid, phases = sim
    base, rbase = _metered("port", groups, phases, grid, delays)
    with pytest.raises(_Kill):
        _metered(writer, groups, phases, grid, delays,
                 on_window=_killer(7), checkpoint_dir=tmp_path,
                 checkpoint_every=3)
    got, rgot = _metered("port", groups, phases, grid, delays,
                         checkpoint_dir=tmp_path, resume=True)
    assert sorted(rgot) == sorted(rbase) == [0, 1, 2]
    if writer == "port":
        np.testing.assert_array_equal(got, base)
        for rid in rbase:
            np.testing.assert_array_equal(rgot[rid], rbase[rid])
    else:
        assert _rel(got, base) <= E_TOL
        for rid in rbase:
            assert _rel(rgot[rid], rbase[rid]) <= E_TOL


def test_resume_without_checkpoint_is_cold_start(tmp_path, sim):
    truth, groups, delays, grid, phases = sim
    base = _port(groups, phases, grid, delays=delays)
    resumed = _port(groups, phases, grid, delays=delays,
                    checkpoint_dir=tmp_path / "empty", resume=True)
    np.testing.assert_array_equal(resumed, base)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_restore_refuses_config_mismatch(tmp_path, sim, writer):
    """A checkpoint of a differently shaped pipeline is refused, not
    misread, whichever package wrote it."""
    truth, groups, delays, grid, phases = sim
    run = _port if writer == "port" else _ref
    with pytest.raises(_Kill):
        run(groups, phases, grid, delays=delays, checkpoint_dir=tmp_path,
            checkpoint_every=3, on_window=_killer(4))
    with pytest.raises(AssertionError, match="config mismatch"):
        _port(groups, phases[:3], grid, delays=delays,
              checkpoint_dir=tmp_path, resume=True)


def test_config_fingerprint_matches_reference():
    kw = dict(grid_origin=0.25, grid_step=1e-3, kind_row=[True, False],
              reference=lambda t: np.ones_like(t), window=256, hop=64,
              tail=300, var_floor=0.5, health=True)
    port = tpl.StreamingFusedPipeline([2], [(0.0, 1.0)], device=CPU, **kw)
    ref = jpl.StreamingFusedPipeline([2], [(0.0, 1.0)], **kw)
    cfg = port._ckpt_config()
    assert cfg == ref._ckpt_config()
    assert cfg["dtype"] == "float32"
    assert json.loads(json.dumps(cfg)) == cfg


# ------------------------------------------------------ driven by update()

def _blocks(n_win=5, dark_until=0):
    """Windows of two rows on a 10 ms grid.  Row 1 publishes from 0.2 s
    (its slots before then are uncovered: the pattern {row 0} is seen
    there but lies before the phase, so it integrates exactly 0); with
    ``dark_until`` its first windows are masked placeholders."""
    out = []
    for w in range(n_win):
        t0 = 0.3 * w
        t = np.stack([t0 + 0.01 * np.arange(30),
                      (np.linspace(0.2, 0.29, 30) if w == 0
                       else t0 + 0.01 * np.arange(30))])
        v = np.stack([100.0 * t[0] + 5.0, 110.0 * t[1] + 40.0])
        valid = np.ones_like(t, bool)
        if w < dark_until:
            t[1], v[1], valid[1] = 0.0, 0.0, False
        out.append((t.astype(np.float32), v.astype(np.float32),
                    valid if dark_until else None))
    return out


def _pipes(sizes, kind_row):
    kw = dict(grid_origin=0.0, grid_step=0.01, kind_row=list(kind_row),
              delays=np.zeros(2), window=64, hop=16, tail=64)
    return (lambda: tpl.StreamingFusedPipeline(sizes, [(0.5, 1.2)],
                                               device=CPU, **kw),
            lambda: jpl.StreamingFusedPipeline(sizes, [(0.5, 1.2)],
                                               **kw))


def _drive(pipe, blocks):
    for t, v, valid in blocks:
        pipe.update(t, v, valid)
    return pipe


def _totals(pipe):
    pipe.finalize()
    t = pipe.totals()
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else t


def test_pattern_seen_but_zero_saved_differently_restores_alike(tmp_path):
    """The reference saves every pattern it has seen; the port saves the
    patterns that integrated anything.  A pattern seen only before the
    phase (exactly 0) is in the reference's checkpoint and not the
    port's, and both checkpoints finish the run alike in both
    packages."""
    make_port, make_ref = _pipes([2], (False, False))
    blocks = _blocks()
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    for make, d in ((make_port, tmp_path / "p"), (make_ref, tmp_path / "r")):
        _drive(make(), blocks[:2]).checkpoint(d)
    pmeta, _ = tck.checkpoint_meta(tmp_path / "p" / "group_00000")
    rmeta, _ = tck.checkpoint_meta(tmp_path / "r" / "group_00000")
    assert rmeta["attr_patterns"] == [1, 3]     # 1: seen, integrates 0
    assert pmeta["attr_patterns"] == [3]
    want = _totals(_drive(make_ref(), blocks))
    port_base = _totals(_drive(make_port(), blocks))
    for make in (make_port, make_ref):
        for d in ("p", "r"):
            pipe = make()
            assert pipe.restore(tmp_path / d) == 2
            got = _totals(_drive(pipe, blocks[2:]))
            assert _rel(got, want) <= E_TOL, (make, d)
            if make is make_port and d == "p":
                np.testing.assert_array_equal(got, port_base)


def test_dark_row_at_checkpoint_is_not_reseeded_in_either_package(tmp_path):
    """Property of the reference, kept on both sides: the ingest stage's
    ``_unseeded`` is not saved, so a row still dark at the checkpoint is
    not reseeded after a restore: its first real sample closes an
    interval from the masked placeholder, and the resumed run differs
    from the uninterrupted one, the same way in both packages."""
    make_port, make_ref = _pipes([1, 1], (True, True))
    blocks = _blocks(dark_until=2)
    base = {}
    resumed = {}
    for name, make in (("port", make_port), ("ref", make_ref)):
        base[name] = _totals(_drive(make(), blocks))
        d = tmp_path / name
        _drive(make(), blocks[:2]).checkpoint(d)
        pipe = make()
        pipe.restore(d)
        assert pipe.ingest._unseeded is None
        resumed[name] = _totals(_drive(pipe, blocks[2:]))
    assert _rel(base["port"], base["ref"]) <= E_TOL
    assert _rel(resumed["port"], resumed["ref"]) <= E_TOL
    # the live row is untouched; the dark row's device gains the
    # placeholder-to-first-sample interval
    np.testing.assert_array_equal(resumed["port"][0], base["port"][0])
    assert resumed["port"][1, 0] > base["port"][1, 0] + 0.5
