"""PyTorch port, import boundary: ``repro_torch`` loads with JAX and every
module of the reference package blocked, its sources name neither, and
its entry points never drop quietly to the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.device import resolve_device

SRC = Path(__file__).resolve().parent.parent / "src"
PORT = SRC / "repro_torch"

_BLOCKED_IMPORT = r'''
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "repro")

class Block:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in BLOCKED:          # exact top-level name: not repro_torch
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("imported", len(names))
'''


def test_port_imports_with_jax_and_repro_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], capture_output=True,
        text=True, timeout=120, env={"PYTHONPATH": str(SRC),
                                     "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


_CASE_STUDY_MODULES = ("repro_torch.core.tracing",
                       "repro_torch.core.calibration",
                       "repro_torch.core.attribution",
                       "repro_torch.kernels.squarewave",
                       "repro_torch.kernels.squarewave.ops",
                       "repro_torch.hpl", "repro_torch.hpl.hpl",
                       "repro_torch.hpl.hpl_mxp", "repro_torch.hpl.hpg_mxp",
                       "repro_torch.hpl.energy")


@pytest.mark.parametrize("module", _CASE_STUDY_MODULES)
def test_case_study_module_imports_with_jax_and_repro_blocked(module):
    """Each module of the §V-B case study loads on its own with JAX and
    the reference blocked."""
    code = _BLOCKED_IMPORT.split("import repro_torch")[0] + (
        f"import importlib\nimportlib.import_module({module!r})\n"
        "leaked = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] in BLOCKED)\n"
        "assert not leaked, leaked\n")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr


def test_case_study_entry_points_default_to_cuda(monkeypatch):
    """The §V-B entry points ask for the card without ``device=``; with
    no card they raise instead of running on the CPU."""
    from repro_torch import hpl
    from repro_torch.core import RegionTracer
    from repro_torch.kernels.squarewave import squarewave_load
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tracer = RegionTracer()
    tracer.add_region("hpl_factorize", 0.0, 0.2)
    a = np.eye(4, dtype=np.float32)
    for call in (
            lambda: hpl.make_system(4),
            lambda: hpl.make_dd_system(4),
            lambda: hpl.make_poisson(4),
            lambda: hpl.hpl_solve(a, a[0], nb=2),
            lambda: hpl.hpl_mxp_solve(a, a[0], nb=2),
            lambda: hpl.hpg_solve(np.ones((4, 4, 4), np.float32)),
            lambda: hpl.energize(tracer),
            lambda: hpl.fleet_energize(tracer, 1),
            lambda: hpl.fused_fleet_energize(tracer, 1),
            lambda: hpl.fused_fleet_energize(tracer, 1, streaming=True),
            lambda: hpl.mxp_energy_report(tracer, tracer, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(NotImplementedError, match="interpret=True"):
        squarewave_load(torch.ones(8, 8), fma_chain=2, interpret=True)
    with pytest.raises(NotImplementedError, match="use_kernel=False"):
        squarewave_load(torch.ones(8, 8), fma_chain=2, use_kernel=False)
    with pytest.raises(ValueError, match="shard and collectives"):
        hpl.fused_fleet_energize(tracer, 1, shard=object(), device="cpu")


_SERVE_MODULES = ("repro_torch.configs", "repro_torch.configs.base",
                  "repro_torch.models", "repro_torch.models.layers",
                  "repro_torch.models.mamba",
                  "repro_torch.models.moe", "repro_torch.models.xlstm",
                  "repro_torch.models.transformer",
                  "repro_torch.distributed.decode_attention",
                  "repro_torch.kernels.flash_attention",
                  "repro_torch.kernels.flash_attention.ops",
                  "repro_torch.kernels.ssm_scan",
                  "repro_torch.kernels.ssm_scan.ops",
                  "repro_torch.serve", "repro_torch.serve.engine",
                  "repro_torch.serve.loadgen", "repro_torch.serve.metering",
                  "repro_torch.launch.serve", "repro_torch.interop")


@pytest.mark.parametrize("module", _SERVE_MODULES)
def test_serve_module_imports_with_jax_and_repro_blocked(module):
    """Each module of the serving path loads on its own with JAX and the
    reference blocked (the configs are the port's own copy)."""
    test_case_study_module_imports_with_jax_and_repro_blocked(module)


def test_serve_entry_points_default_to_cuda(monkeypatch):
    """The serving path's entry points ask for the card without
    ``device=``; with no card they raise instead of running on the CPU
    (``attribute_requests`` runs where its engine was put), and the
    B9/B10 ops never take their plain version for a tensor that is not
    on the CPU."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.fleet import PipelineConfig, SlotSegment, TrackConfig
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssm_scan import selective_scan
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.serve import serve_traces
    from repro_torch.models import Model
    from repro_torch.serve import FixedBatchEngine, ServeEngine
    model = Model(reduced(get_arch("llama3.2-3b")))
    params = model.init(0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: model.init(0),
                 lambda: model.init_cache(1, 8),
                 lambda: ServeEngine(model, params),
                 lambda: FixedBatchEngine(model, params),
                 lambda: serve_main([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # attribute_requests takes its engine's device: an engine the caller
    # put on the CPU meters there, with no card (a fixed 1 s timeline)
    eng = ServeEngine(model, params, batch_slots=2, max_len=32,
                      device="cpu")
    for name, a, b in (("admission", 0.0, 0.01), ("prefill", 0.01, 0.3),
                       ("decode", 0.3, 1.0)):
        eng.tracer.add_region(name, a, b)
    eng.segments = [SlotSegment(0.0, 0.01, (0,), (1.0,), "admission"),
                    SlotSegment(0.01, 0.3, (0,), (4.0,), "prefill"),
                    SlotSegment(0.3, 1.0, (0, 1), (3.0, 2.0))]
    traces, _, _ = serve_traces(eng.tracer.phases(depth=0), n_chips=1)
    report = eng.attribute_requests(traces, t_shift=0.05, config=(
        PipelineConfig(track=TrackConfig(track=False))))
    assert sorted(r.rid for r in report.requests) == [0, 1]
    q = torch.zeros((1, 2, 8, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q)
    x = torch.zeros((1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        selective_scan(x, x, x[..., :4], x[..., :4], x[0, :, :4],
                       x[:, :, :4])


_CORE_HEALTH_MODULES = ("repro_torch.core.characterization",
                        "repro_torch.core.confidence",
                        "repro_torch.core.aliasing",
                        "repro_torch.core.trace_format",
                        "repro_torch.core.reconstruction",
                        "repro_torch.core.sensors",
                        "repro_torch.align.fusion",
                        "repro_torch.health", "repro_torch.health.events",
                        "repro_torch.health.registry",
                        "repro_torch.health.stage")


@pytest.mark.parametrize("module", _CORE_HEALTH_MODULES)
def test_core_and_health_module_imports_with_jax_and_repro_blocked(module):
    """Each module of the sensor-characterization core and the health
    package loads on its own with JAX and the reference blocked."""
    test_case_study_module_imports_with_jax_and_repro_blocked(module)


def test_health_and_metering_entry_points_default_to_cuda(monkeypatch):
    """The new device-taking entry points ask for the card without
    ``device=``: the stacked node view's chip counters, the health and
    metering stages, the windowed path with health and meter; with no
    card each raises.  ``attribute_requests`` runs on its engine's
    device, and the engine itself refuses to start without a card."""
    from repro_torch.core import (NodeFabric, ToolSpec, square_wave,
                                  stacked_node_power)
    from repro_torch.fleet import (MeteringStage, PipelineConfig,
                                   RegridFuseStage, SlotSegment,
                                   attribute_energy_fused_streaming)
    from repro_torch.health import SensorHealthStage
    truth = square_wave(0.2, 2, lead_s=0.1, tail_s=0.1)
    traces = NodeFabric(chip_truths=[truth]).sample_all(ToolSpec(1e-2))
    grid = np.arange(0.1, 0.5, 0.01)
    host = stacked_node_power(traces, grid, use_fleet=False)
    fuse = RegridFuseStage([2], grid_origin=0.0, grid_step=1e-3,
                           device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert host["components"]
    seg = SlotSegment(0.0, 0.1, (0,), (1.0,))
    for call in (
            lambda: stacked_node_power(traces, grid),
            lambda: SensorHealthStage([2], grid_step=1e-3),
            lambda: MeteringStage([seg], [2], fuse),
            lambda: attribute_energy_fused_streaming(
                [[traces["chip0_energy"]]], [("p", 0.1, 0.4)],
                config=PipelineConfig(health=True)),
            lambda: attribute_energy_fused_streaming(
                [[traces["chip0_energy"]]], [("p", 0.1, 0.4)],
                meter=[seg])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


_CHECKPOINT_INGEST_MODULES = ("repro_torch.train",
                              "repro_torch.train.checkpoint",
                              "repro_torch.ingest",
                              "repro_torch.ingest.backend",
                              "repro_torch.ingest.sim",
                              "repro_torch.ingest.priority",
                              "repro_torch.ingest.async_ingest",
                              "repro_torch.ingest.rapl",
                              "repro_torch.ingest.hwmon",
                              "repro_torch.ingest.rocm",
                              "repro_torch.ingest.live")


@pytest.mark.parametrize("module", _CHECKPOINT_INGEST_MODULES)
def test_checkpoint_and_ingest_module_imports_with_jax_and_repro_blocked(
        module):
    """The checkpoint format and every module of live ingest load on
    their own with JAX and the reference blocked (``repro.ingest`` and
    ``repro.train.checkpoint`` load without JAX; the port keeps its own
    copy all the same)."""
    test_case_study_module_imports_with_jax_and_repro_blocked(module)


def test_port_sources_name_neither_jax_nor_repro():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)|"
                     r"from\s+(jax|repro)(\.|\s)(?!_))", re.M)
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 20
    hits = [f"{p.relative_to(SRC)}: {m.group(0).strip()}"
            for p in files for m in pat.finditer(p.read_text())]
    assert not hits, hits


def test_entry_points_default_to_cuda(monkeypatch):
    """Without ``device=`` the port asks for the card; with no card it
    raises instead of running on the CPU."""
    from repro_torch.fleet import attribute_energy_fused_streaming
    from repro_torch.fleet.pipeline import StreamingFusedPipeline
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingFusedPipeline([2], [(0.0, 1.0)], grid_origin=0.0,
                               grid_step=1e-3, track=False,
                               delays=np.zeros(2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        attribute_energy_fused_streaming([[object()]], [("p", 0.0, 1.0)])
    from repro_torch import align, fleet
    from repro_torch.core import SensorSpec, ToolSpec, simulate_sensor
    from repro_torch.core import square_wave
    truth = square_wave(0.05, 1, lead_s=0.01, tail_s=0.01)
    counter = simulate_sensor(SensorSpec(name="e", scope="chip",
                                         kind="energy_cum", quantum=1e-6),
                              ToolSpec(1e-3), truth, seed=0)
    packed = fleet.pack_traces([counter])
    phases = [("p", 0.0, 0.1)]
    for call in (
            lambda: fleet.fleet_power_series([counter]),
            lambda: fleet.attribute_energy_fleet([counter], phases),
            lambda: fleet.attribute_energy_fused([[counter]], phases),
            lambda: fleet.attribute_energy_fused([[counter]], phases,
                                                 streaming=True),
            lambda: fleet.fleet_reconstruct(packed),
            lambda: fleet.FleetStream([(0.0, 1.0)], 8),
            lambda: fleet.StreamingPhaseAccumulator([(0.0, 1.0)], 8),
            lambda: align.series_rows_from_traces([counter]),
            lambda: align.align_and_fuse([[counter]]),
            lambda: align.validate_streams([[counter]]),
            lambda: align.attribute_energy_fused([[counter]], phases)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")


def test_kernel_build_flags_and_path():
    """The library path is named by a digest of the sources and lies in
    the build directory; the flags keep IEEE arithmetic and sm_90a."""
    from repro_torch.kernels import build
    path = build.library_path()
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libreprotorch_")
    srcs = sorted(p.name for p in build.CSRC.glob("*.cu"))
    assert srcs == ["empty.cu", "flash_attention.cu",
                    "flash_attention_bwd.cu", "fleet_attribute.cu",
                    "grid_resample.cu", "phase_integrate.cu",
                    "power_reconstruct.cu", "power_reconstruct_fleet.cu",
                    "power_reconstruct_rows.cu", "selective_scan.cu",
                    "selective_scan_bwd.cu", "squarewave.cu",
                    "xcorr_align.cu"]
    assert "--use_fast_math" not in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


_MULTIHOST_MODULES = ("repro_torch.distributed",
                      "repro_torch.distributed.multihost",
                      "repro_torch.distributed.compression",
                      "repro_torch.core.reduce")


@pytest.mark.parametrize("module", _MULTIHOST_MODULES)
def test_multihost_module_imports_with_jax_and_repro_blocked(module):
    """The multi-host layer (collectives, reduce frame, the entry) and
    the fixed-order sums load on their own with JAX and the reference
    blocked."""
    test_case_study_module_imports_with_jax_and_repro_blocked(module)


def test_spawned_worker_imports_nothing_of_jax_or_the_reference():
    """A process with JAX and the reference blocked spawns 2 workers;
    each runs a small multi-host attribution and reports the JAX or
    reference modules it holds: none."""
    tests = Path(__file__).resolve().parent
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from repro_torch.distributed.multihost import run_multihost\n"
        "import torch_multihost_workers as w\n"
        "if __name__ == '__main__':\n"
        "    out = run_multihost(w.leaked_imports, 2, timeout_s=150)\n"
        "    assert out == [[], []], out\n"
        "    print('clean')\n")
    env = {"PYTHONPATH": os.pathsep.join([str(tests.parent / "src"),
                                          str(tests)]),
           "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=200, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("clean")


_TRAIN_MODULES = ("repro_torch.data", "repro_torch.data.pipeline",
                  "repro_torch.train", "repro_torch.train.loop",
                  "repro_torch.train.optimizer",
                  "repro_torch.train.instrumented",
                  "repro_torch.distributed.compression",
                  "repro_torch.distributed.fault_tolerance",
                  "repro_torch.launch.train")


@pytest.mark.parametrize("module", _TRAIN_MODULES)
def test_train_module_imports_with_jax_and_repro_blocked(module):
    """Each module of the training path loads on its own with JAX and
    the reference blocked (the data pipeline and fault tolerance are the
    port's own copies, not imports)."""
    test_case_study_module_imports_with_jax_and_repro_blocked(module)


def test_train_entry_points_default_to_cuda(monkeypatch):
    """The training launcher's ``build`` and ``main`` ask for the card
    without a device; with no card they raise instead of training on the
    CPU."""
    from repro_torch.launch.train import build, main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: build("llama3.2-3b"), lambda: main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
