"""The port's copy of the reference's host-side core (``repro.core``): sensor
specs, the ground-truth power model, the seeded sensor simulator, fault
injection and node fabric, counter unwrap and dE/dt, blind sensor
characterization, confidence windows (Eq. 1), aliasing analysis,
calibration corrections, the region tracer and live sampler, the
columnar trace store and per-phase attribution.  Host numpy throughout;
the batched device paths live in ``repro_torch.fleet`` and
``repro_torch.align``."""
from repro_torch.core.measurement_model import (SensorSpec,  # noqa: F401
                                                ToolSpec,
                                                default_node_sensors,
                                                expected_lag_s)
from repro_torch.core.power_model import (PiecewisePower,  # noqa: F401
                                          occupancy_power, phase_power,
                                          square_wave)
from repro_torch.core.sensors import (FaultSpec, NodeFabric,  # noqa: F401
                                      SensorTrace, inject_fault,
                                      simulate_sensor)
from repro_torch.core.reconstruction import (PowerSeries,  # noqa: F401
                                             delta_e_over_delta_t,
                                             power_trace_series,
                                             unwrap_counter)
from repro_torch.core.characterization import (  # noqa: F401
    characterize_sensor, step_response, update_intervals)
from repro_torch.core.confidence import (confidence_window,  # noqa: F401
                                         min_attributable_phase_s,
                                         steady_state)
from repro_torch.core.aliasing import (aliasing_sweep,  # noqa: F401
                                       fft_analysis, nyquist_limit_hz,
                                       transition_detection_error)
from repro_torch.core.calibration import (Corrections,  # noqa: F401
                                          apply_corrections,
                                          estimate_static_offsets,
                                          estimate_upstream_slope,
                                          nic_rail_corrections)
from repro_torch.core.tracing import (LiveSampler, RegionEvent,  # noqa
                                      RegionTracer)
from repro_torch.core.trace_format import (load_trace,  # noqa: F401
                                           merge_traces, save_trace)
from repro_torch.core.attribution import (PhaseEnergy,  # noqa: F401
                                          attribute_energy,
                                          attribute_energy_many,
                                          attribute_power_series,
                                          energy_conservation_residual,
                                          split_energy_savings,
                                          stacked_node_power)
