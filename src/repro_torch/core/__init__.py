"""The port's copy of the reference's host-side core: sensor specs, the
ground-truth power model, the seeded sensor simulator and node fabric,
counter unwrap and dE/dt, calibration corrections, the region tracer and
per-phase attribution.  Host numpy throughout; the batched device paths
live in ``repro_torch.fleet`` and ``repro_torch.align``."""
from repro_torch.core.measurement_model import (SensorSpec,  # noqa: F401
                                                ToolSpec,
                                                default_node_sensors,
                                                expected_lag_s)
from repro_torch.core.power_model import (PiecewisePower,  # noqa: F401
                                          occupancy_power, phase_power,
                                          square_wave)
from repro_torch.core.sensors import (NodeFabric, SensorTrace,  # noqa
                                      simulate_sensor)
from repro_torch.core.reconstruction import (PowerSeries,  # noqa: F401
                                             delta_e_over_delta_t,
                                             power_trace_series,
                                             unwrap_counter)
from repro_torch.core.calibration import (Corrections,  # noqa: F401
                                          apply_corrections,
                                          estimate_static_offsets,
                                          estimate_upstream_slope,
                                          nic_rail_corrections)
from repro_torch.core.tracing import RegionEvent, RegionTracer  # noqa
from repro_torch.core.attribution import (PhaseEnergy,  # noqa: F401
                                          attribute_energy,
                                          attribute_energy_many,
                                          split_energy_savings)
