"""The port's copy of the reference's host-side core: sensor specs, the
ground-truth power model, the seeded sensor simulator, counter unwrap,
the reconstructed power series and the per-phase result type."""
from repro_torch.core.measurement_model import (SensorSpec,  # noqa: F401
                                                ToolSpec)
from repro_torch.core.power_model import (PiecewisePower,  # noqa: F401
                                          square_wave)
from repro_torch.core.sensors import SensorTrace, simulate_sensor  # noqa
from repro_torch.core.reconstruction import (PowerSeries,  # noqa: F401
                                             unwrap_counter)
from repro_torch.core.attribution import PhaseEnergy  # noqa: F401
