"""Fused wrapped dE/dt + per-phase integration on raw counter chunks."""
from repro_torch.kernels.fleet_attribute.kernel import (  # noqa: F401
    fleet_attribute_kernel)
from repro_torch.kernels.fleet_attribute.ops import fleet_attribute  # noqa
from repro_torch.kernels.fleet_attribute.ref import (  # noqa: F401
    fleet_attribute_ref)
