from repro_torch.kernels.power_reconstruct.kernel import (  # noqa: F401
    power_reconstruct_fleet_kernel, power_reconstruct_kernel,
    power_reconstruct_rows_kernel)
from repro_torch.kernels.power_reconstruct.ops import (  # noqa: F401
    reconstruct_power)
