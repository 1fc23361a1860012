from repro_torch.kernels.power_reconstruct.kernel import (  # noqa: F401
    power_reconstruct_rows_kernel)
