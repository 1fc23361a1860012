"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Without one the caller must ask for the
    CPU explicitly: an entry point never drops to it quietly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels")
        return torch.device("cuda")
    return torch.device(device)


def refuse_unported(entry: str, *, mesh=None, interpret=None,
                    use_kernel=None, collectives=None, shard=None,
                    item: str = ""):
    """Raise ``NotImplementedError`` naming every option ``entry`` was
    given that the port does not run yet: ``mesh`` sharding, multi-host
    ``collectives``/``shard``, Pallas ``interpret=True`` and the
    kernel-free ``use_kernel=False``; ``item`` names the ROADMAP item
    that ports them.  The defaults (None, and True for ``use_kernel``)
    pass."""
    todo = [name for name, given in (
        ("mesh", mesh is not None),
        ("collectives", collectives is not None),
        ("shard", shard is not None),
        ("interpret=True", bool(interpret)),
        ("use_kernel=False", use_kernel is False)) if given]
    if todo:
        raise NotImplementedError(
            f"repro_torch's {entry} does not support " + ", ".join(todo)
            + " yet" + (f" (ROADMAP {item})" if item else ""))


def wait(device) -> None:
    """Block the host until ``device`` has finished its queued work (the
    counterpart of ``jax.block_until_ready``); nothing to wait for on the
    CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
