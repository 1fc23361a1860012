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


def refuse_unported(entry: str, *, interpret=None, use_kernel=None):
    """Raise ``NotImplementedError`` naming every option ``entry`` was
    given that the port does not run: Pallas ``interpret=True`` and the
    kernel-free ``use_kernel=False``.  The defaults (None, and True for
    ``use_kernel``) pass."""
    todo = [name for name, given in (
        ("interpret=True", bool(interpret)),
        ("use_kernel=False", use_kernel is False)) if given]
    if todo:
        raise NotImplementedError(
            f"repro_torch's {entry} does not support " + ", ".join(todo)
            + " yet")


def refuse_detached(kernel: str, *tensors, item: str):
    """Raise ``NotImplementedError`` naming ROADMAP ``item`` when autograd
    is recording and one of ``tensors`` requires a gradient: a ctypes
    kernel's output carries no ``grad_fn``, so launching it then would cut
    the graph silently (the parameters behind it would get no gradient).
    Each kernel wrapper without a backward calls it before it launches."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise NotImplementedError(
            f"repro_torch's {kernel} kernel has no backward yet: its "
            f"result would carry no gradient (ROADMAP {item})")


def wait(device) -> None:
    """Block the host until ``device`` has finished its queued work (the
    counterpart of ``jax.block_until_ready``); nothing to wait for on the
    CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
