"""Training (``repro.train``): the train step (``loop``), the optimizers
and schedules (``optimizer``), the instrumented loop with its per-phase
attribution (``instrumented``) and the checkpoint format, which the
windowed pipeline's ``checkpoint``/``restore`` also write through."""
from repro_torch.train.checkpoint import (checkpoint_meta,  # noqa: F401
                                          latest_step, restore_checkpoint,
                                          save_checkpoint)
