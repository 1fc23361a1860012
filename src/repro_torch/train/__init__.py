"""Training-side utilities of the port (``repro.train``); so far the
checkpoint format that the windowed pipeline's ``checkpoint``/``restore``
write through."""
from repro_torch.train.checkpoint import (checkpoint_meta,  # noqa: F401
                                          latest_step, restore_checkpoint,
                                          save_checkpoint)
