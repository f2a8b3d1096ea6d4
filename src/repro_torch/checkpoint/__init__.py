"""The port's checkpoints (ROADMAP queue 1 item 13d), on the reference's
on-disk layout."""
from .ckpt import (latest_step, restore_checkpoint,  # noqa: F401
                   save_checkpoint)
