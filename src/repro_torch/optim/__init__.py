"""The port's optimizer (ROADMAP queue 1 item 13d): AdamW with global-norm
clipping, the cosine schedule and int8 gradient compression, copies of
``repro.optim`` on torch."""
from .adamw import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from .schedule import cosine_schedule  # noqa: F401
