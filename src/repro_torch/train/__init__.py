"""The port's step builders and training loop (ROADMAP queue 1 items 13
and 13d), ``repro.train`` on torch."""
from .step import make_serve_step, make_train_step  # noqa: F401
from .loop import TrainLoopConfig, train_loop  # noqa: F401
