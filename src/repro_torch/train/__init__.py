"""The training runtime of the port: the reference's ``train/`` (the loop,
atomic checkpoints with auto-resume, preemption and straggler hooks)."""
from .loop import TrainConfig, make_train_step, run_training  # noqa: F401
from . import checkpoint, fault  # noqa: F401
