"""Training of the port: the step (loss, grads, AdamW) and the
checkpointed, restartable ``Trainer``."""
from repro_torch.train.step import make_train_step  # noqa: F401
from repro_torch.train.trainer import Trainer, Watchdog  # noqa: F401
