"""Two-stage Shopformer training: optimizers and schedules, the trainer."""

from cvsd_tpu_torch.train.optim import EarlyStopping, build_optimizer, build_schedule  # noqa: F401
from cvsd_tpu_torch.train.loop import Trainer, train_from_config  # noqa: F401
