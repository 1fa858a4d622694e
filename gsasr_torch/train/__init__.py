from gsasr_torch.train.schedules import multistep_warmup_schedule
from gsasr_torch.train.trainer import TrainConfig, Trainer

__all__ = ["Trainer", "TrainConfig", "multistep_warmup_schedule"]
