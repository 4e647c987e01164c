from .optimizers import get_optimizer, set_learning_rate
from .schedulers import get_scheduler

__all__ = ["get_optimizer", "set_learning_rate", "get_scheduler"]
