from .optimizers import (adam_init, adam_update, lr_schedule,  # noqa: F401
                         momentum_init, momentum_update, sgd_update)
