from repro_torch.train.optim import (  # noqa: F401
    adamw_init, adamw_update, OptConfig)
from repro_torch.train.loop import (  # noqa: F401
    TrainState, make_train_step, train_loop)
