from repro_torch.optim.optimizer import (  # noqa: F401
    AdamWConfig, TrainState, adamw_init, adamw_update, decay_mask,
    global_norm, make_train_step,
)
from repro_torch.optim.schedules import cosine, linear_warmup, wsd  # noqa: F401
