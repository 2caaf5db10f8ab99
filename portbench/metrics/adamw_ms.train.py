"""Device ms a step of the kernels that `optim.optimizer.adamw_update`
launched (it runs outside autograd).  Moves train_tokens_per_s."""
from portbench.metrics._common import forward_ms

SPANS = {"adamw_update": "repro_torch.optim.optimizer:adamw_update"}


def read(ctx):
    return forward_ms(ctx, ("adamw_update",), "stretch_steps")
