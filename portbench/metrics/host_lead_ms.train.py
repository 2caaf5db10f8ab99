"""How far the host leads the device in a training step: at the mark the
port's step records once it has enqueued its last op ("step.enqueued",
`repro_torch.obs`), the device's time reaching that event less the host's
time recording it, on the tracer's shared clock; the median over the
traced run's steps after the profiled stretch.  Near 0: the device waits
on the host's launches; far above: the host is held back by a full
launch queue.  Moves train_tokens_per_s."""
from portbench.metrics import _obs

_obs.turn_on()


def read(ctx):
    return _obs.host_lead_ms(ctx, "step.enqueued", "stretch_steps")
