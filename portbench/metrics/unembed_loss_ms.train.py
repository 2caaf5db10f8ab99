"""Device ms a step of `models.layers.unembed` and `layers.cross_entropy`,
forward and backward (the backward nodes joined to their forward ops by
sequence number).  Left out where the join finds no backward.  Moves
train_tokens_per_s."""
SPANS = {"unembed": "repro_torch.models.layers:unembed",
         "cross_entropy": "repro_torch.models.layers:cross_entropy"}


def read(ctx):
    red, n = ctx["reduced"], ctx.get("stretch_steps")
    if not n or not all(red.backward_joined.get(k) for k in SPANS):
        return None
    us = sum(s.device_us for s in red.spans if s.label in SPANS)
    us += sum(red.backward_us.get(k, 0.0) for k in SPANS)
    return us / 1e3 / n if us > 0 else None
