"""One driver a kind of traffic: `train` (training steps back to back) and
`serve` (an open loop of prompt batches).  Each has `run(run) -> Outcome`."""
