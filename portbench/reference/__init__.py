"""The plain reference: the models of `configs/` in plain PyTorch, float32
with TF32 off, written from the published descriptions and the port's
stated conventions.  It imports neither `jax`, nor `repro`, nor anything
of `repro_torch`, and reads no tensor that the program made."""
