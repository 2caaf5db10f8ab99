"""End-to-end training on the PyTorch port: a ~100M-param TinyLlama-family
model for a few hundred steps on one device, with checkpointing and fault
injection (`repro_torch.launch.train`).

    PYTHONPATH=src python examples/torch_train_100m.py [--steps 300] \
        [--device cpu] [--ckpt-dir runs/ckpt_100m]

Runs on the GPU by default.  A checkpoint directory that holds an
earlier run's checkpoint resumes from it; give a fresh one for a fresh
run.
"""
import argparse
import dataclasses

import repro_torch.configs as configs
from repro_torch.launch import train

p = argparse.ArgumentParser()
p.add_argument("--steps", type=int, default=300)
p.add_argument("--fault-at", type=int, default=None)
p.add_argument("--device", default="cuda")
p.add_argument("--ckpt-dir", default="runs/ckpt_100m")
args = p.parse_args()

# ~100M params: 12 x 768 llama-family with the tinyllama vocab
base = configs.get("tinyllama-1.1b")
cfg = dataclasses.replace(base, name="tinyllama-100m", n_layers=12,
                          d_model=768, n_heads=12, n_kv_heads=4,
                          head_dim=64, d_ff=2048)
print(f"{cfg.name}: {cfg.param_count()/1e6:.1f}M params")

argv = ["--arch", "tinyllama-1.1b", "--steps", str(args.steps),
        "--batch", "8", "--seq", "256", "--ckpt-dir", args.ckpt_dir,
        "--device", args.device]
if args.fault_at is not None:
    argv += ["--fault-at", str(args.fault_at)]

# monkeypatch config resolution so the driver builds the 100M variant
configs_get = configs.get
configs.get = lambda name, reduced=False: cfg  # noqa: E731
try:
    losses = train.main(argv)
finally:
    configs.get = configs_get
assert losses[-1] < losses[0], "loss did not decrease"
print("OK: loss decreased", losses[0], "->", losses[-1])
