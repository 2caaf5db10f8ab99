"""Batched serving example on the PyTorch port: prefill + KV-cache decode
on a reduced Qwen3-14B (`repro_torch.launch.serve`).

    PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]

Runs on the GPU by default; pass `--device cpu` where there is none.
"""
import argparse

from repro_torch.launch import serve

p = argparse.ArgumentParser()
p.add_argument("--device", default="cuda")
args = p.parse_args()

serve.main(["--arch", "qwen3-14b", "--reduced", "--batch", "4",
            "--prompt-len", "32", "--gen", "16", "--device", args.device])
