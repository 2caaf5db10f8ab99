"""``python -m repro_torch.sweep`` — see repro_torch/sweep_cli.py."""

from repro_torch.sweep_cli import main

if __name__ == "__main__":
    main()
