"""Attention kernels: plain PyTorch oracles (`ref`), the hand-written CUDA
flash-attention forward (`flash_attention`) and the dispatcher (`ops`)."""
