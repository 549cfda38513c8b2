"""The port's kernels: hand-written CUDA for the card, plain PyTorch
(``ref``) for the CPU."""
