"""repro_torch: the PyTorch/CUDA port of the F3AST reproduction.

A package of its own beside the JAX package ``repro``, which stays the
reference: it imports ``torch`` and ``numpy`` only.  Entry points run on
CUDA unless the caller passes ``device="cpu"``; the round's selection and
aggregation steps are hand-written CUDA kernels (``repro_torch.kernels``)
with plain PyTorch versions for the CPU.

    from repro_torch.sim import RunSpec, run_spec
    result = run_spec(RunSpec())            # the default F3AST cell on CUDA

The model zoo serves llama3.2-1b (dense) and mamba2-2.7b (ssm) through
``repro_torch.launch.serve``; their prefills run hand-written CUDA
kernels too (``kernels/flash_attention``, ``kernels/ssd_chunk``).
"""
__version__ = "0.1.0"
