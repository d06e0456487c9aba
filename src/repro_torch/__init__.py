"""repro_torch — the PyTorch/CUDA port of ``repro`` (FedGenGMM).

It mirrors ``src/repro`` file for file, imports neither JAX nor ``repro``,
and runs on ``cuda`` unless a caller asks for ``device="cpu"``. The three
Pallas TPU kernels are hand-written CUDA kernels for Hopper in
``repro_torch.kernels``. The public surface is ``repro_torch.api``.
"""
