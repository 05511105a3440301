"""Bind on PyTorch and CUDA — the port of the ``repro`` package.

The package mirrors ``repro`` module by module (``repro_torch.core.plan``
ports ``repro.core.plan``, and so on).  Workflow payloads that were
``jax.Array`` become ``torch.Tensor``; NumPy payloads stay NumPy and are
never promoted.  Every kernel the reference wrote in Pallas for the TPU is a
kernel written by hand for Hopper (``sm_90a``) under ``repro_torch.kernels``.

The package imports ``torch`` and ``numpy`` only — never ``jax`` and never
any module of ``repro``.  Its entry points run on the GPU unless the caller
asks for the CPU (``device="cpu"``).
"""
