"""OpenGraphGym-MG in PyTorch for NVIDIA Hopper: a port of the JAX package
``repro`` that stays beside it as the reference.

This slice serves dense-representation MVC solves: structure2vec policy
evaluation (``core.s2v``, ``core.qmodel``, ``core.policy``), the adaptive
top-d solve (``core.inference``, ``core.engine``) and the batched solver
service (``serving``), with the fused S2V layer as a hand-written CUDA
kernel (``kernels.s2v_fused``).  Entry points run on ``device="cuda"``
unless the caller asks for the CPU.

The package imports torch and numpy only — never jax, and nothing of
``repro``.
"""
