"""OpenGraphGym-MG in PyTorch for NVIDIA Hopper: a port of the JAX package
``repro`` that stays beside it as the reference.

It serves MVC solves on the dense, padded-sparse and CSR representations,
on one device or on a ``(data, graph)`` mesh: structure2vec policy
evaluation (``core.s2v``, ``core.qmodel``, ``core.policy``), the adaptive
top-d solve (``core.inference``, ``core.engine``) and the batched solver
service (``serving``).  It trains MVC policies on the dense representation
on one device through the fused train step (``core.engine``,
``core.training``, ``optim``).  Every TPU kernel of the JAX package has a
hand-written CUDA counterpart (``kernels``).  Entry points run on
``device="cuda"`` unless the caller asks for the CPU.

The package imports torch and numpy only — never jax, and nothing of
``repro``.
"""
