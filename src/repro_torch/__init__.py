"""PyTorch/CUDA port of the MHLJ random-walk decentralized-learning system.

A second package beside the JAX reference ``repro``: same module paths,
PyTorch idiom (plain functions on tensors, an explicit ``device=``, an
explicit ``torch.Generator``), and hand-written CUDA kernels for Hopper in
place of the reference's Pallas TPU kernels.  It imports neither ``jax``
nor anything of ``repro``.  Entry points default to ``device="cuda"``.

Ported so far: the ragged MHLJ walk-SGD path — graphs, chain-law rows,
the ragged engine with its CUDA ``walk_transition_ragged`` kernel, the
fleet and the regression trainer.
"""
