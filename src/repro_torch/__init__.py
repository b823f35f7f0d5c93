"""PyTorch/CUDA port of the MHLJ random-walk decentralized-learning system.

A second package beside the JAX reference ``repro``: same module paths,
PyTorch idiom (plain functions on tensors, an explicit ``device=``, an
explicit ``torch.Generator``), and hand-written CUDA kernels for Hopper in
place of the reference's Pallas TPU kernels.  It imports neither ``jax``
nor anything of ``repro``.  Entry points default to ``device="cuda"``.

Ported so far: the MHLJ walk-SGD path on all four engine layouts — graphs
(dense, CSR, degree-bucketed, ragged), chain-law rows, the engine with its
CUDA kernels ``walk_transition_ragged``, ``walk_transition_sparse`` (also
the bucketed tile op) and ``walk_transition`` (dense), the fleet and the
regression trainer — and LLM inference for the dense (and prefix-LM) and
SSM families: configs, models, ``launch.serve.ServeEngine``, with CUDA
kernels ``flash_attention``, ``ssd_scan`` and ``rmsnorm_fused``.
"""
