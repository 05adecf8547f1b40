"""LinTransUNet in PyTorch for NVIDIA Hopper (H100).

A port of the JAX/TPU package ``lintransunet_tpu``, which stays beside it as
the reference: every module here is checked against its JAX counterpart on
the same inputs and parameters. Activations use the reference's
``(N, C, H, W, D)`` layout and state_dict keys follow the flax module names
(see :mod:`lintransunet_tpu_torch.compat`). The package imports torch,
never jax. Hand-written CUDA kernels (``csrc/``: linear attention and its
backward, the stride-1 conv unit, the transformer stack, and the six TPU
probes' counterparts) run on CUDA tensors and their plain PyTorch versions
on CPU ones.

What it runs, as the JAX package does:

* serving: ``cli.inference_embed_attn`` and ``cli.inference_multi_classes``
  over ``engine.SlidingWindowRunner`` (``cli.common.make_eval_runner``), in
  the default or the fused eval configuration (``fused_s1=True,
  fused_stack=True``);
* training: ``cli.train3d``, ``cli.train3d_multi_class`` and
  ``cli.train3d_monai_version`` over ``engine.make_train_step``, the epoch
  loops, the checkpoints and ``data/``, with the binary and multi-class
  losses, every model of ``models.Model_Dict``, and the "attn" recompute
  policy (``LINTRANSUNET_REMAT=attn``);
* data parallelism over ``torch.distributed`` (``parallel``): every CLI run
  under ``torchrun`` splits its batches or volumes over the ranks;
* the tools: ``cli.split_dataset``, ``cli.postprocess``, ``utils`` (NaN
  guards, profiling), ``compat`` (flax and reference checkpoints) and the
  H100 probes of ``experiments/``.
"""

__version__ = "0.1.0"
