"""LinTransUNet in PyTorch for NVIDIA Hopper (H100).

A port of the JAX/TPU package ``lintransunet_tpu``, which stays beside it as
the reference: every module here is checked against its JAX counterpart on
the same inputs and parameters. Activations use the reference's
``(N, C, H, W, D)`` layout and state_dict keys follow the flax module names
(see :mod:`lintransunet_tpu_torch.compat`). The package imports torch,
never jax. Three hand-written CUDA kernels (``csrc/``: linear attention,
the stride-1 conv unit, the transformer stack) run on CUDA tensors and
their plain PyTorch versions on CPU ones.

Ported so far: the eval serving path, ``MaskTransUnet`` driven by
``SlidingWindowRunner`` (``cli.common.make_eval_runner``), in its default
and its fused eval configuration (``fused_s1=True, fused_stack=True``).
"""

__version__ = "0.1.0"
