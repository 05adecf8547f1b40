"""H100 counterparts of the JAX package's TPU conv probes (``experiments/``).

One module per TPU probe, named after it without ``pallas_``: each holds a
CUDA kernel's wrapper (sources in ``../csrc/probe_*.cu``), its plain
PyTorch version and a ``main()`` that sweeps the TPU probe's own variants
and shapes on the card::

    python -m lintransunet_tpu_torch.experiments.dot_probe
    python -m lintransunet_tpu_torch.experiments.rowoffset_probe
    python -m lintransunet_tpu_torch.experiments.inner_probe
    python -m lintransunet_tpu_torch.experiments.conv_prototype
    python -m lintransunet_tpu_torch.experiments.conv_retired
    python -m lintransunet_tpu_torch.experiments.in_stats_probe

``--device cpu`` runs the plain version at a reduced size instead. No
model path calls these kernels: they measure the design space of the
conv unit's redesign.
"""
