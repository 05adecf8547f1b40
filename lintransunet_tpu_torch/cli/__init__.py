"""Command-line entry points: ``train3d``, ``inference_embed_attn``,
``split_dataset`` and ``postprocess`` (the binary CLIs), and their shared
plumbing in ``common``."""
