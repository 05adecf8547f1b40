"""The plain reference of the benchmark's configurations: each model's
forward, the sliding-window blend and the training micro-step, in plain
PyTorch (f32 with TF32 off). It imports nothing of the measured package or
of JAX; the benchmark hands it the same weights and inputs as the program."""
