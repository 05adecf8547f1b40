"""Model weights drawn from the run's seed on the card, as a state dict.

The law is flax's default initialisers, which the port's models also use:
every weight of two or more dims a normal of variance 1 / fan_in cut at two
standard deviations (``lecun_normal``), every bias zero, every other
one-dimensional parameter (a LayerNorm's scale) one. All weights come from
one ``trunc_normal_`` call on one flat buffer, so drawing takes a few
launches whatever the model.
"""

import math
from typing import Dict, Sequence, Tuple

import torch

# the std of a standard normal cut at +-2: the cut draw is divided by it so
# that it keeps unit variance (flax's variance_scaling "truncated_normal")
TRUNCATED_STD = 0.87962566103423978


def draw_state(shapes: Sequence[Tuple[str, Tuple[int, ...]]], generator: torch.Generator,
               device) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor on ``device``} for every (name, shape), drawn from
    ``generator`` (a generator on ``device``)."""
    weights = [(name, tuple(shape)) for name, shape in shapes
               if len(shape) > 1 and not name.endswith("bias")]
    sizes = [math.prod(shape) for _, shape in weights]
    flat = torch.empty(sum(sizes), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=generator)
    stds = torch.tensor([1.0 / math.sqrt(n / shape[0]) / TRUNCATED_STD
                         for n, (_, shape) in zip(sizes, weights)], device=device)
    flat.mul_(stds.repeat_interleave(torch.tensor(sizes, device=device)))
    state = {name: part.view(shape)
             for (name, shape), part in zip(weights, flat.split(sizes))}
    for name, shape in shapes:
        if name not in state:
            fill = 0.0 if name.endswith("bias") else 1.0
            state[name] = torch.full(tuple(shape), fill, device=device)
    return state
