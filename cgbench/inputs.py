"""What the benchmark makes from ``--seed`` and hands to both the program and the
reference: the right-hand side b."""

from __future__ import annotations

import torch

DTYPES = {"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16}


def right_hand_side(shape: tuple, seed: int, dtype: torch.dtype, device,
                    spec: dict) -> torch.Tensor:
    """b, a field of ``shape`` (the problem's) drawn on ``device`` in ``dtype`` by a
    generator on that device seeded with ``seed`` (taken modulo 2**64, so any whole number
    serves): the same seed gives the same b on every card of a kind.  ``spec`` is the
    traffic's ``b``: a normal distribution with its mean and standard deviation."""
    if spec["distribution"] != "normal":
        raise ValueError(f"b's distribution must be 'normal', got {spec['distribution']!r}")
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 64)
    b = torch.randn(tuple(shape), generator=gen, dtype=dtype, device=device)
    return b.mul_(spec["std"]).add_(spec["mean"])
