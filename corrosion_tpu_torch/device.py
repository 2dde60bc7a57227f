"""Device resolution and the u32 word carriers.

**Device rule.** Every entry point takes ``device`` (default ``"cuda"``)
and resolves it here: CUDA when a card is present, the CPU only when the
caller asks for it by name.  A missing card raises; nothing drifts to
the CPU on its own.

**Carriers.** The JAX package computes on u32 words.  Torch's CPU
``uint32`` lacks ``>>``, ``<``, ``~``, ``+`` and ``where``, so the port
carries every u32 word in an ``int32`` tensor holding the same 32 bits:

- ``&``, ``|``, ``^``, ``~`` and ``<<`` act on the bits identically;
- a logical right shift is the arithmetic shift masked to the low
  ``32 - k`` bits (`shr`);
- an unsigned compare or max goes through ``int64``;
- popcount is the SWAR reduction (`popcount`), since torch has no
  ``bitwise_count``.

Values that are u32 in JAX but must take part in unsigned arithmetic
(threefry keys and counters, `sim/rng.py`) travel as ``int64`` holding
``[0, 2^32)``, masked with `MASK32` after every operation.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
# the all-ones u32 word in its int32 carrier
ONES = -1


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a `torch.device`, refusing a CUDA request without a
    card (no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain torch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def i32(value: int) -> int:
    """A u32 constant (0 ≤ value < 2^32) as its int32 carrier value."""
    value &= MASK32
    return value - (1 << 32) if value >= 1 << 31 else value


def shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32-carried u32 words by a constant."""
    if k == 0:
        return x
    return (x >> k) & ((1 << (32 - k)) - 1)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-element population count of int32-carried u32 words (int32)."""
    v = x.to(torch.int64) & MASK32  # the words' unsigned values
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & MASK32) >> 24).to(torch.int32)
