"""xoroshiro64** RNG and Thomas Wang hash, bit-exact with steeljax.core.rng.

Port of steeljax/core/rng.py:19-89 (Random.glsl:9-56, RayGen.rgen:37-50).
PyTorch has no `<<`/`>>` for uint32 on the CPU, so every 32-bit word is
carried in an int64 tensor holding a value in [0, 2^32) and masked back to
32 bits after each operation that can leave that range.  Shifts, xors and
ors of such values are exact in int64.

State is an explicit `(..., 2)` int64 tensor threaded functionally: every
draw returns `(value, new_state)`.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779BB


def _rotl(x: torch.Tensor, k: int) -> torch.Tensor:
    return ((x << k) | (x >> (32 - k))) & _MASK


def wang_hash(x: torch.Tensor) -> torch.Tensor:
    """Thomas Wang 32-bit integer hash (Random.glsl:49-57).  `x` holds
    values in [0, 2^32); returns int64 in the same range."""
    x = x.to(torch.int64) & _MASK
    x = (x ^ 61) ^ (x >> 16)
    x = (x + (x << 3)) & _MASK
    x = x ^ (x >> 4)
    # < 2^32 * 2^30: exact in int64.
    x = (x * 0x27D4EB2D) & _MASK
    x = x ^ (x >> 15)
    return x


def rand_uint32(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One xoroshiro64** step (Random.glsl:16-25).

    `state` is (..., 2) int64; returns (result (...,), new_state (..., 2))."""
    s0 = state[..., 0]
    s1 = state[..., 1]
    # s0 * 0x9E3779BB can reach 2^64 and wrap past int64's sign bit.  int64
    # multiplication wraps modulo 2^64, so the low 32 bits — all the mask
    # keeps — are those of the exact uint32 product.
    result = (_rotl((s0 * _GOLDEN) & _MASK, 5) * 5) & _MASK
    s1 = s1 ^ s0
    s0 = _rotl(s0, 26) ^ s1 ^ ((s1 << 9) & _MASK)
    s1 = _rotl(s1, 13)
    return result, torch.stack([s0, s1], dim=-1)


def next_float(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniform float in [0, 1) via the mantissa trick (Random.glsl:27-31):
    the bits 0x3F800000 | (r >> 9) reinterpreted as float32, minus 1."""
    bits, state = rand_uint32(state)
    word = (0x3F800000 | (bits >> 9)).to(torch.int32)  # < 2^31: exact
    return word.view(torch.float32) - 1.0, state


def next_vec2(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    a, state = next_float(state)
    b, state = next_float(state)
    return torch.stack([a, b], dim=-1), state


def next_vec3(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    a, state = next_float(state)
    b, state = next_float(state)
    c, state = next_float(state)
    return torch.stack([a, b, c], dim=-1), state


def seed_word(sample_index: int, accumulation_index: int) -> int:
    """The 32-bit word whose hash seeds s1 (RayGen.rgen:43-44): the sample
    index shifted left by 8, or'ed with the accumulation index."""
    return ((((int(sample_index) & _MASK) << 8) & _MASK)
            | (int(accumulation_index) & _MASK))


def make_seed(pixel_x: torch.Tensor, pixel_y: torch.Tensor,
              sample_index: int = 0, accumulation_index: int = 0, *,
              word: torch.Tensor | None = None) -> torch.Tensor:
    """Per-pixel stream seed (RayGen.rgen:37-50).

    s0 hashes the pixel id, s1 hashes (sample, accumulation) indices; one
    warm-up step mixes the state exactly as the reference's `Rand(seed)`
    call.  `word`, a 0-d int64 tensor on the pixels' device holding
    seed_word(sample_index, accumulation_index), stands in for the two
    indices: a frame replayed as a CUDA graph reads it from the device, so
    the indices are not baked into the graph.  Returns (N, 2) int64 on the
    pixels' device, the same bits either way."""
    px = pixel_x.to(torch.int64) & _MASK
    py = pixel_y.to(torch.int64) & _MASK
    s0 = ((px << 16) & _MASK) | py
    if word is None:
        s1 = torch.full_like(s0, seed_word(sample_index, accumulation_index))
    else:
        s1 = word.expand_as(s0)
    state = torch.stack([wang_hash(s0), wang_hash(s1)], dim=-1)
    _, state = rand_uint32(state)
    return state
