"""The seeded random chain of the JAX package's sampling, in PyTorch.

The port's own copy of what ``ganq_tpu`` draws from ``jax.random``: a key is
a threefry2x32 key, two 32-bit words held in an int64 tensor [2]; ``split``
and ``random_bits`` hash a counter with it in JAX's partitionable layout
(``jax_threefry_partitionable``, on by default since JAX 0.5: counter i of
a flat index is the word pair (i >> 32, i & 0xffffffff), a split's new keys
are both output words, random bits the XOR of the two); ``uniform`` sets the
mantissa from the top bits; ``gumbel`` and ``categorical`` are the
Gumbel-max draw. Keys, bits and uniforms equal JAX's bit for bit
(``tests/test_torch_prng.py``); ``-log(-log(u))`` may differ from XLA's in
the last bit, so a categorical draw can differ only where two candidates
tie within that.

The words live in int64 tensors masked to 32 bits, so every op runs on the
CPU or the card with no unsigned type and no host sync.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash (20 rounds) of the counter words (x1, x2) under
    key (k1, k2); int64 tensors holding 32-bit words, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _M32
    return x[0], x[1]


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the key words [hi, lo], as JAX without
    64-bit types (its default, as ``ganq_tpu`` runs) makes them: the seed
    modulo 2^32 as the low word, a zero high word (with 64-bit types JAX
    puts ``seed >> 32`` there)."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def _counters(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _M32


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)``: new keys [n, 2]."""
    hi, lo = _counters(n, key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([b1, b2], dim=1)


def _shape(shape: Union[int, Sequence[int]]) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def random_bits(key: torch.Tensor, shape, bit_width: int = 32
                ) -> torch.Tensor:
    """``jax.random.bits``: words of ``bit_width`` (8, 16 or 32) bits as
    int64 [shape], counter i at flat index i."""
    shape = _shape(shape)
    n = 1
    for d in shape:
        n *= d
    hi, lo = _counters(n, key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return ((b1 ^ b2) & ((1 << bit_width) - 1)).reshape(shape)


_FLOAT_BITS = {torch.float32: (32, 23, torch.int32),
               torch.bfloat16: (16, 7, torch.int16),
               torch.float16: (16, 10, torch.int16)}


def uniform(key: torch.Tensor, shape, dtype: torch.dtype = torch.float32,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform``: the top mantissa bits of random words under
    exponent 0 give a float in [1, 2); minus 1, times (maxval - minval),
    plus minval, and at least minval. XLA fuses the product and the sum
    into one rounding in float32 and float16 (done here in float64, where
    the product is exact) and rounds each in bfloat16."""
    nbits, nmant, itype = _FLOAT_BITS[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    bits = random_bits(key, shape, rng_bits)
    one = 0x3F800000 if nbits == 32 else (0x3F80 if dtype == torch.bfloat16
                                          else 0x3C00)
    fbits = (bits >> (rng_bits - nmant)) | one
    if nbits == 16:          # to the signed type of the same bits
        fbits = fbits - ((fbits >> 15) << 16)
    floats = fbits.to(itype).view(dtype) - torch.ones((), dtype=dtype,
                                                      device=key.device)
    lo = torch.tensor(minval, dtype=dtype, device=key.device)
    hi = torch.tensor(maxval, dtype=dtype, device=key.device)
    if dtype == torch.bfloat16:
        return torch.maximum(lo, floats * (hi - lo) + lo)
    wide = floats.double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, wide.to(dtype))


def gumbel(key: torch.Tensor, shape, dtype: torch.dtype = torch.float32
           ) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low"): ``-log(-log(u))`` of uniforms in
    [tiny, 1)."""
    u = uniform(key, shape, dtype, torch.finfo(dtype).tiny, 1.0)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``: the Gumbel-max draw
    over the last axis, the noise in the logits' type at the logits'
    shape (counter i at flat index i)."""
    g = gumbel(key, tuple(logits.shape), logits.dtype)
    return torch.argmax(g + logits, dim=-1)


__all__ = ["prng_key", "split", "random_bits", "uniform", "gumbel",
           "categorical", "threefry2x32"]
