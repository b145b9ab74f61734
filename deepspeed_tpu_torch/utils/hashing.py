"""Counter-based hashing in int64 torch ops: the port's own random streams
(on-device sampling, stochastic rounding of bf16 Adam moments), the same
bits on the CPU and the card, where some devices lack uint32 arithmetic.
"""

MASK32 = 0xFFFFFFFF


def mix32(x):
    """A 32-bit integer hash (two multiply-xorshift rounds) of an int64
    tensor of values in [0, 2**32): every product stays below 2**63."""
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & MASK32
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & MASK32
    return x ^ (x >> 16)
