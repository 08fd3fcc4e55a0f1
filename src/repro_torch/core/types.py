"""Posit format descriptors (paper §III): Posit<N, ES>.

Pure metadata, a copy of ``repro/core/types.py`` so that the port never
imports the JAX package.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PositConfig:
    """Static description of a Posit<N, ES> format.

    n:  total width in bits; es: maximum exponent field width in bits.
    """

    n: int
    es: int

    def __post_init__(self) -> None:
        if not (2 <= self.n <= 32):
            raise ValueError(f"posit width must be in [2, 32], got {self.n}")
        if not (0 <= self.es <= 6):
            raise ValueError(f"posit es must be in [0, 6], got {self.es}")

    @property
    def mask(self) -> int:
        return (1 << self.n) - 1

    @property
    def sign_bit(self) -> int:
        return 1 << (self.n - 1)

    @property
    def nar(self) -> int:
        """Not-a-Real: 1000...0."""
        return 1 << (self.n - 1)

    @property
    def useed_exp(self) -> int:
        return 1 << self.es

    @property
    def k_max(self) -> int:
        return self.n - 2

    @property
    def k_min(self) -> int:
        """Minimum regime of a nonzero posit (minpos = useed^(2-N))."""
        return -(self.n - 2)

    @property
    def te_max(self) -> int:
        return self.k_max * self.useed_exp

    @property
    def te_min(self) -> int:
        return self.k_min * self.useed_exp

    @property
    def max_frac_bits(self) -> int:
        return max(0, self.n - 3 - self.es)

    @property
    def maxpos_bits(self) -> int:
        return self.mask >> 1

    @property
    def one_bits(self) -> int:
        return 1 << (self.n - 2)

    @property
    def minpos_bits(self) -> int:
        return 1

    @property
    def storage_bits(self) -> int:
        """Smallest power-of-two container width."""
        for w in (8, 16, 32):
            if self.n <= w:
                return w
        raise AssertionError

    @property
    def storage_dtype_name(self) -> str:
        return f"int{self.storage_bits}"

    def __str__(self) -> str:
        return f"posit{self.n}es{self.es}"


P8_0 = PositConfig(8, 0)
P8_2 = PositConfig(8, 2)
P16_1 = PositConfig(16, 1)
P16_2 = PositConfig(16, 2)
P32_2 = PositConfig(32, 2)

STANDARD = {8: P8_2, 16: P16_2, 32: P32_2}


def table2_grid() -> tuple[PositConfig, ...]:
    """The <N, ES> grid of the paper's Table II (division accuracy)."""
    return (tuple(PositConfig(8, es) for es in range(0, 5))
            + tuple(PositConfig(16, es) for es in range(0, 4)))
