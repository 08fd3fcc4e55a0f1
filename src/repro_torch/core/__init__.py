"""Posit formats and the float <-> posit codec, as int32 torch ops."""
from repro_torch.core.array import PositArray, PositConfigMismatchError
from repro_torch.core.convert import f32_to_posit, posit_to_f32
from repro_torch.core.decode import decode, decode_to_f32
from repro_torch.core.encode import encode_fir, to_storage
from repro_torch.core.types import (P8_0, P8_2, P16_1, P16_2, P32_2, STANDARD,
                                    PositConfig)

__all__ = [
    "PositArray", "PositConfigMismatchError", "PositConfig", "P8_0", "P8_2",
    "P16_1", "P16_2", "P32_2", "STANDARD", "decode", "decode_to_f32",
    "encode_fir", "to_storage", "f32_to_posit", "posit_to_f32",
]
