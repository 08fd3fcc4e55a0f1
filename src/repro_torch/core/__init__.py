"""Posit arithmetic core: the paper's contribution as torch modules."""
from repro_torch.core.array import (PositArray, PositConfigMismatchError,
                                    is_posit, result_cfg)
from repro_torch.core.types import (P8_0, P8_2, P16_1, P16_2, P32_2, STANDARD,
                                    PositConfig, table2_grid)
from repro_torch.core.decode import decode, decode_to_f32
from repro_torch.core.encode import encode_fir, to_storage
from repro_torch.core.ops import (pabs, padd, pdiv, peq, pfma, plt, pmul, pneg,
                                  precip, psub)
from repro_torch.core.convert import (bf16_to_posit, f32_to_posit,
                                      posit_to_bf16, posit_to_f32)
from repro_torch.core.packing import lanes, pack_words, packed_map, unpack_words
from repro_torch.core.quire import quire_dot, quire_matmul

__all__ = [
    "PositArray", "PositConfigMismatchError", "is_posit", "result_cfg",
    "PositConfig", "P8_0", "P8_2", "P16_1", "P16_2", "P32_2", "STANDARD",
    "table2_grid", "decode", "decode_to_f32", "encode_fir", "to_storage",
    "padd", "psub", "pmul", "pdiv", "pfma", "pneg", "pabs", "precip",
    "plt", "peq", "f32_to_posit", "posit_to_f32", "bf16_to_posit",
    "posit_to_bf16", "pack_words", "unpack_words", "packed_map", "lanes",
    "quire_dot", "quire_matmul",
]
