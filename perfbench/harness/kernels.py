"""Which traced kernels belong to which of the program's kernels, by their
names and order.

A launch of ``fused_int8_ffn`` runs four CUDA kernels on its stream:
``row_quant_kernel``, ``gemm_s8_kernel<1, ...>`` (bias, ReLU),
``row_quant_kernel``, ``gemm_s8_kernel<3, ...>`` (split sum). A launch of
``fused_attn_block`` runs ``row_quant_kernel``, ``gemm_s8_kernel<0, ...>``
(the QKV projection), its attention kernel, ``row_quant_kernel``,
``gemm_s8_kernel<2, ...>`` (output projection and residual). A launch is
the kernels from the ``row_quant_kernel`` before its first GEMM through
its last GEMM (``csrc/ffn.cu``, ``csrc/attn_block.cu``). ``flash_attention``
is one kernel, ``tc_attn_two_pass`` (bf16) or ``attn_kernel`` (fp32).
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple

GEMM = re.compile(r"gemm_s8_kernel<(\d+)")
FFN_EPI = (1, 3)
ATTN_BLOCK_EPI = (0, 2)


def _epi(name: str) -> int:
    m = GEMM.search(name)
    return int(m.group(1)) if m else -1


def launches(kernels: Sequence[Tuple[str, float, float]], epi: Tuple[int, int]) -> List[float]:
    """Device seconds of each launch whose GEMMs carry the epilogues
    ``epi`` (first, last): the durations of its kernels summed."""
    out: List[float] = []
    start = None
    for i, (name, _, _) in enumerate(kernels):
        e = _epi(name)
        if e == epi[0] and start is None:
            start = i - 1 if i > 0 and "row_quant_kernel" in kernels[i - 1][0] else i
        elif e == epi[1] and start is not None:
            out.append(sum(d for _, _, d in kernels[start:i + 1]))
            start = None
    return out


def flash(kernels: Sequence[Tuple[str, float, float]]) -> List[float]:
    return [d for name, _, d in kernels
            if "tc_attn_two_pass" in name or re.search(r"\battn_kernel\b", name)]
