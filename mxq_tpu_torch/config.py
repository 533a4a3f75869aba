"""Single typed configuration for the MXQ quantization scheme (a copy of
``mxq_tpu.config``, which the port may not import).

The reference hardcodes the scheme constants (64-column blocks, ratio_2b = 6/8,
group size 16, double-quant group 16, 4-bit scale codes) as duplicated literals in
three places (LLM-QAT/models/utils_quant.py:340-343, mxq_quant/lib/mxqgpt.py:404-406,
mxq_quant/cuda_kernel/csrc/quantization/gemv_mxq_cuda.cu:45-55). Here ONE dataclass
owns them, and is consumed by the packer and the kernels alike.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MXQConfig:
    """The MXQ mixed 2/4-bit numerical scheme.

    Weights are processed per output row in blocks of ``block`` input columns.
    The first ``num_2b = block * ratio_2b_num / ratio_2b_den`` columns of each
    block are quantized asymmetrically at ``bits_lo`` bits in groups of
    ``group``; the remaining columns of every block are gathered per-row into
    one matrix and quantized with a single per-row asymmetric scale/zero at
    ``bits_hi`` bits (reference: utils_quant.py:340-385, mxqgpt.py:404-443).

    PTQ additionally double-quantizes the 2-bit groups' scales: the fp scales
    are themselves quantized to ``qq_scale_bits`` bits asymmetrically in groups
    of ``qq_group`` consecutive output rows (reference: mxqgpt.py:425,434 with
    mechanism at quantizer.py:114-121).
    """

    block: int = 64          # columns per block (utils_quant.py:349)
    group: int = 16          # 2-bit group size within a block (utils_quant.py:340)
    ratio_2b_num: int = 6    # ratio_2b = 6/8 (utils_quant.py:342, mxqgpt.py:404)
    ratio_2b_den: int = 8
    bits_lo: int = 2         # bit-width of the grouped (low) part
    bits_hi: int = 4         # bit-width of the gathered rowwise (high) part

    # Double quantization of the 2-bit groups' scales (PTQ + packed format).
    qq_scale_bits: int = 4   # mxqgpt.py:425 (Quantizer.configure qq_scale_bits=4)
    qq_group: int = 16       # quantizer.py:41 (qq_groupsize default 16)

    # Straight-through-estimator clip range for QAT (utils_quant.py:636).
    ste_clip: float = 2.0

    # eps used in the two fake-quant formulations.
    qat_eps: float = 1e-8    # utils_quant.py:456 (alpha + 1e-8)
    ptq_eps: float = 1e-9    # quantizer.py:5 (scale.clamp_min(eps))

    @property
    def num_2b(self) -> int:
        """Number of bits_lo columns per block (48 for the default scheme)."""
        return self.block * self.ratio_2b_num // self.ratio_2b_den

    @property
    def num_4b(self) -> int:
        """Number of bits_hi columns per block (16 for the default scheme)."""
        return self.block - self.num_2b

    @property
    def groups_per_block(self) -> int:
        """2-bit groups per block (3 for the default scheme)."""
        return self.num_2b // self.group

    @property
    def maxq_lo(self) -> int:
        return 2**self.bits_lo - 1

    @property
    def maxq_hi(self) -> int:
        return 2**self.bits_hi - 1

    @property
    def maxq_qq(self) -> int:
        return 2**self.qq_scale_bits - 1

    def validate(self) -> None:
        if self.num_2b % self.group or self.num_2b + self.num_4b != self.block:
            raise ValueError(f"inconsistent MXQ scheme: {self}")

    def effective_bits(self, in_features: int, out_features: int) -> float:
        """Effective stored bits/weight of the packed format (~2.9 for default)."""
        k, n = in_features, out_features
        k2 = k * self.num_2b // self.block
        k4 = k - k2
        g2 = k2 // self.group
        bits = 0
        bits += k2 * n * self.bits_lo            # 2b codes
        bits += k4 * n * self.bits_hi            # 4b codes
        bits += g2 * n * self.bits_lo            # first-order zero codes (2b)
        bits += g2 * n * self.qq_scale_bits      # first-order scale codes (4b)
        bits += g2 * (n // self.qq_group) * 32   # second-order scales fp32
        bits += g2 * (n // self.qq_group) * 8    # second-order zero codes (int8 held)
        bits += n * self.bits_hi * 2             # 4b-part scale codes + zero codes
        bits += (n // self.qq_group) * 40        # 4b-part qq scale fp32 + zero code
        return bits / (k * n)


@dataclasses.dataclass(frozen=True)
class QuantizeLinearConfig:
    """Per-linear quantization switches, mirroring the reference's
    QuantizeLinear(w_bits, a_bits) (utils_quant.py:601-625)."""

    w_bits: int = 32          # <32 and >=2 -> MXQ scheme fake-quant
    a_bits: int = 32          # 2 < a_bits < 32 -> activation fake-quant
    a_symmetric: bool = True  # SymQuantizer vs AsymQuantizer (utils_quant.py:622-626)
    a_groupsize_sym: int = 128   # utils_quant.py:57
    a_groupsize_asym: int = 8    # utils_quant.py:134
    weight_layerwise: bool = False
    act_layerwise: bool = False
    scheme: MXQConfig = dataclasses.field(default_factory=MXQConfig)


@dataclasses.dataclass(frozen=True)
class KVQuantConfig:
    """KV-cache quantization (modeling_llama_quant.py:251-255,323-329)."""

    kv_bits: int = 32         # <32 -> symmetric fake-quant of K and V
    groupsize: int = 128      # SymQuantizer group size over the feature dim


DEFAULT_SCHEME = MXQConfig()
DEFAULT_SCHEME.validate()
