"""GPU compute primitives: GF(2^8) arithmetic, bit-matrix lowering, RS kernels."""

from chubaofs_tpu_torch.ops import gf256
from chubaofs_tpu_torch.ops import bitmatrix

__all__ = ["gf256", "bitmatrix"]
