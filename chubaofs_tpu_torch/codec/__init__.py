"""The erasure-codec API layer — equivalent of reference blobstore/common/ec + codemode."""

from chubaofs_tpu_torch.codec.codemode import CodeMode, Tactic, get_tactic
from chubaofs_tpu_torch.codec.encoder import (
    Encoder,
    LrcEncoder,
    RsEncoder,
    new_encoder,
    EncoderConfig,
)

__all__ = [
    "CodeMode",
    "Tactic",
    "get_tactic",
    "Encoder",
    "RsEncoder",
    "LrcEncoder",
    "new_encoder",
    "EncoderConfig",
]
