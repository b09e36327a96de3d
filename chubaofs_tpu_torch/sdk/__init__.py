"""Client SDKs: metadata wrapper, filesystem facade (reference sdk/ equivalent)."""

from chubaofs_tpu_torch.sdk.meta_wrapper import MetaWrapper
from chubaofs_tpu_torch.sdk.fs import FsClient, FsError

__all__ = ["MetaWrapper", "FsClient", "FsError"]
