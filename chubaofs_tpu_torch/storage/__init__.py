"""Extent storage engine (storage/ analog)."""

from chubaofs_tpu_torch.storage.extent_store import (  # noqa: F401
    BLOCK_SIZE, BrokenExtent, ExtentExists, ExtentNotFound, ExtentStore,
    MIN_NORMAL_EXTENT_ID, PAGE_SIZE, StorageError,
)
