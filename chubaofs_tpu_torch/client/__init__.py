"""Client layer — the FUSE-facing mount (client/ analog)."""

from chubaofs_tpu_torch.client.mount import Mount, MountError

__all__ = ["Mount", "MountError"]
