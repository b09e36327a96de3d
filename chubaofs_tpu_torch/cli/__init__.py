"""cfs-cli — operator CLI against the master admin API (cli/ analog), and
the blobstore admin CLI (`python -m chubaofs_tpu_torch.cli.blobstore`)."""

from chubaofs_tpu_torch.cli.main import main

__all__ = ["main"]
