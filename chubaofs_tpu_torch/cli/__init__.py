"""Operator CLIs: the blobstore admin CLI (`python -m
chubaofs_tpu_torch.cli.blobstore`). The master CLI waits for master/."""
