"""Console — the web dashboard (console/ analog)."""

from chubaofs_tpu_torch.console.server import Console

__all__ = ["Console"]
