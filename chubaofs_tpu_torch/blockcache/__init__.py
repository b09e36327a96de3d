"""Blockcache — node-local read cache daemon over a unix socket.

Reference: blockcache/ (bcache/service.go:132 unix listener, manage.go:130
bcacheManager, bcache/client.go).
"""

from chubaofs_tpu_torch.blockcache.bcache import BcacheClient, BcacheManager, BcacheService

__all__ = ["BcacheClient", "BcacheManager", "BcacheService"]
