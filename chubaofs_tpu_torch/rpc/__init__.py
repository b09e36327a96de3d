"""HTTP RPC framework (blobstore/common/rpc analog).

Router + typed errors + server + middleware (auditlog, shared-secret auth,
crc-protected bodies) + a small retrying client. Serves every HTTP surface in
the framework: blobstore gateways, objectnode S3, authnode, console, master
admin API.
"""

from chubaofs_tpu_torch.rpc.errors import HTTPError, err_response
from chubaofs_tpu_torch.rpc.router import Request, Response, Router
from chubaofs_tpu_torch.rpc.server import RPCServer
from chubaofs_tpu_torch.rpc.client import RPCClient
from chubaofs_tpu_torch.rpc.pool import ConnectionPool, NullPool, default_pool

__all__ = ["HTTPError", "err_response", "Request", "Response", "Router",
           "RPCServer", "RPCClient", "ConnectionPool", "NullPool",
           "default_pool"]
