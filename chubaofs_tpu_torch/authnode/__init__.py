"""AuthNode — Kerberos-like ticket service with a raft-replicated keystore.

Reference: authnode/ (api_service.go:37 getTicket, keystore_fsm.go) +
util/cryptoutil.
"""

from chubaofs_tpu_torch.authnode.server import (
    AUTH_GROUP, AuthClient, AuthNode, KeystoreSM, TicketError,
)

__all__ = ["AuthNode", "AuthClient", "KeystoreSM", "AUTH_GROUP", "TicketError"]
