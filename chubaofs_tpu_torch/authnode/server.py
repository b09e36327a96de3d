"""AuthNode: ticket-granting service over a raft-replicated keystore.

Reference counterpart: authnode/api_service.go:37-114 (getTicket — the
Kerberos-ish flow: client proves key possession, authnode returns a session
key + a ticket sealed under the SERVICE's key carrying identity +
capabilities + expiry), authnode/keystore_fsm.go (raft-replicated keystore:
create/get/delete keys, capability grants), util/cryptoutil for the AEAD.

Flow (mirrors the reference's message shapes):
  1. client -> AuthNode: {client_id, service_id, verifier=HMAC(client_key, ts)}
  2. AuthNode verifies the verifier against the stored client key, mints a
     session key, returns:
       - sealed-for-client: {session_key, ticket} under client_key
       - the ticket itself is sealed under service_key:
         {client_id, session_key, caps, exp}
  3. client presents the ticket to the service; the service opens it with its
     own key and honors caps until exp. The service never talks to authnode.
"""

from __future__ import annotations

import base64
import fnmatch
import json
import time

from chubaofs_tpu_torch.raft.server import MultiRaft, StateMachine
from chubaofs_tpu_torch.utils import cryptoutil

AUTH_GROUP = 2  # master owns raft group 1; the auth keystore rides group 2

TICKET_TTL = 3600.0


class AuthError(Exception):
    pass


class TicketError(AuthError):
    pass


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s.encode())


class KeystoreSM(StateMachine):
    """Raft-replicated keystore (authnode/keystore_fsm.go analog).

    Entries: id -> {key: b64, role: client|service, caps: [pattern...]}.
    Caps are "service:action" patterns granted to CLIENT entries and stamped
    into tickets."""

    def __init__(self):
        self.keys: dict[str, dict] = {}

    def apply(self, data, index: int):
        """Errors travel as ("err", msg) values, never exceptions — a raise
        here would kill the shared raft apply pump and poison WAL replay
        (same contract as MasterSM.apply)."""
        try:
            return ("ok", self._apply(data))
        except AuthError as e:
            return ("err", str(e))

    def _apply(self, data):
        op = data["op"]
        if op == "create_key":
            entry_id = data["id"]
            if entry_id in self.keys:
                raise AuthError(f"key {entry_id!r} exists")
            self.keys[entry_id] = {"key": data["key"], "role": data["role"],
                                   "caps": data.get("caps", [])}
            return entry_id
        if op == "delete_key":
            if data["id"] not in self.keys:
                raise AuthError(f"no key {data['id']!r}")
            del self.keys[data["id"]]
            return data["id"]
        if op == "add_caps":
            ent = self.keys.get(data["id"])
            if ent is None:
                raise AuthError(f"no key {data['id']!r}")
            ent["caps"] = sorted(set(ent["caps"]) | set(data["caps"]))
            return ent["caps"]
        raise AuthError(f"unknown keystore op {op!r}")

    def snapshot(self) -> bytes:
        return json.dumps(self.keys).encode()

    def restore(self, data: bytes) -> None:
        self.keys = json.loads(data.decode())

    def get(self, entry_id: str) -> dict:
        ent = self.keys.get(entry_id)
        if ent is None:
            raise AuthError(f"no key {entry_id!r}")
        return ent


class AuthNode:
    """One authnode replica: keystore ops route through raft; ticket grants
    are leader-local reads + crypto."""

    def __init__(self, raft: MultiRaft, sm: KeystoreSM):
        self.raft = raft
        self.sm = sm

    def _apply(self, **data):
        # rides raft group commit: concurrent keystore admins coalesce into
        # shared WAL-flush + replication rounds on AUTH_GROUP
        status, result = self.raft.propose(AUTH_GROUP, data).result(timeout=5.0)
        if status == "err":
            raise AuthError(result)
        return result

    def _apply_batch(self, datas: list[dict], timeout: float = 5.0) -> list:
        """Many keystore ops in ONE drained raft batch; each fails alone."""
        out = []
        for fut in self.raft.propose_batch(AUTH_GROUP, datas):
            status, result = fut.result(timeout=timeout)
            if status == "err":
                raise AuthError(result)
            out.append(result)
        return out

    def create_keys(self, entries: list[tuple[str, str]]) -> dict[str, bytes]:
        """Bootstrap helper: mint several (id, role) keys in one raft commit
        round (cluster bring-up creates client+service keys together)."""
        keys = {eid: cryptoutil.gen_key() for eid, _ in entries}
        self._apply_batch([
            {"op": "create_key", "id": eid, "key": _b64(keys[eid]),
             "role": role, "caps": []}
            for eid, role in entries])
        return keys

    # -- keystore admin ----------------------------------------------------------

    def create_key(self, entry_id: str, role: str, caps: list[str] | None = None,
                   key: bytes | None = None) -> bytes:
        key = key or cryptoutil.gen_key()
        self._apply(op="create_key", id=entry_id, key=_b64(key), role=role,
                    caps=caps or [])
        return key

    def delete_key(self, entry_id: str) -> None:
        self._apply(op="delete_key", id=entry_id)

    def add_caps(self, entry_id: str, caps: list[str]) -> list[str]:
        return self._apply(op="add_caps", id=entry_id, caps=caps)

    # -- ticket grant (api_service.go:37 getTicket) ------------------------------

    def get_ticket(self, client_id: str, service_id: str, verifier: str,
                   ts: float) -> dict:
        """verifier = b64(HMAC(client_key, f"{client_id}:{service_id}:{ts}"))."""
        if abs(time.time() - ts) > 300:
            raise TicketError("request timestamp outside replay window")
        client = self.sm.get(client_id)
        service = self.sm.get(service_id)
        if service["role"] != "service":
            raise TicketError(f"{service_id!r} is not a service")
        client_key = _unb64(client["key"])
        msg = f"{client_id}:{service_id}:{ts}".encode()
        if not cryptoutil.verify_hmac(client_key, msg, _unb64(verifier)):
            raise TicketError("client verifier mismatch")

        session_key = cryptoutil.gen_key()
        now = time.time()
        caps = [c for c in client["caps"]
                if c.split(":", 1)[0] in ("*", service_id)]
        ticket_plain = json.dumps({
            "client_id": client_id, "session_key": _b64(session_key),
            "caps": caps, "iat": now, "exp": now + TICKET_TTL,
        }).encode()
        ticket = cryptoutil.seal(_unb64(service["key"]), ticket_plain,
                                 aad=service_id.encode())
        reply_plain = json.dumps({
            "session_key": _b64(session_key),
            "ticket": _b64(ticket),
            "exp": now + TICKET_TTL,
        }).encode()
        return {"sealed": _b64(cryptoutil.seal(client_key, reply_plain,
                                               aad=client_id.encode()))}


def verify_ticket(service_id: str, service_key: bytes, ticket_b64: str,
                  action: str | None = None) -> dict:
    """Service side: open + validate a ticket, optionally demanding a cap
    ("service:action" pattern match). Returns the ticket claims."""
    try:
        plain = cryptoutil.open_sealed(service_key, _unb64(ticket_b64),
                                       aad=service_id.encode())
    except cryptoutil.AuthTagError:
        raise TicketError("ticket seal invalid") from None
    claims = json.loads(plain.decode())
    if claims["exp"] < time.time():
        raise TicketError("ticket expired")
    if action is not None:
        want = f"{service_id}:{action}"
        if not any(fnmatch.fnmatchcase(want, pat) or pat == "*"
                   for pat in claims["caps"]):
            raise TicketError(f"capability {want!r} not granted")
    return claims


class RenewingTicket:
    """Callable ticket provider with expiry-aware renewal.

    Daemons hold CLIENT CREDENTIALS, never a static ticket: a ticket is
    TTL'd (TICKET_TTL), so anything long-running must re-acquire before
    expiry or the cluster goes read-only an hour after boot. refresh()
    drops the cache (callers invoke it when the server answers denied —
    e.g. after an authnode-side capability change)."""

    def __init__(self, auth_client: "AuthClient", service_id: str,
                 margin: float = 300.0):
        import threading

        self.auth = auth_client
        self.service_id = service_id
        self.margin = margin
        self._grant: dict | None = None
        self._lock = threading.Lock()

    def __call__(self) -> str:
        with self._lock:
            if (self._grant is None
                    or time.time() > self._grant["exp"] - self.margin):
                self._grant = self.auth.get_ticket(self.service_id)
            return self._grant["ticket"]

    def refresh(self) -> None:
        with self._lock:
            self._grant = None


class AuthClient:
    """Client-side ticket acquisition (sdk/auth analog)."""

    def __init__(self, authnode: AuthNode, client_id: str, client_key: bytes):
        self.authnode = authnode
        self.client_id = client_id
        self.client_key = client_key

    def get_ticket(self, service_id: str) -> dict:
        ts = time.time()
        msg = f"{self.client_id}:{service_id}:{ts}".encode()
        verifier = _b64(cryptoutil.hmac_sha256(self.client_key, msg))
        reply = self.authnode.get_ticket(self.client_id, service_id, verifier, ts)
        plain = cryptoutil.open_sealed(self.client_key, _unb64(reply["sealed"]),
                                       aad=self.client_id.encode())
        return json.loads(plain.decode())
