"""Wire protocol for the replicated data plane (proto/packet.go analog)."""

from chubaofs_tpu_torch.proto.packet import (  # noqa: F401
    HEADER_SIZE, MAGIC, OP_CREATE_EXTENT, OP_CREATE_PARTITION,
    OP_GET_PARTITION_METRICS, OP_GET_WATERMARKS, OP_HEARTBEAT, OP_MARK_DELETE,
    OP_RANDOM_WRITE, OP_REPAIR_READ, OP_REPAIR_WRITE, OP_STREAM_READ,
    OP_TINY_DELETE_RECORD, OP_WRITE, Packet, ProtoError, RES_AGAIN,
    RES_CRC_MISMATCH, RES_DISK_ERR, RES_ERR, RES_NOT_EXIST, RES_NOT_LEADER,
    RES_OK, TINY_EXTENT_COUNT, TINY_EXTENT_MAX_ID, is_tiny_extent,
    next_req_id, recv_packet, send_packet,
)
