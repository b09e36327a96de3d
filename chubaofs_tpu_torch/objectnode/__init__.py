"""ObjectNode — S3-compatible gateway over the file/metadata cluster.

Reference: objectnode/ (router.go, api_handler_object.go, fs_volume.go,
auth_signature_v2/v4.go, policy/acl/cors/tagging engines).
"""

from chubaofs_tpu_torch.objectnode.server import ObjectNode, S3Error

__all__ = ["ObjectNode", "S3Error"]
