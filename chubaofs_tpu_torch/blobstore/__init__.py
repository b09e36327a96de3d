"""The erasure-coded blob store: access gateway, clustermgr, blobnode, proxy,
scheduler and the in-process MiniCluster that wires them, over the port's
CodecService (codec/service.py) on the CUDA device. The HTTP face
(blobstore/gateway.py, with rpc/) is not part of the port yet."""
