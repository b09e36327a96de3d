"""The port's benchmark: cells of blobstore traffic through the HTTP gateway."""
