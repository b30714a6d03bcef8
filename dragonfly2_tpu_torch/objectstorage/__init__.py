"""Unified object-storage client (ref pkg/objectstorage: objectstorage.go:65-105
s3.go/oss.go/obs.go) — bucket + object CRUD, metadata, and presigned-style
source URLs behind one interface, with a filesystem backend for clusters
without S3-compatible storage (and for tests). The port of
dragonfly2_tpu/objectstorage/."""

from dragonfly2_tpu_torch.objectstorage.backend import (
    Bucket,
    LocalFSBackend,
    OBSBackend,
    ObjectMetadata,
    ObjectStorageBackend,
    ObjectStorageError,
    OSSBackend,
    S3Backend,
    new_backend,
)

__all__ = [
    "Bucket",
    "LocalFSBackend",
    "OBSBackend",
    "ObjectMetadata",
    "ObjectStorageBackend",
    "ObjectStorageError",
    "OSSBackend",
    "S3Backend",
    "new_backend",
]
