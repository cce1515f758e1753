"""The remote artifact tier (the part of ``spfft_tpu/net/`` a single
host's serving layer needs): :mod:`~spfft_tpu_torch.net.blobstore`, the
object-store-shaped byte transport below the disk tier of
``PlanArtifactStore``. The pod's wire transport (frames, membership,
host agents) is not in this package yet."""

from .blobstore import (BlobStore, FileBlobStore, HttpBlobStore,
                        gc_blobstore, open_blobstore, serve_blobstore)

__all__ = ["BlobStore", "FileBlobStore", "HttpBlobStore", "gc_blobstore",
           "open_blobstore", "serve_blobstore"]
