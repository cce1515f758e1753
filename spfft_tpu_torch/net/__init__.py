"""Real wire transport for the pod: framed TCP RPC, host agents and
the remote blob artifact tier (the port of ``spfft_tpu/net``).

``serve.cluster`` defines the host boundary (the ``HostLane`` seam)
against an in-process ``LoopbackTransport``; this package is the same
seam crossed by a real socket:

* :mod:`~spfft_tpu_torch.net.frame` — the framed protocol
  (length-prefixed, versioned header, typed JSON records, npz array
  payloads) plus the wire forms of ``PlanSignature``,
  ``obs.TraceContext`` and the typed error taxonomy; the JAX package's
  wire format.
* :mod:`~spfft_tpu_torch.net.membership` — leases, epoch fencing and
  the coordinator election.
* :mod:`~spfft_tpu_torch.net.transport` — :class:`TcpTransport` (the
  client stub behind the ``cluster.rpc`` fault seam, measuring
  round-trip latency into ``load_score``) and :class:`TcpHostLane`, the
  drop-in remote twin of ``serve.cluster.HostLane``.
* :mod:`~spfft_tpu_torch.net.agent` — ``HostAgent``, the server side
  (``python -m spfft_tpu_torch.net.agent``) fronting a local
  ``ServeExecutor`` on the card.
* :mod:`~spfft_tpu_torch.net.blobstore` — the object-store-shaped byte
  transport below the disk tier of ``PlanArtifactStore``.
* :mod:`~spfft_tpu_torch.net.smoke` — the multi-process localhost pod
  (``python -m spfft_tpu_torch.net.smoke``).
"""

from .blobstore import (BlobStore, FileBlobStore, HttpBlobStore,
                        gc_blobstore, open_blobstore, serve_blobstore)
from .frame import (FRAME_VERSION, error_from_wire, error_to_wire,
                    pack_values, recv_frame, send_frame,
                    signature_from_wire, signature_to_wire,
                    unpack_tensors, unpack_values)
from .transport import TcpHostLane, TcpTransport

__all__ = ["BlobStore", "FileBlobStore", "HttpBlobStore", "gc_blobstore",
           "open_blobstore", "serve_blobstore",
           "FRAME_VERSION", "error_from_wire", "error_to_wire",
           "pack_values", "recv_frame", "send_frame", "signature_from_wire",
           "signature_to_wire", "unpack_tensors", "unpack_values",
           "TcpHostLane", "TcpTransport"]
