"""The pod's framed wire protocol (the port of
``spfft_tpu/net/frame.py``, its wire format unchanged: a frame written
by either package decodes in the other to the same header and arrays).

One frame carries one typed record each way:

.. code-block:: text

    +-------+---------+------------+-------------+--------+---------+
    | MAGIC | VERSION | HEADER_LEN | PAYLOAD_LEN | HEADER | PAYLOAD |
    |  4 B  |   1 B   |  4 B (BE)  |  8 B (BE)   |  JSON  |  bytes  |
    +-------+---------+------------+-------------+--------+---------+

The header is a JSON object whose ``"type"`` field names the record
(``submit``/``signals``/``plan``/... requests, ``result``/``*_ok``/
``error`` responses); the payload is opaque bytes — for transform
values an ``np.savez`` archive (:func:`pack_values` /
:func:`unpack_values`), empty otherwise. Anything malformed — bad
magic, version skew, truncated read, non-JSON header — raises the
typed, transient :class:`~spfft_tpu_torch.errors.NetProtocolError`; the
transport translates it into the ``HostLaneError`` the frontend's
route-around handling keys on.

Cross-host identity rides the header: ``PlanSignature`` as its
``dataclasses.asdict`` form (all plain str/int fields — JSON
round-trips it exactly), ``obs.TraceContext`` as its ``to_wire`` dict
(one trace id end-to-end), and failures as ``{"type": "error",
"error_type": <class name>, "message": ...}`` records that
:func:`error_from_wire` maps back onto the typed taxonomy — a remote
``QueueFullError`` re-raises as ``QueueFullError``, never as a string.

Fault sites: ``net.frame`` fires on each encode/decode, ``net.send``
on the socket send, ``net.recv`` on every socket read (a firing check
is a dropped or truncated frame mid-flight).

**Authentication.** The version byte is the negotiation seam: when
``SPFFT_TPU_NET_SECRET`` is set, frames go out as version 2 with a
32-byte HMAC-SHA256 over header+payload keyed by the shared secret,
inserted between the preamble and the header. A receiver rejects any
mismatch — an authenticated frame it cannot verify, an authenticated
frame when it holds no secret, or a plaintext frame when it requires
auth — with the typed PERMANENT
:class:`~spfft_tpu_torch.errors.NetAuthError` at the door (retrying with
the same secret can never succeed). Unknown versions stay
:class:`NetProtocolError` (protocol skew, transient).

**Tensors.** :func:`pack_values` takes numpy arrays and torch tensors
alike; a tensor on the card is moved to the host explicitly
(``.cpu()``) before it is archived. :func:`unpack_values` gives numpy
arrays, as the JAX package's does; :func:`unpack_tensors` gives the
same values as CPU tensors (``torch.from_numpy``), which is what a
remote lane returns and what an agent hands its plans. A ``single``
value is one array (a local plan's values or space, or a distributed
plan's stacked ``(S, ...)`` layout); a ``list`` is one array per shard
(the JAX pod's distributed form, which the port's plans take too).
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac as _hmac
import io
import json
import os
import struct
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import faults as _faults
from .. import obs as _obs
from ..errors import GenericError, NetAuthError, NetProtocolError
from ..serve.registry import PlanSignature

MAGIC = b"SPFN"
FRAME_VERSION = 1
#: The authenticated protocol: preamble carries version 2 and a
#: 32-byte HMAC-SHA256(secret, header+payload) precedes the header.
FRAME_VERSION_AUTH = 2

#: Env var holding the pod's shared wire secret; empty/unset = the
#: plaintext version-1 protocol.
NET_SECRET_ENV = "SPFFT_TPU_NET_SECRET"

_MAC_BYTES = 32
_UNSET = object()

#: Preamble layout: magic, version, header length, payload length.
_PREAMBLE = struct.Struct(">4sBIQ")

#: Sanity caps a hostile/corrupt preamble cannot exceed (a truncated
#: length field must reject, not allocate gigabytes).
MAX_HEADER_BYTES = 1 << 22
MAX_PAYLOAD_BYTES = 1 << 33

_RECV_CHUNK = 1 << 16


def net_secret() -> Optional[bytes]:
    """The process's shared wire secret (``SPFFT_TPU_NET_SECRET``),
    or None for the plaintext protocol."""
    raw = os.environ.get(NET_SECRET_ENV, "")
    return raw.encode("utf-8") if raw else None


def _frame_mac(secret: bytes, hbytes: bytes, payload: bytes) -> bytes:
    mac = _hmac.new(secret, hbytes, hashlib.sha256)
    mac.update(payload)
    return mac.digest()


def send_frame(sock, header: dict, payload: bytes = b"",
               secret=_UNSET) -> None:
    """Encode and send one frame. Socket errors propagate as
    ``OSError`` (the transport classifies them); a header that cannot
    serialize is a :class:`NetProtocolError`. With a shared secret
    (``secret=`` override, else ``SPFFT_TPU_NET_SECRET``) the frame
    goes out authenticated as version 2."""
    _faults.check_site("net.frame")
    if secret is _UNSET:
        secret = net_secret()
    try:
        hbytes = json.dumps(header).encode("utf-8")
    except (TypeError, ValueError) as exc:
        raise NetProtocolError(
            f"frame header is not JSON-serializable: {exc}") from exc
    if secret:
        data = b"".join([
            _PREAMBLE.pack(MAGIC, FRAME_VERSION_AUTH, len(hbytes),
                           len(payload)),
            _frame_mac(secret, hbytes, payload), hbytes, payload])
    else:
        data = b"".join([
            _PREAMBLE.pack(MAGIC, FRAME_VERSION, len(hbytes),
                           len(payload)),
            hbytes, payload])
    _faults.check_site("net.send")
    sock.sendall(data)
    _obs.GLOBAL_COUNTERS.inc("spfft_net_frames_total", dir="send")
    _obs.GLOBAL_COUNTERS.inc("spfft_net_bytes_total", len(data),
                             dir="send")


def _recv_exact(sock, n: int, what: str) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        _faults.check_site("net.recv")
        chunk = sock.recv(min(_RECV_CHUNK, n - len(buf)))
        if not chunk:
            raise NetProtocolError(
                f"connection closed mid-frame reading {what} "
                f"({len(buf)}/{n} bytes)")
        buf.extend(chunk)
    return bytes(buf)


def recv_frame(sock, eof_ok: bool = False, secret=_UNSET,
               on_header: Optional[Callable[[dict], None]] = None
               ) -> Optional[Tuple[dict, bytes]]:
    """Receive one frame: ``(header, payload)``. A clean EOF before the
    first byte returns None when ``eof_ok`` (the agent's
    end-of-connection); everything else malformed raises
    :class:`NetProtocolError`. Authentication mismatches — see the
    module docstring — raise the permanent :class:`NetAuthError`.

    ``on_header`` is called with the header, when it parses as a JSON
    object, before the payload is read (how an agent learns that a
    large request is on its way). The header is not authenticated yet
    at that point, so the callback may only take hints from it: the
    frame can still fail, and the caller handles that."""
    _faults.check_site("net.recv")
    first = sock.recv(1)
    if not first:
        if eof_ok:
            return None
        raise NetProtocolError("connection closed before a frame")
    pre = first + _recv_exact(sock, _PREAMBLE.size - 1,
                              "frame preamble")
    magic, version, hlen, plen = _PREAMBLE.unpack(pre)
    if magic != MAGIC:
        raise NetProtocolError(f"bad frame magic {magic!r}")
    if version not in (FRAME_VERSION, FRAME_VERSION_AUTH):
        raise NetProtocolError(
            f"frame version {version} != {FRAME_VERSION} (protocol "
            f"skew across the pod)")
    if hlen > MAX_HEADER_BYTES or plen > MAX_PAYLOAD_BYTES:
        raise NetProtocolError(
            f"frame lengths implausible (header {hlen}, payload "
            f"{plen})")
    if secret is _UNSET:
        secret = net_secret()
    mac = None
    if version == FRAME_VERSION_AUTH:
        mac = _recv_exact(sock, _MAC_BYTES, "frame mac")
    hbytes = _recv_exact(sock, hlen, "frame header")
    if on_header is not None:
        try:
            early = json.loads(hbytes)
        except ValueError:
            early = None
        if isinstance(early, dict):
            on_header(early)
    payload = _recv_exact(sock, plen, "frame payload") if plen else b""
    if version == FRAME_VERSION_AUTH:
        if not secret:
            raise NetAuthError(
                "peer sent an authenticated frame but this endpoint "
                "holds no SPFFT_TPU_NET_SECRET")
        if not _hmac.compare_digest(
                mac, _frame_mac(secret, hbytes, payload)):
            raise NetAuthError(
                "frame HMAC does not verify — shared-secret mismatch "
                "across the pod")
    elif secret:
        raise NetAuthError(
            "peer sent a plaintext frame but this endpoint requires "
            "authentication (SPFFT_TPU_NET_SECRET is set)")
    _faults.check_site("net.frame")
    try:
        header = json.loads(hbytes)
    except ValueError as exc:
        raise NetProtocolError(
            f"frame header is not JSON: {exc}") from exc
    if not isinstance(header, dict) or "type" not in header:
        raise NetProtocolError("frame header lacks a 'type' field")
    _obs.GLOBAL_COUNTERS.inc("spfft_net_frames_total", dir="recv")
    _obs.GLOBAL_COUNTERS.inc("spfft_net_bytes_total",
                             _PREAMBLE.size + hlen + plen, dir="recv")
    return header, payload


# -- array payloads ----------------------------------------------------------
def _host_array(v) -> np.ndarray:
    """One value as a host numpy array: a tensor leaves its device
    through an explicit ``.cpu()``."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def pack_values(values: Union[None, np.ndarray, torch.Tensor, List]
                ) -> Tuple[dict, bytes]:
    """``(meta, payload)`` for a transform's values: a single array or
    tensor, or a list of per-shard ones (distributed requests/results),
    packed as an ``np.savez`` archive. Merge ``meta`` into the frame
    header; :func:`unpack_values` reverses it."""
    if values is None:
        return {"values": "none"}, b""
    buf = io.BytesIO()
    if isinstance(values, (list, tuple)):
        arrays = [_host_array(v) for v in values]
        np.savez(buf, **{f"a{i}": a for i, a in enumerate(arrays)})
        return {"values": "list", "n": len(arrays)}, buf.getvalue()
    np.savez(buf, a0=_host_array(values))
    return {"values": "single", "n": 1}, buf.getvalue()


def unpack_values(meta: dict, payload: bytes):
    """The values packed by :func:`pack_values`, or raise the typed
    :class:`NetProtocolError` when the archive does not decode."""
    kind = meta.get("values", "none")
    if kind == "none":
        return None
    if kind not in ("single", "list"):
        raise NetProtocolError(f"unknown values kind {kind!r}")
    try:
        with np.load(io.BytesIO(payload), allow_pickle=False) as z:
            arrays = [np.asarray(z[f"a{i}"])
                      for i in range(int(meta.get("n", 1)))]
    except Exception as exc:
        raise NetProtocolError(
            f"array payload failed to decode: {exc!r}") from exc
    return arrays if kind == "list" else arrays[0]


def unpack_tensors(meta: dict, payload: bytes):
    """:func:`unpack_values` as CPU tensors (a list stays a list)."""
    values = unpack_values(meta, payload)
    if values is None:
        return None
    if isinstance(values, list):
        return [torch.from_numpy(a) for a in values]
    return torch.from_numpy(values)


# -- signatures --------------------------------------------------------------
def signature_to_wire(sig: PlanSignature) -> dict:
    """``PlanSignature`` -> plain dict (all fields str/int, so JSON
    round-trips it losslessly)."""
    return dataclasses.asdict(sig)


def signature_from_wire(payload: dict) -> PlanSignature:
    try:
        return PlanSignature(**payload)
    except TypeError as exc:
        raise NetProtocolError(
            f"malformed wire signature: {exc}") from exc


# -- typed errors over the wire ----------------------------------------------
#: Non-package types :func:`error_from_wire` restores exactly — the
#: request-shaped builtins ``faults.REQUEST_ERROR_TYPES`` classifies.
_WIRE_BUILTINS = {t.__name__: t for t in
                  (TypeError, ValueError, IndexError, KeyError,
                   TimeoutError)}


def error_to_wire(exc: BaseException) -> dict:
    """The error-record header for one failure (the agent's reply when
    a handler raises)."""
    return {"type": "error", "error_type": type(exc).__name__,
            "message": str(exc)}


def error_from_wire(header: dict) -> BaseException:
    """An exception INSTANCE for an error record, mapped back onto the
    typed taxonomy: an ``errors.py`` class by name, a request-shaped
    builtin, or ``GenericError`` for anything unknown (still typed —
    a remote failure never surfaces as a bare string or a raw
    foreign type)."""
    from .. import errors as _errors
    name = str(header.get("error_type", ""))
    message = str(header.get("message", ""))
    cls = getattr(_errors, name, None)
    if cls is None:
        cls = getattr(_faults, name, None)
    if isinstance(cls, type) and issubclass(cls, GenericError):
        try:
            return cls(message)
        except Exception:  # an exotic constructor signature
            return GenericError(f"{name}: {message}")
    if name in _WIRE_BUILTINS:
        return _WIRE_BUILTINS[name](message)
    return GenericError(f"remote {name or 'failure'}: {message}")
