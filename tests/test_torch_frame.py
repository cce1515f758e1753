"""The port's framed wire protocol (``spfft_tpu_torch.net.frame``) against
the JAX package's (``spfft_tpu.net.frame``), on the CPU.

The wire format is the JAX package's: a frame written by either package
decodes in the other to the same header and the same arrays (compared
decoded, not byte for byte: ``np.savez`` stamps its zip with the time);
the version-2 HMAC under ``SPFFT_TPU_NET_SECRET`` verifies across the
packages with the same secret, and every mismatch is the same typed
``NetAuthError`` in each; corruption is ``NetProtocolError``;
``error_from_wire`` maps every class as the JAX package's does. Tensors
go on the wire through an explicit ``.cpu()`` and come off it as CPU
tensors (``unpack_tensors``).
"""

import inspect
import json
import os
import socket

import numpy as np
import pytest
import torch

from spfft_tpu import errors as jerrors
from spfft_tpu import faults as jfaults
from spfft_tpu.benchmark import cutoff_stick_triplets as jtriplets
from spfft_tpu.net import frame as jframe
from spfft_tpu.serve.registry import signature_for as jsignature_for
from spfft_tpu.types import TransformType as JTT

import spfft_tpu_torch as sp
from spfft_tpu_torch import errors as terrors
from spfft_tpu_torch import faults, obs
from spfft_tpu_torch.errors import (GenericError, NetAuthError,
                                    NetProtocolError, QueueFullError)
from spfft_tpu_torch.net import frame as tframe
from spfft_tpu_torch.serve.registry import signature_for

PACKAGES = {"torch": tframe, "jax": jframe}
PAIRS = [("torch", "jax"), ("jax", "torch"), ("torch", "torch")]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(tframe.NET_SECRET_ENV, raising=False)
    faults.disarm()
    jfaults.disarm()
    obs.GLOBAL_COUNTERS.reset()
    yield
    faults.disarm()


@pytest.fixture
def pair():
    a, b = socket.socketpair()
    a.settimeout(10)
    b.settimeout(10)
    yield a, b
    a.close()
    b.close()


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_frame_round_trip_with_payload(pair, writer, reader):
    a, b = pair
    payload = os.urandom(4096)
    PACKAGES[writer].send_frame(a, {"type": "ping", "k": [1, 2]}, payload)
    header, got = PACKAGES[reader].recv_frame(b)
    assert header == {"type": "ping", "k": [1, 2]}
    assert got == payload
    if writer == "torch":
        assert obs.GLOBAL_COUNTERS.get("spfft_net_frames_total",
                                       dir="send") == 1


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_values_decode_across_packages(pair, writer, reader):
    """Arrays (single, per-shard list, none) packed by one package
    decode in the other to equal dtypes and values."""
    a, b = pair
    rng = np.random.default_rng(0)
    single = rng.standard_normal(17) + 1j * rng.standard_normal(17)
    many = [rng.standard_normal((5, 2)).astype(np.float32),
            rng.standard_normal(9) + 1j * rng.standard_normal(9)]
    for values in (single, many, None):
        meta, blob = PACKAGES[writer].pack_values(values)
        PACKAGES[writer].send_frame(a, {"type": "result", **meta}, blob)
        header, payload = PACKAGES[reader].recv_frame(b)
        got = PACKAGES[reader].unpack_values(header, payload)
        if values is None:
            assert got is None
            continue
        want = values if isinstance(values, list) else [values]
        got = got if isinstance(got, list) else [got]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_tensors_on_the_wire():
    """A tensor packs as the array it holds (the JAX package decodes it);
    ``unpack_tensors`` gives CPU tensors of the same bits, a list stays a
    list."""
    rng = np.random.default_rng(1)
    t = torch.from_numpy(rng.standard_normal((4, 6, 2)).astype(np.float32))
    meta, blob = tframe.pack_values(t)
    assert meta == {"values": "single", "n": 1}
    assert np.array_equal(jframe.unpack_values(meta, blob), t.numpy())
    back = tframe.unpack_tensors(meta, blob)
    assert isinstance(back, torch.Tensor) and back.device.type == "cpu"
    assert torch.equal(back, t)
    shards = [t[0], torch.view_as_complex(t[1])]
    meta, blob = tframe.pack_values(shards)
    assert meta == {"values": "list", "n": 2}
    back = tframe.unpack_tensors(meta, blob)
    assert isinstance(back, list)
    assert all(torch.equal(g, w) for g, w in zip(back, shards))
    assert tframe.unpack_tensors(*tframe.pack_values(None)) is None


def test_frame_rejects_bad_magic_and_truncation():
    a, b = socket.socketpair()
    try:
        a.sendall(b"NOPE" + b"\x00" * 13)
        a.close()
        with pytest.raises(NetProtocolError):
            tframe.recv_frame(b)
    finally:
        b.close()
    a, b = socket.socketpair()
    try:
        tframe.send_frame(a, {"type": "ping"}, b"full-payload")
        buf = b.recv(1 << 20)
        c, d = socket.socketpair()
        try:
            c.sendall(buf[:-4])  # truncated mid-payload
            c.close()
            with pytest.raises(NetProtocolError):
                tframe.recv_frame(d)
        finally:
            d.close()
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("case", ["version", "header_json", "no_type",
                                  "implausible", "values_kind",
                                  "payload"])
def test_corruption_is_net_protocol_error(pair, case):
    """Every malformed frame or payload is the typed, transient
    ``NetProtocolError`` in both packages alike."""
    a, b = pair
    pre = tframe._PREAMBLE
    if case in ("values_kind", "payload"):
        meta = ({"values": "bogus"} if case == "values_kind"
                else {"values": "single", "n": 1})
        for mod, err in ((tframe, NetProtocolError),
                         (jframe, jerrors.NetProtocolError)):
            with pytest.raises(err):
                mod.unpack_values(meta, b"not an npz archive")
        return
    hbytes = {"header_json": b"{not json",
              "no_type": json.dumps({"k": 1}).encode()}.get(
                  case, b'{"type": "ping"}')
    version = 7 if case == "version" else tframe.FRAME_VERSION
    plen = tframe.MAX_PAYLOAD_BYTES + 1 if case == "implausible" else 0
    a.sendall(pre.pack(tframe.MAGIC, version, len(hbytes), plen) + hbytes)
    with pytest.raises(NetProtocolError):
        tframe.recv_frame(b)


class _Wire:
    """A socket over recorded bytes: ``sendall`` records, ``recv``
    replays and counts what was read."""

    def __init__(self, data=b""):
        self.data = bytearray(data)
        self.read = 0

    def sendall(self, data):
        self.data += data

    def recv(self, n):
        chunk = bytes(self.data[self.read:self.read + n])
        self.read += len(chunk)
        return chunk


@pytest.mark.parametrize("secret", [None, b"s3cret"])
def test_on_header_sees_the_header_before_the_payload(secret):
    """``recv_frame(on_header=...)`` hands over the parsed header once it
    is read and before any payload byte is, on both frame versions; the
    frame then decodes as without the callback."""
    header = {"type": "submit", "kind": "backward"}
    payload = os.urandom(1 << 18)
    sent = _Wire()
    tframe.send_frame(sent, header, payload, secret=secret)
    wire = _Wire(sent.data)
    seen = []
    got = tframe.recv_frame(wire, secret=secret,
                            on_header=lambda h: seen.append((h, wire.read)))
    assert got == (header, payload)
    assert seen == [(header, len(sent.data) - len(payload))]


def test_on_header_skips_a_header_that_is_no_object():
    """A header that is not a JSON object is not handed over, and the
    frame fails as it does without the callback."""
    sent = _Wire()
    tframe.send_frame(sent, {"type": "ping"}, b"x")
    data = bytes(sent.data).replace(b'{"type": "ping"}', b'["type", 1, 234]')
    seen = []
    with pytest.raises(NetProtocolError):
        tframe.recv_frame(_Wire(data), on_header=seen.append)
    assert seen == []


def test_frame_eof_ok_returns_none():
    a, b = socket.socketpair()
    a.close()
    try:
        assert tframe.recv_frame(b, eof_ok=True) is None
    finally:
        b.close()


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_frame_auth_round_trip_and_mismatches(pair, writer, reader):
    """The version-2 HMAC verifies across packages with the same secret;
    a wrong secret, an authenticated frame into a plaintext endpoint and
    a plaintext frame into an authenticated one are each the typed,
    permanent ``NetAuthError`` of the reading package."""
    a, b = pair
    send, recv = PACKAGES[writer].send_frame, PACKAGES[reader].recv_frame
    auth = NetAuthError if reader == "torch" else jerrors.NetAuthError
    secret = b"wire-secret"
    send(a, {"type": "ping"}, b"payload", secret=secret)
    header, payload = recv(b, secret=secret)
    assert header == {"type": "ping"} and payload == b"payload"
    send(a, {"type": "ping"}, b"x", secret=secret)
    with pytest.raises(auth):
        recv(b, secret=b"other-secret")
    send(a, {"type": "ping"}, secret=secret)
    with pytest.raises(auth):
        recv(b, secret=None)
    send(a, {"type": "ping"}, secret=None)
    with pytest.raises(auth):
        recv(b, secret=secret)


def test_secret_comes_from_the_same_variable(pair, monkeypatch):
    a, b = pair
    assert tframe.NET_SECRET_ENV == jframe.NET_SECRET_ENV
    monkeypatch.setenv(tframe.NET_SECRET_ENV, "pod")
    assert tframe.net_secret() == jframe.net_secret() == b"pod"
    tframe.send_frame(a, {"type": "ping"})
    assert jframe.recv_frame(b) == ({"type": "ping"}, b"")


def test_signature_wire_round_trip():
    """A port signature's wire form is the JAX signature's, field for
    field, and decodes in either package."""
    trip = jtriplets(8, 8, 8, 0.9, hermitian=False)
    sig = signature_for(sp.TransformType.C2C, 8, 8, 8, trip,
                        precision="double", device_count=2)
    jsig = jsignature_for(JTT.C2C, 8, 8, 8, trip, precision="double",
                          device_count=2)
    wire = tframe.signature_to_wire(sig)
    json.dumps(wire)  # must be JSON-serializable as-is
    assert wire == jframe.signature_to_wire(jsig)
    assert tframe.signature_from_wire(wire) == sig
    assert jframe.signature_from_wire(wire) == jsig
    with pytest.raises(NetProtocolError):
        tframe.signature_from_wire({"bogus_field": 1})


def _error_classes(mod):
    return {name: cls for name, cls in inspect.getmembers(mod, inspect.isclass)
            if issubclass(cls, BaseException)}


def test_error_wire_round_trip():
    wire = tframe.error_to_wire(QueueFullError("queue is full"))
    assert wire == jframe.error_to_wire(jerrors.QueueFullError(
        "queue is full"))
    back = tframe.error_from_wire(wire)
    assert isinstance(back, QueueFullError)
    assert "queue is full" in str(back)
    assert isinstance(tframe.error_from_wire(
        tframe.error_to_wire(ValueError("x"))), ValueError)
    unknown = tframe.error_from_wire({"type": "error",
                                      "error_type": "BogusError",
                                      "message": "?"})
    assert isinstance(unknown, GenericError)


def test_error_from_wire_maps_every_class_as_the_jax_package():
    """Every error name the two taxonomies share (and the faults'
    ``InjectedFault``), each request-shaped builtin and an unknown name
    come back from the wire as the class of the same name in both
    packages, with the same message; a name only the port has (its
    device errors) comes back as the port's own class."""
    tnames, jnames = _error_classes(terrors), _error_classes(jerrors)
    shared = set(tnames) & set(jnames)
    shared |= {"InjectedFault", "TypeError", "ValueError", "IndexError",
               "KeyError", "TimeoutError", "RuntimeError", "BogusError", ""}
    for name in sorted(shared):
        header = {"type": "error", "error_type": name, "message": "m"}
        got = tframe.error_from_wire(header)
        want = jframe.error_from_wire(header)
        assert type(got).__name__ == type(want).__name__, name
        assert str(got) == str(want), name
    for name in sorted(set(tnames) - set(jnames)):
        if issubclass(tnames[name], GenericError):
            got = tframe.error_from_wire({"type": "error",
                                          "error_type": name,
                                          "message": "m"})
            assert type(got) is tnames[name], name
