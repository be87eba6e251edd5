"""Baton wire format: the hand-off really is a serialized message.

A copy of ``repro/serve_async/wire.py`` (numpy and ``struct`` only): both
packages write and read the same bytes.

The simulator prices a hand-off at ``state.envelope_bytes`` without ever
materializing one; here the baton crosses workers as actual bytes, so the
priced size can be checked against a measured size.  The payload is the
host-side leaf dict from ``runtime.state_to_host`` (already shaped for the
§8 ship/recompute/quantize mode by ``runtime.pack_for_wire``): a fixed
header, then each leaf as ``name | dtype | shape | raw bytes``.  The format
is self-describing and deterministic (leaves sorted by name), and works
identically for thread workers (bytes through a deque) and process workers
(bytes through an ``mp.Queue``).

Micro-batched workers coalesce: every baton leaving a worker for the same
destination worker in one loop iteration travels as ONE *frame* — a single
header followed by length-prefixed ``(arrival_id, dest_part, baton)``
records (:func:`encode_frame` / :func:`decode_frame`).  Frames change the
message count, not the bytes-per-baton accounting: the per-baton payload is
the unchanged :func:`encode_baton` output, so the measured
``wire_bytes_per_handoff`` vs modeled ``envelope_bytes`` comparison stays
valid, with the 16-byte per-record framing reported separately.
"""

from __future__ import annotations

import struct

import numpy as np

_MAGIC = b"BATN"
_FRAME_MAGIC = b"BATF"
_VER = 1

# frame layout: magic | <BH ver,count> | count * (<iiI a,dest,len> payload)
FRAME_HEADER_BYTES = 4 + struct.calcsize("<BH")
FRAME_RECORD_BYTES = struct.calcsize("<iiI")


def encode_baton(leaves: dict) -> bytes:
    """Leaf dict (numpy arrays / scalars) -> one self-describing message."""
    parts = [_MAGIC, struct.pack("<BB", _VER, len(leaves))]
    for name in sorted(leaves):
        arr = np.asarray(leaves[name])
        if not arr.flags.c_contiguous:   # ascontiguousarray would 1-d-ify 0-d
            arr = np.ascontiguousarray(arr)
        nm, dt = name.encode(), arr.dtype.str.encode()
        parts.append(struct.pack("<BBB", len(nm), len(dt), arr.ndim))
        parts.append(nm)
        parts.append(dt)
        parts.append(struct.pack(f"<{arr.ndim}i", *arr.shape))
        parts.append(arr.tobytes())
    return b"".join(parts)


def decode_baton(buf: bytes) -> dict:
    """Inverse of :func:`encode_baton`."""
    if buf[:4] != _MAGIC:
        raise ValueError("not a baton message")
    ver, n_leaves = struct.unpack_from("<BB", buf, 4)
    if ver != _VER:
        raise ValueError(f"unknown baton version {ver}")
    off, leaves = 6, {}
    for _ in range(n_leaves):
        ln, ld, ndim = struct.unpack_from("<BBB", buf, off)
        off += 3
        name = buf[off:off + ln].decode(); off += ln
        dtype = np.dtype(buf[off:off + ld].decode()); off += ld
        shape = struct.unpack_from(f"<{ndim}i", buf, off)
        off += 4 * ndim
        nbytes = dtype.itemsize * int(np.prod(shape, dtype=np.int64))
        leaves[name] = np.frombuffer(
            buf, dtype, count=int(np.prod(shape, dtype=np.int64)), offset=off
        ).reshape(shape).copy()
        off += nbytes
    return leaves


def encode_frame(records: "list[tuple[int, int, bytes]]") -> bytes:
    """``[(arrival_id, dest_part, encoded_baton), ...]`` -> one message."""
    parts = [_FRAME_MAGIC, struct.pack("<BH", _VER, len(records))]
    for arrival_id, dest, payload in records:
        parts.append(struct.pack("<iiI", arrival_id, dest, len(payload)))
        parts.append(payload)
    return b"".join(parts)


def decode_frame(buf: bytes) -> "list[tuple[int, int, bytes]]":
    """Inverse of :func:`encode_frame` (payloads still encoded batons)."""
    if buf[:4] != _FRAME_MAGIC:
        raise ValueError("not a baton frame")
    ver, count = struct.unpack_from("<BH", buf, 4)
    if ver != _VER:
        raise ValueError(f"unknown frame version {ver}")
    off, records = FRAME_HEADER_BYTES, []
    for _ in range(count):
        arrival_id, dest, n = struct.unpack_from("<iiI", buf, off)
        off += FRAME_RECORD_BYTES
        records.append((arrival_id, dest, buf[off:off + n]))
        off += n
    if off != len(buf):
        raise ValueError(f"frame length mismatch: {off} != {len(buf)}")
    return records
