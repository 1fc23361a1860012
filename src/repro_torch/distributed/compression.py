"""The host-collective reduce frame: the lossless wire format of
``HostCollectives.allreduce_framed`` (port of the reduce-frame part of
``repro/distributed/compression.py``; its gradient-compression hooks
belong to training, ROADMAP A4b).

The framed vectors are per-window (lag, weight) tracking contributions
and health statistics, (k, n_global) float64 with non-zeros only on the
posting host's rows, and all zero on the many windows where no hop
fired.  A sparse frame (strictly increasing non-zero positions as a
varint first index plus bitpacked zigzag gaps, then the non-zero values
as raw float64) shrinks them while every surviving float stays
bit-exact: the fold-order rule tolerates no rounding, so values are never
quantized; only the zeros and the index bookkeeping are compressed away.
A dense flag keeps mostly non-zero vectors at raw size.  Frames are byte
for byte the reference's, so a frame from either package decodes in the
other.  Host numpy and the standard library only.
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np

from repro_torch.core.trace_format import (bitpack, bitunpack,
                                           varint_decode, varint_encode,
                                           zigzag_decode, zigzag_encode)

# header: magic(2) + version(1) + flags(1) + raw float64 scalar(8)
FRAME_MAGIC = b"RW"
FRAME_VERSION = 1
_FLAG_DENSE = 0x01
_HEADER = struct.Struct("<2sBBd")

MIN_FRAME_BYTES = _HEADER.size          # 12: every frame is at least this


def _sparse_body(v: np.ndarray):
    """The sparse body of v (non-zero count, index bits, first index,
    bitpacked gaps, raw values), or None when dense raw float64 is no
    bigger."""
    nz = np.flatnonzero(v != 0.0)
    nnz = int(nz.size)
    body = [varint_encode(nnz)]
    if nnz:
        # strictly increasing indices: the first as a varint, then the
        # gaps minus one bitpacked at the widest gap's bit count
        gaps = np.diff(nz) - 1
        zz = zigzag_encode(gaps)          # non-negative: zigzag = 2*g
        idx_bits = int(zz.max()).bit_length() if nnz > 1 else 0
        body.append(bytes([idx_bits]))
        body.append(varint_encode(int(nz[0])))
        body.append(bitpack(zz, idx_bits))
        body.append(v[nz].tobytes())      # raw float64: bit-exact
    sparse = b"".join(body)
    return sparse if len(sparse) < v.nbytes else None


def encode_reduce_frame(scalar: float, vec) -> bytes:
    """(scalar, float64 vector) -> self-describing lossless frame.

    The scalar rides raw float64 (min/max-reduced quantities stay exact,
    ±inf sentinels included); the vector is sparse unless dense raw
    storage is smaller, which the flags byte records.  The sign of ZERO
    elements is not kept (-0.0 decodes as +0.0); every non-zero element,
    NaN and ±inf payloads included, round-trips bit for bit.
    """
    v = np.ascontiguousarray(np.asarray(vec, np.float64).reshape(-1))
    sparse = _sparse_body(v)
    flags = 0 if sparse is not None else _FLAG_DENSE
    head = _HEADER.pack(FRAME_MAGIC, FRAME_VERSION, flags, float(scalar))
    body = sparse if sparse is not None else v.tobytes()
    return head + varint_encode(v.size) + body


def decode_reduce_frame(buf: bytes):
    """Frame -> (scalar, (n,) float64 vector).  Raises ``ValueError`` on
    a truncated or corrupt frame."""
    if len(buf) < _HEADER.size:
        raise ValueError(f"reduce frame truncated ({len(buf)} bytes)")
    magic, version, flags, scalar = _HEADER.unpack_from(buf, 0)
    if magic != FRAME_MAGIC:
        raise ValueError(f"bad reduce-frame magic {magic!r}")
    if version != FRAME_VERSION:
        raise ValueError(f"unsupported reduce-frame version {version}")
    n, off = varint_decode(buf, _HEADER.size)
    if flags & _FLAG_DENSE:
        end = off + 8 * n
        if len(buf) < end:
            raise ValueError("dense reduce frame truncated")
        return float(scalar), np.frombuffer(buf[off:end],
                                            np.float64).copy()
    nnz, off = varint_decode(buf, off)
    v = np.zeros((n,), np.float64)
    if nnz:
        if off >= len(buf):
            raise ValueError("sparse reduce frame truncated")
        idx_bits = buf[off]
        off += 1
        first, off = varint_decode(buf, off)
        nbytes = ((nnz - 1) * idx_bits + 7) // 8
        gaps = zigzag_decode(bitunpack(buf[off:off + nbytes], idx_bits,
                                       nnz - 1))
        off += nbytes
        idx = (np.concatenate([[first], first + np.cumsum(gaps + 1)])
               if nnz > 1 else np.asarray([first], np.int64))
        end = off + 8 * nnz
        if len(buf) < end or int(idx[-1]) >= n:
            raise ValueError("sparse reduce frame truncated/out of range")
        v[idx] = np.frombuffer(buf[off:end], np.float64)
    return float(scalar), v


@dataclasses.dataclass
class WireStats:
    """Byte counters of the framed host collectives (per participant):
    ``payload_bytes`` is what this participant posted, ``raw_bytes``
    what the dense encoding (8 bytes x (1 + n)) would have posted."""
    frames: int = 0
    payload_bytes: int = 0
    raw_bytes: int = 0

    def record(self, payload: int, raw: int):
        self.frames += 1
        self.payload_bytes += int(payload)
        self.raw_bytes += int(raw)

    @property
    def ratio(self) -> float:
        return self.raw_bytes / max(self.payload_bytes, 1)
