"""Gradient compression for the data-parallel reduce, and the
host-collective wire format (port of ``repro/distributed/compression.py``).

The gradient hooks (``make_grad_hook`` for ``make_train_step(grad_hook=
...)``, ``ef_roundtrip`` with error feedback) round-trip a gradient tree
(nested dicts of tensors) through bf16 or blockwise int8, as the
reference does before its reduce; they round exactly as the reference
(round to nearest even in both).

The reduce frame is the lossless wire format of
``HostCollectives.allreduce_framed``.  The framed vectors are per-window
(lag, weight) tracking contributions and health statistics, (k,
n_global) float64 with non-zeros only on the posting host's rows, and
all zero on the many windows where no hop fired.  A sparse frame
(strictly increasing non-zero positions as a varint first index plus
bitpacked zigzag gaps, then the non-zero values as raw float64) shrinks
them while every surviving float stays bit-exact: the fold-order rule
tolerates no rounding, so values are never quantized; only the zeros and
the index bookkeeping are compressed away.  A dense flag keeps mostly
non-zero vectors at raw size.  Frames are byte for byte the reference's,
so a frame from either package decodes in the other.  Host numpy and
the standard library only.
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

from repro_torch.core.trace_format import (bitpack, bitunpack,
                                           varint_decode, varint_encode,
                                           zigzag_decode, zigzag_encode)
from repro_torch.models.layers import tree_map


# ---------------------------------------------------------------------------
# Gradient compression hooks
# ---------------------------------------------------------------------------

def bf16_compress(x):
    return x.to(torch.bfloat16)


def bf16_decompress(x):
    return x.to(torch.float32)


def int8_compress(x, *, block=256):
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32), tuple(x.shape), pad


def int8_decompress(q, scale, shape, pad):
    flat = (q.to(torch.float32) * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def apply_error_feedback(grads, residual):
    """g' = g + residual (fp32); returns corrected grads."""
    if residual is None:
        return grads
    return tree_map(lambda g, r: g.float() + r, grads, residual)


def compute_residual(grads_corrected, grads_compressed_roundtrip):
    """residual' = g' - decompress(compress(g'))."""
    return tree_map(lambda g, gq: g - gq.float(), grads_corrected,
                 grads_compressed_roundtrip)


def _int8_roundtrip(g):
    return int8_decompress(*int8_compress(g))


def make_grad_hook(scheme: str = "bf16"):
    """grad_hook for make_train_step: compress -> (implicit reduce) ->
    decompress.  Stateless form (no error feedback); the stateful EF form
    is ``ef_roundtrip``."""
    if scheme == "none":
        return None

    def hook(grads):
        if scheme == "bf16":
            return tree_map(lambda g: bf16_decompress(bf16_compress(g)), grads)
        if scheme == "int8":
            return tree_map(lambda g: _int8_roundtrip(g).to(g.dtype), grads)
        raise ValueError(scheme)

    return hook


def ef_roundtrip(grads, residual, *, scheme="bf16"):
    """One error-feedback step: returns (compressed-roundtrip grads,
    new residual)."""
    corrected = apply_error_feedback(grads, residual)
    if scheme == "bf16":
        rt_f = tree_map(lambda g: bf16_decompress(bf16_compress(g)), corrected)
    elif scheme == "int8":
        rt_f = tree_map(_int8_roundtrip, corrected)
    else:
        raise ValueError(scheme)
    return rt_f, compute_residual(corrected, rt_f)


# ---------------------------------------------------------------------------
# The host-collective reduce frame (lossless wire format)
# ---------------------------------------------------------------------------

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
