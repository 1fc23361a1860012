"""Columnar trace store — the OTF2 + fastotf2 analogue (§II-D b; port of
``repro/core/trace_format.py``).

Regions and sensor streams are stored as aligned numpy columns in one
compressed ``.npz`` per node (no parsing on load); ``merge_traces``
concatenates nodes for system-level analysis (sum node traces over
common intervals, §V-B2).  The files are the reference's format
(``FORMAT_VERSION`` 2), so either package reads what the other wrote.

The integer codec primitives at the bottom (zigzag/delta/varint/bitpack)
are the building blocks of the collective wire format: host-side,
numpy-only, and exact — they move integers around without ever touching
a float, so the float64 payloads they frame stay bit-identical through
an encode/decode round trip.
"""
from __future__ import annotations

import io
import json
from pathlib import Path

import numpy as np

from repro_torch.core.measurement_model import SensorSpec
from repro_torch.core.sensors import SensorTrace
from repro_torch.core.tracing import RegionTracer

FORMAT_VERSION = 2


def save_trace(path, tracer: RegionTracer, sensor_traces: dict,
               meta: dict = None):
    """Write one node's regions + sensor streams to a columnar .npz."""
    cols = {}
    reg = tracer.to_arrays()
    for k in ("name_id", "t_start", "t_end", "depth", "device", "step"):
        cols[f"reg/{k}"] = reg[k]
    specs = {}
    for name, tr in sensor_traces.items():
        cols[f"sens/{name}/t_read"] = tr.t_read
        cols[f"sens/{name}/t_measured"] = tr.t_measured
        cols[f"sens/{name}/value"] = tr.value
        specs[name] = tr.spec.__dict__
    header = {
        "version": FORMAT_VERSION,
        "region_names": reg["names"],
        "sensors": list(sensor_traces),
        "sensor_specs": specs,
        "meta": meta or {},
    }
    cols["header"] = np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with io.BytesIO() as buf:      # atomic write
        np.savez_compressed(buf, **cols)
        tmp = path.with_suffix(".tmp")
        tmp.write_bytes(buf.getvalue())
        tmp.replace(path)


def load_trace(path):
    """-> (tracer, {name: SensorTrace}, meta)."""
    z = np.load(Path(path), allow_pickle=False)
    header = json.loads(bytes(z["header"]).decode())
    assert header["version"] == FORMAT_VERSION
    names = header["region_names"]
    tracer = RegionTracer(timebase=lambda: 0.0)
    tracer.t0 = 0.0
    for nid, ts, te, dep, dev, st in zip(
            z["reg/name_id"], z["reg/t_start"], z["reg/t_end"],
            z["reg/depth"], z["reg/device"], z["reg/step"]):
        tracer.add_region(names[int(nid)], float(ts), float(te),
                          depth=int(dep), device=int(dev), step=int(st))
    sensors = {}
    for name in header["sensors"]:
        spec = SensorSpec(**header["sensor_specs"][name])
        sensors[name] = SensorTrace(
            name, spec, z[f"sens/{name}/t_read"],
            z[f"sens/{name}/t_measured"], z[f"sens/{name}/value"])
    return tracer, sensors, header["meta"]


def merge_traces(paths):
    """Concatenate per-node traces for system-level analysis."""
    merged_regions = RegionTracer(timebase=lambda: 0.0)
    merged_regions.t0 = 0.0
    all_sensors = {}
    metas = []
    for i, p in enumerate(paths):
        tracer, sensors, meta = load_trace(p)
        node = meta.get("node_id", i)
        for e in tracer.events:
            merged_regions.add_region(e.name, e.t_start, e.t_end,
                                      depth=e.depth, device=e.device,
                                      step=e.step)
        for name, tr in sensors.items():
            all_sensors[f"node{node}/{name}"] = tr
        metas.append(meta)
    return merged_regions, all_sensors, metas


# ---------------------------------------------------------------------------
# Integer codec primitives (wire-format building blocks)
# ---------------------------------------------------------------------------

def zigzag_encode(x) -> np.ndarray:
    """Signed int64 -> unsigned zigzag (small magnitudes stay small).

    0 -> 0, -1 -> 1, 1 -> 2, -2 -> 3, ... — the standard mapping that
    makes delta streams around a trend bitpack tightly whichever way
    they drift.
    """
    v = np.asarray(x, np.int64)
    return ((v << 1) ^ (v >> 63)).astype(np.uint64)


def zigzag_decode(u) -> np.ndarray:
    """Inverse of ``zigzag_encode``."""
    v = np.asarray(u, np.uint64)
    return ((v >> np.uint64(1)).astype(np.int64)
            ^ -(v & np.uint64(1)).astype(np.int64))


def delta_encode(x) -> np.ndarray:
    """Int64 sequence -> [first, diffs...] (same length, exact)."""
    v = np.asarray(x, np.int64)
    if v.size == 0:
        return v.copy()
    return np.concatenate([v[:1], np.diff(v)])


def delta_decode(d) -> np.ndarray:
    """Inverse of ``delta_encode`` (cumulative sum)."""
    v = np.asarray(d, np.int64)
    if v.size == 0:
        return v.copy()
    return np.cumsum(v)


def varint_encode(n: int) -> bytes:
    """Unsigned LEB128 (7 bits per byte, MSB = continuation)."""
    n = int(n)
    assert n >= 0, "varints are unsigned"
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def varint_decode(buf, offset: int = 0):
    """-> (value, next offset).  Raises on a truncated varint."""
    shift = 0
    value = 0
    while True:
        if offset >= len(buf):
            raise ValueError("truncated varint")
        b = buf[offset]
        offset += 1
        value |= (b & 0x7F) << shift
        if not (b & 0x80):
            return value, offset
        shift += 7


def bitpack(values, bits: int) -> bytes:
    """Pack uint64 values into ``bits``-wide little-endian fields.

    ``bits`` may be 0 (all values zero — nothing is stored) up to 64.
    Every value must fit in ``bits`` bits; the tail byte is zero-padded.
    """
    v = np.asarray(values, np.uint64)
    assert 0 <= bits <= 64, bits
    if bits == 0:
        if v.any():
            raise ValueError("bits=0 requires all-zero values")
        return b""
    if v.size == 0:
        return b""
    if bits < 64 and (v >> np.uint64(bits)).any():
        raise ValueError(f"value wider than {bits} bits")
    # spread each value over its bit positions, then fold into bytes
    total = v.size * bits
    flat = np.zeros(((total + 7) // 8) * 8, np.uint8)
    pos = np.arange(v.size) * bits
    for b in range(bits):
        flat[pos + b] = ((v >> np.uint64(b)) & np.uint64(1)) \
            .astype(np.uint8)
    return np.packbits(flat, bitorder="little").tobytes()


def bitunpack(data: bytes, bits: int, count: int) -> np.ndarray:
    """Inverse of ``bitpack`` -> (count,) uint64."""
    assert 0 <= bits <= 64, bits
    if bits == 0 or count == 0:
        return np.zeros((count,), np.uint64)
    need = (count * bits + 7) // 8
    if len(data) < need:
        raise ValueError("truncated bitpacked block")
    raw = np.frombuffer(data[:need], np.uint8)
    unp = np.unpackbits(raw, bitorder="little")
    v = np.zeros((count,), np.uint64)
    pos = np.arange(count) * bits
    for b in range(bits):
        v |= unp[pos + b].astype(np.uint64) << np.uint64(b)
    return v
