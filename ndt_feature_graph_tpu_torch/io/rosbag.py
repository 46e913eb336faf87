"""Self-contained ROS1 bag (format 2.0) reader/writer (port of
ndt_feature_graph_tpu/io/rosbag.py: the same struct and numpy, so a bag
either package writes reads the same in the other; sequences are the
port's, on the device they are asked for).

Closes the LaserBagReader parity gap (perception_oru/ndt_offline,
used at ndt_graph_offline.cpp:458-633: readMultipleMeasurements +
getMotion over sensor_msgs/LaserScan + nav_msgs/Odometry) without any
ROS dependency: the bag container and the two message types are parsed
directly from their wire format.  Host-side I/O by design — scans land
in the same fixed-shape `Sequence` arrays the device pipeline consumes.

Supported container features: uncompressed and bz2 chunks (lz4 gated on
module availability), connection/message-data records anywhere in the
stream (index records are skipped on read, emitted on write).
"""

from __future__ import annotations

import bz2
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

BAG_MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAGHDR = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNKINFO = 0x06
OP_CONN = 0x07

LASERSCAN_TYPE = "sensor_msgs/LaserScan"
ODOM_TYPE = "nav_msgs/Odometry"
LASERSCAN_MD5 = "90c7ef2dc6895d81024acba2ac42f369"
ODOM_MD5 = "cd5e73d190d741a2f92e81eda573aca7"

LASERSCAN_DEF = """\
Header header
float32 angle_min
float32 angle_max
float32 angle_increment
float32 time_increment
float32 scan_time
float32 range_min
float32 range_max
float32[] ranges
float32[] intensities
"""
ODOM_DEF = """\
Header header
string child_frame_id
geometry_msgs/PoseWithCovariance pose
geometry_msgs/TwistWithCovariance twist
"""


# ---------------------------------------------------------------------------
# low-level record plumbing


def _parse_fields(buf: bytes) -> Dict[str, bytes]:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        item = buf[off : off + flen]
        off += flen
        eq = item.index(b"=")
        fields[item[:eq].decode()] = item[eq + 1 :]
    return fields


def _read_records(buf: bytes, offset: int = 0):
    """Yield (fields, data) for every record in buf[offset:]."""
    n = len(buf)
    while offset + 8 <= n:
        (hlen,) = struct.unpack_from("<I", buf, offset)
        offset += 4
        fields = _parse_fields(buf[offset : offset + hlen])
        offset += hlen
        (dlen,) = struct.unpack_from("<I", buf, offset)
        offset += 4
        data = buf[offset : offset + dlen]
        offset += dlen
        yield fields, data


def _u32(v: int) -> bytes:
    return struct.pack("<I", v)


def _u64(v: int) -> bytes:
    return struct.pack("<Q", v)


def _time(sec: int, nsec: int) -> bytes:
    return struct.pack("<II", sec, nsec)


def _mk_header(fields: Dict[str, bytes]) -> bytes:
    out = b""
    for k, v in fields.items():
        item = k.encode() + b"=" + v
        out += _u32(len(item)) + item
    return out


def _mk_record(fields: Dict[str, bytes], data: bytes) -> bytes:
    h = _mk_header(fields)
    return _u32(len(h)) + h + _u32(len(data)) + data


# ---------------------------------------------------------------------------
# message (de)serialization


class _Cursor:
    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.buf, self.off)
        self.off += 4
        return v

    def f32(self, n: int) -> np.ndarray:
        v = np.frombuffer(self.buf, "<f4", n, self.off)
        self.off += 4 * n
        return v

    def f64(self, n: int) -> np.ndarray:
        v = np.frombuffer(self.buf, "<f8", n, self.off)
        self.off += 8 * n
        return v

    def string(self) -> str:
        n = self.u32()
        s = self.buf[self.off : self.off + n]
        self.off += n
        return s.decode(errors="replace")

    def header(self) -> float:
        self.u32()                 # seq
        sec = self.u32()
        nsec = self.u32()
        self.string()              # frame_id
        return sec + nsec * 1e-9


def _parse_laserscan(data: bytes) -> dict:
    c = _Cursor(data)
    stamp = c.header()
    meta = c.f32(7)
    n = c.u32()
    ranges = c.f32(n).copy()
    return {
        "stamp": stamp,
        "angle_min": float(meta[0]),
        "angle_max": float(meta[1]),
        "angle_increment": float(meta[2]),
        "range_min": float(meta[5]),
        "range_max": float(meta[6]),
        "ranges": ranges,
    }


def _parse_odometry(data: bytes) -> dict:
    c = _Cursor(data)
    stamp = c.header()
    c.string()                     # child_frame_id
    pos = c.f64(3)
    quat = c.f64(4)                # x y z w
    x, y, z, w = quat
    yaw = np.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return {
        "stamp": stamp,
        "pose": np.array([pos[0], pos[1], yaw], np.float64),
    }


def _ser_header(stamp: float, frame: str) -> bytes:
    sec = int(stamp)
    nsec = int(round((stamp - sec) * 1e9))
    return (
        _u32(0)
        + struct.pack("<II", sec, nsec)
        + _u32(len(frame))
        + frame.encode()
    )


def _ser_laserscan(
    stamp: float,
    ranges: np.ndarray,
    angle_min: float,
    angle_increment: float,
    range_max: float,
) -> bytes:
    n = len(ranges)
    angle_max = angle_min + angle_increment * (n - 1)
    return (
        _ser_header(stamp, "laser")
        + struct.pack(
            "<7f",
            angle_min,
            angle_max,
            angle_increment,
            0.0,
            0.0,
            0.0,
            range_max,
        )
        + _u32(n)
        + np.asarray(ranges, "<f4").tobytes()
        + _u32(0)
    )


def _ser_odometry(stamp: float, pose: np.ndarray) -> bytes:
    x, y, th = float(pose[0]), float(pose[1]), float(pose[2])
    quat = np.array([0.0, 0.0, np.sin(th / 2), np.cos(th / 2)])
    body = (
        np.array([x, y, 0.0]).astype("<f8").tobytes()
        + quat.astype("<f8").tobytes()
        + np.zeros(36, "<f8").tobytes()
        + np.zeros(6, "<f8").tobytes()
        + np.zeros(36, "<f8").tobytes()
    )
    return (
        _ser_header(stamp, "odom")
        + _u32(len("base_link"))
        + b"base_link"
        + body
    )


# ---------------------------------------------------------------------------
# reading


def _decompress(kind: bytes, data: bytes) -> bytes:
    if kind in (b"none", b""):
        return data
    if kind == b"bz2":
        return bz2.decompress(data)
    if kind == b"lz4":
        try:
            import lz4.frame  # type: ignore
        except ImportError as e:  # pragma: no cover - env without lz4
            raise NotImplementedError(
                "bag uses lz4 chunks; lz4 module unavailable"
            ) from e
        return lz4.frame.decompress(data)
    raise ValueError(f"unknown chunk compression {kind!r}")


def read_bag(path) -> Dict[str, List[Tuple[float, dict]]]:
    """Parse a bag into {topic: [(stamp, msg), ...]} for the supported
    message types (LaserScan, Odometry); other topics are skipped."""
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(BAG_MAGIC):
        raise ValueError(f"{path}: not a ROS bag v2.0 file")

    conns: Dict[int, Tuple[str, str]] = {}       # conn id -> (topic, type)
    out: Dict[str, List[Tuple[float, dict]]] = {}

    def handle(fields, data):
        op = fields["op"][0]
        if op == OP_CONN:
            cid = struct.unpack("<I", fields["conn"])[0]
            sub = _parse_fields(data)
            conns[cid] = (
                sub["topic"].decode(),
                sub.get("type", b"").decode(),
            )
        elif op == OP_MSG:
            cid = struct.unpack("<I", fields["conn"])[0]
            topic, mtype = conns.get(cid, ("?", "?"))
            if mtype == LASERSCAN_TYPE:
                msg = _parse_laserscan(data)
            elif mtype == ODOM_TYPE:
                msg = _parse_odometry(data)
            else:
                return
            out.setdefault(topic, []).append((msg["stamp"], msg))
        elif op == OP_CHUNK:
            inner = _decompress(fields["compression"], data)
            for sub_fields, sub_data in _read_records(inner):
                handle(sub_fields, sub_data)

    for fields, data in _read_records(buf, len(BAG_MAGIC)):
        handle(fields, data)

    for topic in out:
        out[topic].sort(key=lambda p: p[0])
    return out


def _topic_types(path) -> Dict[str, str]:
    """topic -> message type, from connection records only (cheap)."""
    with open(path, "rb") as f:
        buf = f.read()
    types = {}

    def handle(fields, data):
        op = fields["op"][0]
        if op == OP_CONN:
            sub = _parse_fields(data)
            types[sub["topic"].decode()] = sub.get("type", b"").decode()
        elif op == OP_CHUNK:
            inner = _decompress(fields["compression"], data)
            for sf, sd in _read_records(inner):
                handle(sf, sd)

    for fields, data in _read_records(buf, len(BAG_MAGIC)):
        handle(fields, data)
    return types


def _interp_pose(
    times: np.ndarray, poses: np.ndarray, t: float
) -> np.ndarray:
    """Linear x/y + shortest-arc angle interpolation of an odometry
    track at time t (clamped at the ends)."""
    i = int(np.searchsorted(times, t))
    if i <= 0:
        return poses[0]
    if i >= len(times):
        return poses[-1]
    t0, t1 = times[i - 1], times[i]
    a = 0.0 if t1 <= t0 else (t - t0) / (t1 - t0)
    p0, p1 = poses[i - 1], poses[i]
    dth = np.arctan2(np.sin(p1[2] - p0[2]), np.cos(p1[2] - p0[2]))
    out = p0 + a * (p1 - p0)
    out[2] = p0[2] + a * dth
    return out


def read_bag_sequence(
    path,
    scan_topic: Optional[str] = None,
    odom_topic: Optional[str] = None,
    max_range: float = 30.0,
    device=None,
):
    """Bag -> (Sequence on `device` (the card unless given), stamps):
    one timestep per laser scan, absolute odometry interpolated to scan
    stamps, relative odometry between consecutive scans (getMotion
    semantics, ndt_graph_offline.cpp:581-633)."""
    import torch

    from ndt_feature_graph_tpu_torch import resolve_device
    from ndt_feature_graph_tpu_torch.core import se2
    from ndt_feature_graph_tpu_torch.io.dataset import Sequence

    device = resolve_device(device)

    msgs = read_bag(path)
    scan_topics = {
        t: v for t, v in msgs.items() if "angle_min" in v[0][1]
    }
    odom_topics = {
        t: v for t, v in msgs.items() if "pose" in v[0][1]
    }
    if scan_topic is None:
        if not scan_topics:
            raise ValueError(
                f"{path}: no LaserScan topic; topics={list(msgs)}"
            )
        scan_topic = max(scan_topics, key=lambda t: len(scan_topics[t]))
    if odom_topic is None:
        if not odom_topics:
            raise ValueError(
                f"{path}: no Odometry topic; topics={list(msgs)}"
            )
        odom_topic = max(odom_topics, key=lambda t: len(odom_topics[t]))

    scans = msgs[scan_topic]
    odoms = msgs[odom_topic]
    otimes = np.array([t for t, _ in odoms])
    oposes = np.stack([m["pose"] for _, m in odoms])

    nb = max(len(m["ranges"]) for _, m in scans)
    T = len(scans)
    ranges = np.full((T, nb), max_range * 1.1, np.float32)
    hit = np.zeros((T, nb), bool)
    abs_odom = np.zeros((T, 3), np.float32)
    stamps = np.zeros(T)
    for k, (t, m) in enumerate(scans):
        r = m["ranges"]
        valid = (
            np.isfinite(r)
            & (r > max(m["range_min"], 1e-3))
            & (r < min(m["range_max"], max_range) * 0.999)
        )
        ranges[k, : len(r)] = np.minimum(
            np.nan_to_num(r, nan=max_range), max_range
        )
        hit[k, : len(r)] = valid
        abs_odom[k] = _interp_pose(otimes, oposes, t)
        stamps[k] = t

    abs_t = torch.as_tensor(abs_odom, device=device)
    rel = se2.sub(abs_t[:-1], abs_t[1:])
    odom = torch.cat([torch.zeros((1, 3), device=device), rel], 0)
    seq = Sequence(
        ranges=torch.as_tensor(ranges, device=device),
        hit=torch.as_tensor(hit, device=device),
        odom=odom,
        gt=abs_t,  # no GT channel in bags: dead-reckoning chain
    )
    return seq, stamps


# ---------------------------------------------------------------------------
# writing


def write_bag(
    path,
    seq,
    stamps: Optional[np.ndarray] = None,
    scan_topic: str = "/scan",
    odom_topic: str = "/odom",
    angle_min: float = -np.pi,
    max_range: float = 30.0,
    compression: str = "none",
):
    """Export a Sequence as a bag (LaserScan + Odometry, one chunk —
    "none" or "bz2" compressed — with index/chunk-info records for tool
    compatibility).  The odometry is the composed odometry chain from
    the first ground-truth pose."""
    from ndt_feature_graph_tpu_torch.io.carmen import odometry_chain

    ranges = seq.ranges.cpu().numpy()
    hit = seq.hit.cpu().numpy()
    T, nb = ranges.shape
    if stamps is None:
        stamps = 100.0 + np.arange(T)
    angle_inc = 2 * np.pi / nb
    poses = odometry_chain(seq)

    conn_hdr = {
        0: {
            "topic": scan_topic.encode(),
            "type": LASERSCAN_TYPE.encode(),
            "md5sum": LASERSCAN_MD5.encode(),
            "message_definition": LASERSCAN_DEF.encode(),
        },
        1: {
            "topic": odom_topic.encode(),
            "type": ODOM_TYPE.encode(),
            "md5sum": ODOM_MD5.encode(),
            "message_definition": ODOM_DEF.encode(),
        },
    }

    # Chunk payload: connection records + interleaved messages.
    chunk = b""
    index: Dict[int, List[Tuple[float, int]]] = {0: [], 1: []}
    for cid, sub in conn_hdr.items():
        chunk += _mk_record(
            {"op": bytes([OP_CONN]), "conn": _u32(cid),
             "topic": sub["topic"]},
            _mk_header(sub),
        )
    for t in range(T):
        sec = int(stamps[t])
        nsec = int(round((stamps[t] - sec) * 1e9))
        r = np.where(hit[t], ranges[t], max_range * 1.1)
        for cid, payload in (
            (1, _ser_odometry(stamps[t], poses[t])),
            (0, _ser_laserscan(
                stamps[t], r, angle_min, angle_inc, max_range
            )),
        ):
            index[cid].append((stamps[t], len(chunk)))
            chunk += _mk_record(
                {"op": bytes([OP_MSG]), "conn": _u32(cid),
                 "time": _time(sec, nsec)},
                payload,
            )

    with open(path, "wb") as f:
        f.write(BAG_MAGIC)
        # Bag header record, padded to 4096 bytes total.
        hdr_fields = {
            "op": bytes([OP_BAGHDR]),
            "index_pos": _u64(0),
            "conn_count": _u32(2),
            "chunk_count": _u32(1),
        }
        h = _mk_header(hdr_fields)
        pad = 4096 - 4 - len(h) - 4
        f.write(_u32(len(h)) + h + _u32(pad) + b" " * pad)

        chunk_pos = f.tell()
        blob = bz2.compress(chunk) if compression == "bz2" else chunk
        f.write(
            _mk_record(
                {"op": bytes([OP_CHUNK]),
                 "compression": compression.encode(),
                 "size": _u32(len(chunk))},
                blob,
            )
        )
        # Per-connection index records for this chunk.
        for cid in (0, 1):
            data = b""
            for (st, off) in index[cid]:
                sec = int(st)
                nsec = int(round((st - sec) * 1e9))
                data += _time(sec, nsec) + _u32(off)
            f.write(
                _mk_record(
                    {"op": bytes([OP_INDEX]), "ver": _u32(1),
                     "conn": _u32(cid),
                     "count": _u32(len(index[cid]))},
                    data,
                )
            )
        index_pos = f.tell()
        # Connection records + chunk info at the tail (standard layout).
        for cid, sub in conn_hdr.items():
            f.write(
                _mk_record(
                    {"op": bytes([OP_CONN]), "conn": _u32(cid),
                     "topic": sub["topic"]},
                    _mk_header(sub),
                )
            )
        s0, s1 = stamps[0], stamps[-1]
        f.write(
            _mk_record(
                {
                    "op": bytes([OP_CHUNKINFO]),
                    "ver": _u32(1),
                    "chunk_pos": _u64(chunk_pos),
                    "start_time": _time(int(s0), int((s0 % 1) * 1e9)),
                    "end_time": _time(int(s1), int((s1 % 1) * 1e9)),
                    "count": _u32(2),
                },
                _u32(0) + _u32(T) + _u32(1) + _u32(T),
            )
        )
        # Rewrite the bag header with the real index_pos.
        f.seek(len(BAG_MAGIC))
        hdr_fields["index_pos"] = _u64(index_pos)
        h = _mk_header(hdr_fields)
        f.write(_u32(len(h)) + h + _u32(pad) + b" " * pad)
