"""Self-contained MCAP container + ROS 2 CDR codec (no external deps).

The reference reads Bit-Bots rosbags through the ``mcap`` / ``mcap_ros2``
packages (reference dataset/imports/strategies/bit_bots.py:6-8) and exports
recordings through ``rosbag2_py`` (reference dataset/recording2mcap.py).
This module implements the minimum of both natively so the framework's
ingest/export layers run standalone:

  * ``McapReader`` / ``McapWriter`` — the open MCAP v0 container format:
    records (Header, Schema, Channel, Message, Chunk, Statistics, Footer),
    zstd/none chunk compression, summary section. The writer produces files
    the upstream ``mcap`` tooling can read; the reader consumes real
    Bit-Bots bags (chunked + zstd) as well as our own exports.
  * ``parse_ros2_schema`` / ``decode_cdr`` / ``encode_cdr`` — a
    schema-DRIVEN CDR (XCDR1) codec: message layouts are parsed from the
    ``ros2msg`` schema text EMBEDDED in the bag itself (concatenated-block
    format), so no message definitions are hardcoded and version drift in
    e.g. bitbots_msgs is handled the same way mcap_ros2 handles it.

If the upstream packages are installed they are preferred (see
``bitbots.read_mcap``); this is the fallback and the test path. The
counterpart of ``soccerdiffusion_tpu/ingest/mcap_io.py``: the same records
in the same order, so that both packages' writers give the same bytes for
the same messages.
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Any, BinaryIO, Iterator

MAGIC = b"\x89MCAP0\r\n"

OP_HEADER = 0x01
OP_FOOTER = 0x02
OP_SCHEMA = 0x03
OP_CHANNEL = 0x04
OP_MESSAGE = 0x05
OP_CHUNK = 0x06
OP_STATISTICS = 0x0B
OP_DATA_END = 0x0F


# --------------------------------------------------------------------------
# Low-level record serialization
# --------------------------------------------------------------------------


def _string(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<I", len(b)) + b


def _prefixed(b: bytes) -> bytes:
    return struct.pack("<I", len(b)) + b


class _Cursor:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def u8(self):
        v = self.data[self.pos]
        self.pos += 1
        return v

    def u16(self):
        (v,) = struct.unpack_from("<H", self.data, self.pos)
        self.pos += 2
        return v

    def u32(self):
        (v,) = struct.unpack_from("<I", self.data, self.pos)
        self.pos += 4
        return v

    def u64(self):
        (v,) = struct.unpack_from("<Q", self.data, self.pos)
        self.pos += 8
        return v

    def string(self):
        n = self.u32()
        s = self.data[self.pos : self.pos + n].decode()
        self.pos += n
        return s

    def raw(self, n):
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b


@dataclass
class Schema:
    id: int
    name: str
    encoding: str
    data: bytes


@dataclass
class Channel:
    id: int
    schema_id: int
    topic: str
    message_encoding: str
    metadata: dict = field(default_factory=dict)


@dataclass
class Message:
    channel_id: int
    sequence: int
    log_time: int
    publish_time: int
    data: bytes


# --------------------------------------------------------------------------
# Writer
# --------------------------------------------------------------------------


class McapWriter:
    """Minimal MCAP writer (API-compatible subset of ``mcap.writer.Writer``).

    Messages are written unchunked unless ``chunk_compression='zstd'``, in
    which case they are buffered into zstd chunks. The summary section
    repeats schemas/channels and a Statistics record so standard readers can
    find topics and the message time range without scanning.
    """

    def __init__(self, f: BinaryIO, profile: str = "ros2",
                 chunk_compression: str | None = None, chunk_size: int = 1 << 20):
        self._f = f
        self._profile = profile
        self._schemas: list[Schema] = []
        self._channels: list[Channel] = []
        self._counts: dict[int, int] = {}
        self._msg_count = 0
        self._t_min: int | None = None
        self._t_max: int | None = None
        self._compression = chunk_compression
        self._chunk_size = chunk_size
        self._chunk_buf = io.BytesIO()
        self._chunk_t: list[int] = []
        self._started = False

    # -- record plumbing

    def _record(self, op: int, body: bytes, to=None) -> None:
        out = to if to is not None else self._f
        out.write(struct.pack("<BQ", op, len(body)))
        out.write(body)

    def start(self) -> None:
        self._f.write(MAGIC)
        # the library field names the project, as the JAX package's writer does
        self._record(OP_HEADER, _string(self._profile) + _string("soccerdiffusion_tpu"))
        self._started = True

    def register_schema(self, name: str, encoding: str, data: bytes) -> int:
        sid = len(self._schemas) + 1
        schema = Schema(sid, name, encoding, data)
        self._schemas.append(schema)
        self._record(OP_SCHEMA, self._schema_body(schema))
        return sid

    def register_channel(self, topic: str, message_encoding: str, schema_id: int) -> int:
        cid = len(self._channels)
        ch = Channel(cid, schema_id, topic, message_encoding)
        self._channels.append(ch)
        self._record(OP_CHANNEL, self._channel_body(ch))
        return cid

    @staticmethod
    def _schema_body(s: Schema) -> bytes:
        return struct.pack("<H", s.id) + _string(s.name) + _string(s.encoding) + _prefixed(s.data)

    @staticmethod
    def _channel_body(c: Channel) -> bytes:
        meta = b"".join(_string(k) + _string(v) for k, v in c.metadata.items())
        return (struct.pack("<HH", c.id, c.schema_id) + _string(c.topic)
                + _string(c.message_encoding) + _prefixed(meta))

    def add_message(self, channel_id: int, log_time: int, publish_time: int,
                    data: bytes, sequence: int = 0) -> None:
        body = struct.pack("<HIQQ", channel_id, sequence, log_time, publish_time) + data
        if self._compression:
            self._record(OP_MESSAGE, body, to=self._chunk_buf)
            self._chunk_t.append(log_time)
            if self._chunk_buf.tell() >= self._chunk_size:
                self._flush_chunk()
        else:
            self._record(OP_MESSAGE, body)
        self._msg_count += 1
        self._counts[channel_id] = self._counts.get(channel_id, 0) + 1
        self._t_min = log_time if self._t_min is None else min(self._t_min, log_time)
        self._t_max = log_time if self._t_max is None else max(self._t_max, log_time)

    def _flush_chunk(self) -> None:
        raw = self._chunk_buf.getvalue()
        if not raw:
            return
        import zstandard

        compressed = zstandard.ZstdCompressor().compress(raw)
        body = (struct.pack("<QQQI", min(self._chunk_t), max(self._chunk_t), len(raw), 0)
                + _string("zstd") + struct.pack("<Q", len(compressed)) + compressed)
        self._record(OP_CHUNK, body)
        self._chunk_buf = io.BytesIO()
        self._chunk_t = []

    def finish(self) -> None:
        if self._compression:
            self._flush_chunk()
        self._record(OP_DATA_END, struct.pack("<I", 0))
        summary_start = self._f.tell()
        for s in self._schemas:
            self._record(OP_SCHEMA, self._schema_body(s))
        for c in self._channels:
            self._record(OP_CHANNEL, self._channel_body(c))
        counts = b"".join(struct.pack("<HQ", cid, n) for cid, n in self._counts.items())
        stats = struct.pack(
            "<QHIIII QQ".replace(" ", ""),
            self._msg_count, len(self._schemas), len(self._channels), 0, 0,
            1 if self._compression else 0,
            self._t_min or 0, self._t_max or 0,
        ) + _prefixed(counts)
        self._record(OP_STATISTICS, stats)
        self._record(OP_FOOTER, struct.pack("<QQI", summary_start, 0, 0))
        self._f.write(MAGIC)


# --------------------------------------------------------------------------
# Reader
# --------------------------------------------------------------------------


class McapReader:
    """Reads non-chunked and chunked (none/zstd/lz4) MCAP files."""

    def __init__(self, data: bytes):
        assert data[:8] == MAGIC, "not an MCAP file"
        assert data[-8:] == MAGIC, "truncated MCAP file"
        self.data = data
        self.schemas: dict[int, Schema] = {}
        self.channels: dict[int, Channel] = {}
        self.statistics: SimpleNamespace | None = None
        self._message_spans: list[tuple[int, int]] = []  # (start, end) in file
        self._chunk_spans: list[tuple[int, int]] = []
        self._scan()

    @classmethod
    def from_file(cls, path) -> "McapReader":
        with open(path, "rb") as f:
            return cls(f.read())

    def _iter_records(self, data: bytes, start: int, end: int):
        pos = start
        while pos < end:
            op = data[pos]
            (length,) = struct.unpack_from("<Q", data, pos + 1)
            body_start = pos + 9
            yield op, body_start, body_start + length
            pos = body_start + length

    def _scan(self) -> None:
        end = len(self.data) - 8 - 9 - 20  # magic + footer record
        pos = 8
        data = self.data
        while pos < len(data) - 8:
            op = data[pos]
            (length,) = struct.unpack_from("<Q", data, pos + 1)
            body_start = pos + 9
            body_end = body_start + length
            if op == OP_SCHEMA:
                s = self._parse_schema(data, body_start)
                self.schemas[s.id] = s
            elif op == OP_CHANNEL:
                c = self._parse_channel(data, body_start)
                self.channels[c.id] = c
            elif op == OP_MESSAGE:
                self._message_spans.append((body_start, body_end))
            elif op == OP_CHUNK:
                self._chunk_spans.append((body_start, body_end))
                # pre-scan chunk for schemas/channels only (messages decoded lazily)
                for cop, cs, ce in self._iter_records(*self._chunk_records(body_start, body_end)):
                    if cop == OP_SCHEMA:
                        s = self._parse_schema(self._chunk_cache, cs)
                        self.schemas[s.id] = s
                    elif cop == OP_CHANNEL:
                        c = self._parse_channel(self._chunk_cache, cs)
                        self.channels[c.id] = c
            elif op == OP_STATISTICS:
                cur = _Cursor(data, body_start)
                self.statistics = SimpleNamespace(
                    message_count=cur.u64(), schema_count=cur.u16(),
                    channel_count=cur.u32(), attachment_count=cur.u32(),
                    metadata_count=cur.u32(), chunk_count=cur.u32(),
                    message_start_time=cur.u64(), message_end_time=cur.u64(),
                )
            elif op == OP_FOOTER:
                break
            pos = body_end
        del end

    _chunk_cache: bytes = b""

    def _chunk_records(self, body_start: int, body_end: int) -> tuple[bytes, int, int]:
        """Decompress one Chunk record; returns (buffer, start, end)."""
        cur = _Cursor(self.data, body_start)
        cur.u64()  # message_start_time
        cur.u64()  # message_end_time
        uncompressed_size = cur.u64()
        cur.u32()  # crc
        compression = cur.string()
        records_len = cur.u64()
        raw = cur.raw(records_len)
        if compression == "":
            buf = bytes(raw)
        elif compression == "zstd":
            import zstandard

            buf = zstandard.ZstdDecompressor().decompress(raw, max_output_size=uncompressed_size)
        elif compression == "lz4":
            try:
                import lz4.frame
            except ImportError as exc:  # pragma: no cover
                raise ImportError("this MCAP uses lz4 chunks; lz4 is not installed") from exc
            buf = lz4.frame.decompress(raw)
        else:
            raise ValueError(f"unknown chunk compression {compression!r}")
        self._chunk_cache = buf
        return buf, 0, len(buf)

    @staticmethod
    def _parse_schema(data: bytes, pos: int) -> Schema:
        cur = _Cursor(data, pos)
        sid = cur.u16()
        return Schema(sid, cur.string(), cur.string(), bytes(cur.raw(cur.u32())))

    @staticmethod
    def _parse_channel(data: bytes, pos: int) -> Channel:
        cur = _Cursor(data, pos)
        cid, sid = cur.u16(), cur.u16()
        topic, enc = cur.string(), cur.string()
        meta_len = cur.u32()
        meta_end = cur.pos + meta_len
        meta = {}
        while cur.pos < meta_end:
            k = cur.string()
            meta[k] = cur.string()
        return Channel(cid, sid, topic, enc, meta)

    @staticmethod
    def _parse_message(data: bytes, start: int, end: int) -> Message:
        cid, seq, log_t, pub_t = struct.unpack_from("<HIQQ", data, start)
        return Message(cid, seq, log_t, pub_t, bytes(data[start + 22 : end]))

    def iter_messages(self, topics: list[str] | None = None) -> Iterator[tuple[Channel, Schema, Message]]:
        wanted = None if topics is None else set(topics)

        def emit(data, s, e):
            msg = self._parse_message(data, s, e)
            ch = self.channels[msg.channel_id]
            if wanted is None or ch.topic in wanted:
                return ch, self.schemas.get(ch.schema_id), msg
            return None

        # file order: plain messages and chunks interleaved by offset
        events = [("m", s, e) for s, e in self._message_spans] + [
            ("c", s, e) for s, e in self._chunk_spans
        ]
        events.sort(key=lambda t: t[1])
        for kind, s, e in events:
            if kind == "m":
                out = emit(self.data, s, e)
                if out:
                    yield out
            else:
                buf, bs, be = self._chunk_records(s, e)
                for op, cs, ce in self._iter_records(buf, bs, be):
                    if op == OP_MESSAGE:
                        out = emit(buf, cs, ce)
                        if out:
                            yield out

    @property
    def message_time_range(self) -> tuple[int, int]:
        if self.statistics is not None:
            return self.statistics.message_start_time, self.statistics.message_end_time
        times = [self._parse_message(self.data, s, e).log_time
                 for s, e in self._message_spans]
        for cs, ce in self._chunk_spans:
            buf, bs, be = self._chunk_records(cs, ce)
            for op, s, e in self._iter_records(buf, bs, be):
                if op == OP_MESSAGE:
                    times.append(self._parse_message(buf, s, e).log_time)
        return (min(times), max(times)) if times else (0, 0)


# --------------------------------------------------------------------------
# ROS 2 CDR (XCDR1) codec, driven by the embedded ros2msg schema text
# --------------------------------------------------------------------------

_PRIMITIVES: dict[str, tuple[str, int]] = {
    "bool": ("<?", 1), "byte": ("<B", 1), "char": ("<B", 1),
    "int8": ("<b", 1), "uint8": ("<B", 1),
    "int16": ("<h", 2), "uint16": ("<H", 2),
    "int32": ("<i", 4), "uint32": ("<I", 4),
    "int64": ("<q", 8), "uint64": ("<Q", 8),
    "float32": ("<f", 4), "float64": ("<d", 8),
}

_BUILTINS = {
    "builtin_interfaces/Time": [("sec", "int32"), ("nanosec", "uint32")],
    "builtin_interfaces/Duration": [("sec", "int32"), ("nanosec", "uint32")],
}

_SEPARATOR = "=" * 80


def _norm_type(name: str) -> str:
    """'pkg/msg/Type' -> 'pkg/Type' (schema blocks use either form)."""
    parts = name.split("/")
    if len(parts) == 3 and parts[1] == "msg":
        return f"{parts[0]}/{parts[2]}"
    return name


@dataclass
class MsgSpec:
    name: str
    fields: list[tuple[str, str, int | None]]  # (field, type, array_len: None=scalar, -1=unbounded, n=fixed)


def parse_ros2_schema(text: str, root_name: str) -> dict[str, MsgSpec]:
    """Parse concatenated ros2msg schema text into specs keyed by type name.

    The root block has no ``MSG:`` line; nested blocks follow separated by
    an 80-char ``=`` line (the format mcap_ros2 emits/consumes).
    """
    specs: dict[str, MsgSpec] = {}
    blocks = text.split(_SEPARATOR)
    for i, block in enumerate(blocks):
        lines = [ln.rstrip() for ln in block.strip().splitlines()]
        name = _norm_type(root_name)
        if lines and lines[0].startswith("MSG: "):
            name = _norm_type(lines[0][5:].strip())
            lines = lines[1:]
        fields: list[tuple[str, str, int | None]] = []
        for ln in lines:
            ln = ln.split("#", 1)[0].strip()
            if not ln:
                continue
            parts = ln.split(None, 2)
            if len(parts) < 2:
                continue
            ftype, fname = parts[0], parts[1]
            if "=" in fname:  # constant, e.g. "uint8 FOO=3"
                continue
            if len(parts) == 3 and "=" in parts[2].split()[0] and fname.isupper():
                continue  # "uint8 FOO = 3"
            array_len: int | None = None
            if "[" in ftype:
                base, rest = ftype.split("[", 1)
                rest = rest.rstrip("]")
                ftype = base
                if rest == "" or rest.startswith("<="):
                    array_len = -1  # unbounded/bounded -> length-prefixed
                else:
                    array_len = int(rest)
            # bounded strings 'string<=N'
            if ftype.startswith("string<=") or ftype.startswith("wstring<="):
                ftype = "string"
            fields.append((fname, ftype, array_len))
        specs[name] = MsgSpec(name, fields)
    for bname, bfields in _BUILTINS.items():
        specs.setdefault(bname, MsgSpec(bname, [(f, t, None) for f, t in bfields]))
    return specs


def _resolve(ftype: str, specs: dict[str, MsgSpec], ctx_pkg: str) -> MsgSpec | None:
    """Message-type lookup: exact, package-qualified, or well-known short name."""
    ftype = _norm_type(ftype)
    if ftype in specs:
        return specs[ftype]
    if "/" not in ftype:
        for cand in (f"{ctx_pkg}/{ftype}", f"std_msgs/{ftype}",
                     f"geometry_msgs/{ftype}", f"builtin_interfaces/{ftype}"):
            if cand in specs:
                return specs[cand]
    return None


class _CdrReader:
    def __init__(self, data: bytes):
        # 4-byte encapsulation: {0x00, 0x01} = CDR little-endian (XCDR1)
        self.le = data[1] & 1 == 1
        self.data = data
        self.pos = 4

    def align(self, n: int) -> None:
        rem = (self.pos - 4) % n
        if rem:
            self.pos += n - rem

    def prim(self, ftype: str):
        fmt, size = _PRIMITIVES[ftype]
        if not self.le:
            fmt = ">" + fmt[1:]
        self.align(size)
        (v,) = struct.unpack_from(fmt, self.data, self.pos)
        self.pos += size
        return v

    def string(self) -> str:
        self.align(4)
        (n,) = struct.unpack_from("<I" if self.le else ">I", self.data, self.pos)
        self.pos += 4
        s = self.data[self.pos : self.pos + n - 1].decode(errors="replace") if n else ""
        self.pos += n
        return s


def _decode_value(r: _CdrReader, ftype: str, specs, ctx_pkg: str):
    if ftype in _PRIMITIVES:
        return r.prim(ftype)
    if ftype in ("string", "wstring"):
        return r.string()
    spec = _resolve(ftype, specs, ctx_pkg)
    if spec is None:
        raise ValueError(f"unknown message type {ftype!r} in schema")
    return _decode_struct(r, spec, specs)


def _decode_struct(r: _CdrReader, spec: MsgSpec, specs) -> SimpleNamespace:
    ctx_pkg = spec.name.split("/")[0] if "/" in spec.name else ""
    out = SimpleNamespace()
    for fname, ftype, alen in spec.fields:
        if alen is None:
            setattr(out, fname, _decode_value(r, ftype, specs, ctx_pkg))
            continue
        if alen == -1:
            r.align(4)
            (count,) = struct.unpack_from("<I" if r.le else ">I", r.data, r.pos)
            r.pos += 4
        else:
            count = alen
        if ftype == "uint8":  # fast path: bytes payloads (e.g. Image.data)
            setattr(out, fname, bytes(r.data[r.pos : r.pos + count]))
            r.pos += count
        else:
            setattr(out, fname,
                    [_decode_value(r, ftype, specs, ctx_pkg) for _ in range(count)])
    return out


def decode_cdr(schema_text: str, root_name: str, data: bytes) -> SimpleNamespace:
    specs = parse_ros2_schema(schema_text, root_name)
    return _decode_struct(_CdrReader(data), specs[_norm_type(root_name)], specs)


class _CdrWriter:
    def __init__(self):
        self.buf = bytearray(b"\x00\x01\x00\x00")  # CDR_LE encapsulation

    def align(self, n: int) -> None:
        rem = (len(self.buf) - 4) % n
        if rem:
            self.buf.extend(b"\x00" * (n - rem))

    def prim(self, ftype: str, v) -> None:
        fmt, size = _PRIMITIVES[ftype]
        self.align(size)
        self.buf.extend(struct.pack(fmt, v))

    def string(self, s: str) -> None:
        b = s.encode() + b"\x00"
        self.align(4)
        self.buf.extend(struct.pack("<I", len(b)))
        self.buf.extend(b)


def _encode_value(w: _CdrWriter, ftype: str, v, specs, ctx_pkg: str) -> None:
    if ftype in _PRIMITIVES:
        w.prim(ftype, v)
    elif ftype in ("string", "wstring"):
        w.string(v)
    else:
        spec = _resolve(ftype, specs, ctx_pkg)
        if spec is None:
            raise ValueError(f"unknown message type {ftype!r} in schema")
        _encode_struct(w, spec, specs, v)


def _encode_struct(w: _CdrWriter, spec: MsgSpec, specs, obj) -> None:
    ctx_pkg = spec.name.split("/")[0] if "/" in spec.name else ""
    for fname, ftype, alen in spec.fields:
        v = getattr(obj, fname)
        if alen is None:
            _encode_value(w, ftype, v, specs, ctx_pkg)
            continue
        if alen == -1:
            w.align(4)
            w.buf.extend(struct.pack("<I", len(v)))
        else:
            assert len(v) == alen, f"{fname}: fixed array length {alen} != {len(v)}"
        if ftype == "uint8" and isinstance(v, (bytes, bytearray)):
            w.buf.extend(v)
        else:
            for item in v:
                _encode_value(w, ftype, item, specs, ctx_pkg)


def encode_cdr(schema_text: str, root_name: str, obj: Any) -> bytes:
    specs = parse_ros2_schema(schema_text, root_name)
    w = _CdrWriter()
    _encode_struct(w, specs[_norm_type(root_name)], specs, obj)
    return bytes(w.buf)
