"""A numpy reader and writer for the HDF5 files of the shower schema (no h5py).

The raw showers are HDF5 files of three groups of one-dimensional arrays
(``data/hdf5.py``).  What h5py writes for them, with its default (earliest)
file format, is a small part of HDF5: a version 0 superblock, groups kept as
symbol tables, version 1 object headers and contiguous datasets of
little-endian ``int64``/``float32`` numbers or fixed-length strings.  This
module reads that part, and what h5py writes with ``chunks=``,
``compression="gzip"`` and ``shuffle=True``, with numpy, ``zlib`` and
``struct`` alone, so that a host without h5py (the H100 machine has none)
can build caches from the showers, score them and serve them.

:func:`read_h5` takes a path or a ``bytes`` object and returns
``{"group/name": array}`` for every dataset in the file.  It reads:

- superblock versions 0 and 1 (a user block before it included);
- version 1 object headers, with their continuation blocks;
- groups kept as symbol tables: the version 1 B-tree of type 0, the local
  heap of names and the symbol table nodes;
- the dataspace, datatype, fill value (old and new), data layout
  (version 3), filter pipeline and symbol table messages; attributes,
  comments, modification times and reference counts are skipped;
- fixed-point and IEEE floating-point numbers of either byte order (the
  array keeps the file's byte order, as h5py's does) and fixed-length
  strings (``S{size}``);
- contiguous, compact and chunked storage, the chunks indexed by a
  version 1 B-tree of type 1 and passed through the deflate (zlib) and
  shuffle filters.

Anything else raises ``ValueError`` naming the feature and the object's path,
and nothing is returned: superblock versions 2 and 3 (``libver="latest"``),
version 2 object headers, groups of link messages in a fractal heap, layout
version 4 chunk indexes, variable-length strings and every other datatype
class, other filters (lzf, szip, fletcher32, …), external storage, soft
links, shared messages, and a truncated or garbage file.  Each array is
read with one ``np.frombuffer`` over its whole extent (or its chunks).

:func:`write_h5` writes a dict of arrays in groups as h5py's default format
does: a version 0 superblock, symbol-table groups and contiguous datasets of
numbers or fixed-length strings (null-padded), each dataset's bytes in one
extent.  h5py reads what it writes (``tests/test_torch_h5lite.py``).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, Iterator, List, Tuple, Union

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
_LEAF_K = 4  # symbol table node capacity 2K entries (HDF5's default)
_INTERNAL_K = 16  # group B-tree node capacity 2K children (HDF5's default)
_HEAP_FREE_NULL = 1  # a local heap's "no free block"
_FILTERS = {1: "deflate", 2: "shuffle"}
_OTHER_FILTERS = {3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset", 307: "bzip2",
                  32000: "lzf", 32001: "blosc", 32004: "lz4", 32008: "bitshuffle", 32015: "zstd"}
_TYPE_CLASSES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound", 7: "reference",
                 8: "enum", 10: "array"}
# object header messages that carry nothing of a dataset's values
_SKIPPED = {0x0000: "NIL", 0x000C: "attribute", 0x000D: "comment", 0x000E: "modification time",
            0x0012: "modification time", 0x0015: "attribute info", 0x0016: "reference count"}
# IEEE layouts by size: sign bit, exponent location and size, mantissa
# location and size, exponent bias
_IEEE = {2: (15, 10, 5, 0, 10, 15), 4: (31, 23, 8, 0, 23, 127), 8: (63, 52, 11, 0, 52, 1023)}
# zlib expands at most ~1032:1, so a chunked dataset larger than this many
# times its file is corrupt, not compressed
_MAX_EXPANSION = 1100

Source = Union[str, bytes, bytearray, memoryview]


def _u(buf, pos: int, size: int) -> int:
    return int.from_bytes(buf[pos : pos + size], "little")


class _Reader:
    """One file's bytes and its superblock's sizes; every read is checked
    against the end of the bytes."""

    def __init__(self, buf: memoryview):
        self.buf = buf
        self.undefined = None
        self.base = self._superblock()

    def bytes(self, addr: int, n: int, path: str) -> memoryview:
        start = self.base + addr
        if addr < 0 or n < 0 or start + n > len(self.buf):
            raise ValueError(
                f"{path}: truncated file (an extent of {n} bytes at address {addr} ends past "
                f"the file's {len(self.buf)} bytes)"
            )
        return self.buf[start : start + n]

    def addr(self, mv, pos: int) -> int:
        return _u(mv, pos, self.so)

    def length(self, mv, pos: int) -> int:
        return _u(mv, pos, self.sl)

    # -- superblock -----------------------------------------------------------

    def _superblock(self) -> int:
        at = 0
        while at + 8 <= len(self.buf) and bytes(self.buf[at : at + 8]) != SIGNATURE:
            at = 512 if at == 0 else 2 * at
        if at + 8 > len(self.buf):
            raise ValueError("/: not an HDF5 file (no superblock signature)")
        sb = self.buf[at:]
        if len(sb) < 24:
            raise ValueError("/: truncated file (the superblock is cut off)")
        version = sb[8]
        if version in (2, 3):
            raise ValueError(
                f"/: superblock version {version} (a libver='latest' file) is not supported"
            )
        if version not in (0, 1):
            raise ValueError(f"/: superblock version {version} is not supported")
        self.so, self.sl = sb[13], sb[14]
        if self.so not in (2, 4, 8) or self.sl not in (2, 4, 8):
            raise ValueError(f"/: {self.so}-byte offsets or {self.sl}-byte lengths are not supported")
        self.undefined = (1 << (8 * self.so)) - 1
        pos = 24 + (4 if version == 1 else 0)
        if len(sb) < pos + 4 * self.so + 24 + 2 * self.so:
            raise ValueError("/: truncated file (the superblock is cut off)")
        base, _, eof, file_layout = (self.addr(sb, pos + i * self.so) for i in range(4))
        if file_layout != self.undefined:
            raise ValueError("/: a family or multi-file HDF5 file is not supported")
        if eof > len(self.buf):  # HDF5's test: the stored end counts the user block
            raise ValueError(
                f"/: truncated file (the superblock's end of file is {eof}, the file holds "
                f"{len(self.buf)} bytes)"
            )
        self.root_entry = bytes(sb[pos + 4 * self.so : pos + 4 * self.so + 24 + 2 * self.so])
        return base

    # -- object headers -------------------------------------------------------

    def messages(self, addr: int, path: str) -> List[Tuple[int, memoryview]]:
        """(type, body) of every message of a version 1 object header, its
        continuation blocks included."""
        head = self.bytes(addr, 16, path)
        if bytes(head[:4]) == b"OHDR":
            raise ValueError(f"{path}: object header version 2 (a libver='latest' file) is not supported")
        if head[0] != 1:
            raise ValueError(f"{path}: object header version {head[0]} is not supported")
        blocks, seen, out = [(addr + 16, _u(head, 8, 4))], set(), []
        while blocks:
            start, size = blocks.pop(0)
            if start in seen:
                raise ValueError(f"{path}: object header continuation blocks form a cycle")
            seen.add(start)
            block, pos = self.bytes(start, size, path), 0
            while pos + 8 <= size:
                mtype, msize, flags = _u(block, pos, 2), _u(block, pos + 2, 2), block[pos + 4]
                if pos + 8 + msize > size:
                    raise ValueError(f"{path}: an object header message overruns its block")
                body = block[pos + 8 : pos + 8 + msize]
                pos += 8 + msize
                if mtype == 0x0010:
                    blocks.append((self.addr(body, 0), self.length(body, self.so)))
                elif mtype not in _SKIPPED:
                    if flags & 0x02:
                        raise ValueError(f"{path}: shared object header messages (type {mtype}) are not supported")
                    out.append((mtype, body))
        return out

    # -- groups ---------------------------------------------------------------

    def group(self, path: str, btree: int, heap: int, out: dict, groups: set) -> None:
        if btree in groups:
            raise ValueError(f"{path or '/'}: a group contains itself")
        groups = groups | {btree}
        names = self._heap(heap, path)
        for snod in self._btree_leaves(btree, 0, path, 0):
            for name_off, header, cache in self._snod(snod, path):
                end = bytes(names[name_off:]).find(b"\0")
                if name_off >= len(names) or end < 0:
                    raise ValueError(f"{path or '/'}: a link name lies outside the group's name heap")
                name = bytes(names[name_off : name_off + end]).decode("utf-8")
                child = f"{path}/{name}" if path else name
                if cache == 2:
                    raise ValueError(f"{child}: soft links are not supported")
                self.object(child, header, out, groups)

    def _heap(self, addr: int, path: str) -> memoryview:
        head = self.bytes(addr, 8 + 2 * self.sl + self.so, path)
        if bytes(head[:4]) != b"HEAP" or head[4] != 0:
            raise ValueError(f"{path or '/'}: bad local heap (not a version 0 'HEAP')")
        size = self.length(head, 8)
        return self.bytes(self.addr(head, 8 + 2 * self.sl), size, path)

    def _btree_leaves(self, addr: int, kind: int, path: str, depth: int, ndims: int = 0) -> Iterator:
        """Level-0 entries of a version 1 B-tree: group nodes (kind 0) give
        symbol table node addresses, chunk nodes (kind 1) give (offsets,
        stored size, filter mask, address)."""
        if depth > 64:
            raise ValueError(f"{path or '/'}: a B-tree deeper than 64 levels")
        head = self.bytes(addr, 8 + 2 * self.so, path)
        if bytes(head[:4]) != b"TREE" or head[4] != kind:
            raise ValueError(f"{path or '/'}: bad B-tree node (not a 'TREE' of type {kind})")
        level, used = head[5], _u(head, 6, 2)
        key = self.sl if kind == 0 else 8 + 8 * ndims
        body = self.bytes(addr + 8 + 2 * self.so, used * (key + self.so) + key, path)
        for i in range(used):
            k = i * (key + self.so)
            child = self.addr(body, k + key)
            if level > 0:
                yield from self._btree_leaves(child, kind, path, depth + 1, ndims)
            elif kind == 0:
                yield child
            else:
                offsets = tuple(_u(body, k + 8 + 8 * j, 8) for j in range(ndims))
                yield offsets, _u(body, k, 4), _u(body, k + 4, 4), child

    def _snod(self, addr: int, path: str) -> Iterator[Tuple[int, int, int]]:
        head = self.bytes(addr, 8, path)
        if bytes(head[:4]) != b"SNOD" or head[4] != 1:
            raise ValueError(f"{path or '/'}: bad symbol table node (not a version 1 'SNOD')")
        entry = 2 * self.so + 24
        body = self.bytes(addr + 8, _u(head, 6, 2) * entry, path)
        for i in range(_u(head, 6, 2)):
            e = i * entry
            yield self.length(body, e), self.addr(body, e + self.so), _u(body, e + 2 * self.so, 4)

    # -- objects --------------------------------------------------------------

    def object(self, path: str, addr: int, out: dict, groups: set) -> None:
        msgs: Dict[int, memoryview] = {}
        for mtype, body in self.messages(addr, path or "/"):
            if mtype in (0x0002, 0x0006, 0x000A):
                raise ValueError(f"{path or '/'}: groups of link messages (a fractal heap) are not supported")
            if mtype == 0x0007:
                raise ValueError(f"{path}: external storage is not supported")
            if mtype not in (0x0001, 0x0003, 0x0004, 0x0005, 0x0008, 0x000B, 0x0011):
                raise ValueError(f"{path or '/'}: object header message type {mtype} is not supported")
            msgs[mtype] = body
        if 0x0011 in msgs:
            stab = msgs[0x0011]
            self.group(path, self.addr(stab, 0), self.addr(stab, self.so), out, groups)
            return
        if not {0x0001, 0x0003, 0x0008} <= set(msgs):
            raise ValueError(f"{path}: an object that is neither a group nor a dataset (a named datatype?)")
        out[path] = self.dataset(path, msgs)

    def dataset(self, path: str, msgs: Dict[int, memoryview]) -> np.ndarray:
        shape = self._dataspace(msgs[0x0001], path)
        dtype = _dtype(msgs[0x0003], path)
        count = int(np.prod(shape, dtype=np.int64))
        layout = msgs[0x0008]
        if layout[0] != 3:
            what = "a chunk index of libver='latest'" if layout[0] == 4 else "a file older than HDF5 1.6.3"
            raise ValueError(f"{path}: data layout message version {layout[0]} ({what}) is not supported")
        kind = layout[1]
        filters = _filters(msgs[0x000B], path) if 0x000B in msgs else []
        if filters and kind != 2:
            raise ValueError(f"{path}: a filter pipeline on unchunked storage")
        if kind == 0:
            size = _u(layout, 2, 2)
            return self._extent(layout[4 : 4 + size], size, dtype, count, shape, path)
        if kind == 1:
            addr, size = self.addr(layout, 2), self.length(layout, 2 + self.so)
            if addr == self.undefined:
                return self._allocate(msgs, dtype, shape, path)
            return self._extent(self.bytes(addr, size, path), size, dtype, count, shape, path)
        if kind == 2:
            return self._chunked(layout, msgs, filters, dtype, shape, path)
        raise ValueError(f"{path}: {'virtual' if kind == 3 else f'layout class {kind}'} storage is not supported")

    def _dataspace(self, body, path: str) -> Tuple[int, ...]:
        version, rank = body[0], body[1]
        if version == 1:
            pos = 8
        elif version == 2:
            if body[3] == 2:
                raise ValueError(f"{path}: a null dataspace is not supported")
            pos = 4
        else:
            raise ValueError(f"{path}: dataspace message version {version} is not supported")
        if len(body) < pos + rank * self.sl:
            raise ValueError(f"{path}: truncated dataspace message")
        return tuple(self.length(body, pos + i * self.sl) for i in range(rank))

    def _extent(self, mv, size: int, dtype, count: int, shape, path: str) -> np.ndarray:
        if size != count * dtype.itemsize or len(mv) != size:
            raise ValueError(f"{path}: {size} stored bytes for {count} elements of {dtype.itemsize} bytes")
        return np.frombuffer(mv, dtype=dtype, count=count).reshape(shape).copy()

    def _fill_value(self, msgs, dtype, path: str):
        """The dataset's fill value as one element, or zero."""
        value = None
        if 0x0005 in msgs:
            body = msgs[0x0005]
            if body[0] in (1, 2) and (body[0] == 1 or body[3]):
                value = bytes(body[8 : 8 + _u(body, 4, 4)])
            elif body[0] == 3 and body[1] & 0x20:
                value = bytes(body[6 : 6 + _u(body, 2, 4)])
        elif 0x0004 in msgs:
            value = bytes(msgs[0x0004][4 : 4 + _u(msgs[0x0004], 0, 4)])
        if value and len(value) != dtype.itemsize:
            raise ValueError(f"{path}: a {len(value)}-byte fill value for {dtype.itemsize}-byte elements")
        return np.frombuffer(value, dtype=dtype)[0] if value else np.zeros((), dtype=dtype)[()]

    def _allocate(self, msgs, dtype, shape, path: str) -> np.ndarray:
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if nbytes > max(1 << 30, _MAX_EXPANSION * len(self.buf)):
            raise ValueError(f"{path}: {nbytes} bytes of values in a file of {len(self.buf)} bytes")
        return np.full(shape, self._fill_value(msgs, dtype, path), dtype=dtype)

    def _chunked(self, layout, msgs, filters, dtype, shape, path: str) -> np.ndarray:
        ndims = layout[2]
        rank = len(shape)
        if ndims != rank + 1:
            raise ValueError(f"{path}: a {ndims - 1}-dimensional chunk for a {rank}-dimensional dataset")
        btree = self.addr(layout, 3)
        dims = tuple(_u(layout, 3 + self.so + 4 * i, 4) for i in range(ndims))
        chunk, elem = dims[:rank], dims[rank]
        if elem != dtype.itemsize or 0 in chunk:
            raise ValueError(f"{path}: chunk dimensions {dims} do not fit {dtype.itemsize}-byte elements")
        out = self._allocate(msgs, dtype, shape, path)
        if btree == self.undefined:
            return out
        want = int(np.prod(chunk, dtype=np.int64)) * elem
        for offsets, size, mask, addr in self._btree_leaves(btree, 1, path, 0, ndims):
            raw = bytes(self.bytes(addr, size, path))
            for i in reversed(range(len(filters))):
                if mask & (1 << i):
                    continue
                try:
                    raw = zlib.decompress(raw) if filters[i] == 1 else _unshuffle(raw, elem)
                except zlib.error as exc:
                    raise ValueError(f"{path}: a chunk that does not inflate ({exc})") from exc
            if len(raw) != want:
                raise ValueError(f"{path}: a chunk of {len(raw)} bytes where {want} were expected")
            if any(o % c or o >= s for o, c, s in zip(offsets, chunk, shape)) or offsets[rank] != 0:
                raise ValueError(f"{path}: a chunk at offsets {offsets} outside the dataset")
            block = np.frombuffer(raw, dtype=dtype).reshape(chunk)
            sel = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offsets, chunk, shape))
            out[sel] = block[tuple(slice(0, s.stop - s.start) for s in sel)]
        return out


def _dtype(body, path: str) -> np.dtype:
    cls, bits, size = body[0] & 0x0F, _u(body, 1, 3), _u(body, 4, 4)
    if cls == 0:
        offset, precision = _u(body, 8, 2), _u(body, 10, 2)
        if size not in (1, 2, 4, 8) or offset != 0 or precision != 8 * size:
            raise ValueError(f"{path}: a {precision}-bit integer at bit {offset} of {size} bytes is not supported")
        return np.dtype(f"{'>' if bits & 1 else '<'}{'i' if bits & 0x08 else 'u'}{size}")
    if cls == 1:
        layout = (bits >> 8 & 0xFF, body[12], body[13], body[14], body[15], _u(body, 16, 4))
        standard = (size in _IEEE and layout == _IEEE[size] and _u(body, 8, 2) == 0
                    and _u(body, 10, 2) == 8 * size and bits & 0x4E == 0 and bits >> 4 & 3 == 2)
        if not standard:
            raise ValueError(f"{path}: a {size}-byte floating-point type that is not IEEE is not supported")
        return np.dtype(f"{'>' if bits & 1 else '<'}f{size}")
    if cls == 3:
        if bits >> 4 & 0x0F not in (0, 1):
            raise ValueError(f"{path}: string character set {bits >> 4 & 0x0F} is not supported")
        return np.dtype(f"S{size}")
    if cls == 9:
        what = "strings" if bits & 0x0F == 1 else "sequences"
        raise ValueError(f"{path}: variable-length {what} are not supported")
    raise ValueError(f"{path}: datatype class {cls} ({_TYPE_CLASSES.get(cls, 'unknown')}) is not supported")


def _filters(body, path: str) -> List[int]:
    """The pipeline's filter ids, in the order they were applied on write."""
    version, n = body[0], body[1]
    if version not in (1, 2):
        raise ValueError(f"{path}: filter pipeline message version {version} is not supported")
    pos, ids = (8 if version == 1 else 2), []
    for _ in range(n):
        fid = _u(body, pos, 2)
        named = version == 1 or fid >= 256
        name_len = _u(body, pos + 2, 2) if named else 0
        pos += 4 if named else 2
        n_values = _u(body, pos + 2, 2)
        pos += 4 + (name_len + 7) // 8 * 8 if version == 1 else 4 + name_len
        pos += 4 * n_values + (4 if version == 1 and n_values % 2 else 0)
        if fid not in _FILTERS:
            name = _OTHER_FILTERS.get(fid, "unknown")
            raise ValueError(f"{path}: the {name} filter (id {fid}) is not supported")
        ids.append(fid)
    return ids


def _unshuffle(raw: bytes, itemsize: int) -> bytes:
    n = len(raw) // itemsize
    if itemsize <= 1 or n == 0:
        return raw
    head = np.frombuffer(raw, dtype=np.uint8, count=n * itemsize).reshape(itemsize, n)
    return head.T.tobytes() + raw[n * itemsize :]


def read_h5(source: Source) -> Dict[str, np.ndarray]:
    """Every dataset of an HDF5 file (a path, or the file's bytes) as
    ``{"group/name": array}``; ``ValueError`` names any feature outside the
    supported part of the format, and nothing is returned then."""
    if isinstance(source, (bytes, bytearray, memoryview)):
        buf = memoryview(source).cast("B")
    else:
        if os.path.getsize(source) < 8:
            raise ValueError(f"/: not an HDF5 file ({source} holds fewer than 8 bytes)")
        # the mapping closes when the last array view of it goes
        buf = memoryview(np.memmap(source, dtype=np.uint8, mode="r"))
    out: Dict[str, np.ndarray] = {}
    try:
        reader = _Reader(buf)
        reader.object("", _u(reader.root_entry, reader.so, reader.so), out, set())
    except (struct.error, IndexError, UnicodeDecodeError, OverflowError) as exc:
        raise ValueError(f"/: a corrupt file ({type(exc).__name__}: {exc})") from exc
    return out


# -- the writer -----------------------------------------------------------------


def _pad8(n: int) -> int:
    return (n + 7) // 8 * 8


def _message(mtype: int, body: bytes) -> bytes:
    body = body + b"\0" * (_pad8(len(body)) - len(body))
    return struct.pack("<HHB3x", mtype, len(body), 0) + body


def _object_header(messages: List[bytes]) -> bytes:
    data = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(data)) + data


def _datatype(dtype: np.dtype) -> bytes:
    order = 1 if dtype.byteorder == ">" else 0
    if dtype.kind in "iu":
        bits = order | (0x08 if dtype.kind == "i" else 0)
        return struct.pack("<B3sIHH", 0x10, bits.to_bytes(3, "little"), dtype.itemsize, 0, 8 * dtype.itemsize)
    if dtype.kind == "f" and dtype.itemsize in _IEEE:
        sign, eloc, esize, mloc, msize, bias = _IEEE[dtype.itemsize]
        bits = order | 0x20 | sign << 8
        return struct.pack("<B3sIHHBBBBI", 0x11, bits.to_bytes(3, "little"), dtype.itemsize, 0,
                           8 * dtype.itemsize, eloc, esize, mloc, msize, bias)
    if dtype.kind == "S":
        return struct.pack("<B3sI", 0x13, (1).to_bytes(3, "little"), dtype.itemsize)
    raise ValueError(f"write_h5 writes integers, IEEE floats and fixed-length bytes, not {dtype}")


def _dataset_header(arr: np.ndarray, data_addr: int) -> bytes:
    space = struct.pack("<BBB5x", 1, arr.ndim, 0) + b"".join(struct.pack("<Q", d) for d in arr.shape)
    fill = struct.pack("<BBBB", 2, 2, 2, 0)  # allocated late, written if set, no value
    layout = struct.pack("<BBQQ", 3, 1, data_addr, arr.nbytes)
    return _object_header([_message(1, space), _message(3, _datatype(arr.dtype)),
                           _message(5, fill), _message(8, layout)])


def _entry(name_off: int, header: int, stab=None) -> bytes:
    if stab is None:
        return struct.pack("<QQII16x", name_off, header, 0, 0)
    return struct.pack("<QQIIQQ", name_off, header, 1, 0, *stab)


class _Group:
    def __init__(self):
        self.children: Dict[str, object] = {}


def _tree(arrays: Dict[str, np.ndarray]) -> _Group:
    root = _Group()
    for key, value in arrays.items():
        parts = key.strip("/").split("/")
        if not all(parts):
            raise ValueError(f"write_h5: {key!r} is not a path of names")
        node = root
        for part in parts[:-1]:
            node = node.children.setdefault(part, _Group())
            if not isinstance(node, _Group):
                raise ValueError(f"write_h5: {key!r} puts a dataset under a dataset")
        if parts[-1] in node.children:
            raise ValueError(f"write_h5: {key!r} names a group and a dataset")
        arr = np.asarray(value)
        _datatype(arr.dtype)
        node.children[parts[-1]] = arr
    return root


def write_h5(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Write ``{"group/name": array}`` as an HDF5 file in h5py's default
    format: a version 0 superblock, symbol-table groups (at most
    ``2·16·2·4 = 256`` names a group, one B-tree node of symbol table nodes)
    and contiguous datasets of integers, IEEE floats or fixed-length bytes."""
    chunks: List[bytes] = []
    pos = [96]  # the superblock comes first

    def place(blob: bytes) -> int:
        addr = pos[0]
        chunks.append(blob + b"\0" * (_pad8(len(blob)) - len(blob)))
        pos[0] += _pad8(len(blob))
        return addr

    def write_group(group: _Group) -> Tuple[int, Tuple[int, int]]:
        names = sorted(group.children, key=lambda s: s.encode("utf-8"))
        if len(names) > 2 * _INTERNAL_K * 2 * _LEAF_K:
            raise ValueError(f"write_h5: {len(names)} names in one group (at most 256)")
        entries = []
        for name in names:
            child = group.children[name]
            if isinstance(child, _Group):
                header, stab = write_group(child)
            else:
                arr = np.asarray(child)  # tobytes is C order; ascontiguousarray would make 0-d 1-d
                data = place(arr.tobytes()) if arr.nbytes else (1 << 64) - 1
                header, stab = place(_dataset_header(arr, data)), None
            entries.append((name, header, stab))
        heap, offsets = b"\0" * 8, []
        for name in names:
            offsets.append(len(heap))
            raw = name.encode("utf-8") + b"\0"
            heap += raw + b"\0" * (_pad8(len(raw)) - len(raw))
        nodes = [entries[i : i + 2 * _LEAF_K] for i in range(0, len(entries), 2 * _LEAF_K)] or [[]]
        snods = []
        for node in nodes:
            body = b"".join(_entry(offsets[names.index(n)], h, s) for n, h, s in node)
            body += b"\0" * ((2 * _LEAF_K - len(node)) * 40)
            snods.append(place(struct.pack("<4sBBH", b"SNOD", 1, 0, len(node)) + body))
        keys = [0] + [offsets[names.index(node[-1][0])] if node else 0 for node in nodes]
        tree = struct.pack("<4sBBHQQ", b"TREE", 0, 0, len(snods), (1 << 64) - 1, (1 << 64) - 1)
        for key, child in zip(keys, snods):
            tree += struct.pack("<QQ", key, child)
        tree += struct.pack("<Q", keys[-1])
        tree += b"\0" * ((2 * _INTERNAL_K - len(snods)) * 16)
        btree = place(tree)
        heap_addr = pos[0]
        place(struct.pack("<4sB3xQQQ", b"HEAP", 0, len(heap), _HEAP_FREE_NULL, heap_addr + 32) + heap)
        header = place(_object_header([_message(0x0011, struct.pack("<QQ", btree, heap_addr))]))
        return header, (btree, heap_addr)

    root_header, root_stab = write_group(_tree(arrays))
    superblock = struct.pack("<8sBBBBBBBBHHI", SIGNATURE, 0, 0, 0, 0, 0, 8, 8, 0, _LEAF_K, _INTERNAL_K, 0)
    superblock += struct.pack("<QQQQ", 0, (1 << 64) - 1, pos[0], (1 << 64) - 1)
    superblock += _entry(0, root_header, root_stab)
    assert len(superblock) == 96
    with open(path, "wb") as f:
        f.write(superblock + b"".join(chunks))
