"""Uncompressed ``.npz`` writing and reading for the S2PT and S2PG caches.

Counterpart of ``point_cloud_classifier_tpu/data/npz_io.py``, copied (the
JAX package's module is numpy-only, but importing it runs the JAX data
package's ``__init__``).  :func:`save_npz` writes the same bytes as the JAX
``save_npz`` for the same arrays: a STORED zip of version 1.0 ``.npy``
members, built in memory and written with one call (the S2PG cache is one
small file an event, so ``np.savez``'s zipfile bookkeeping would dominate
dataset creation).  ``np.load`` reads it.  :func:`load_npz` parses such a
zip straight into ``np.frombuffer`` views over one bytearray, and falls back
to ``np.load`` for anything else (compressed members, zip64, comments,
corrupt members).  Object arrays are refused on save; payloads over 4 GiB go
through ``np.savez`` for its zip64 records.
"""

from __future__ import annotations

import ast
import struct
import zlib
from typing import Dict

import numpy as np

_LOCAL_SIG = 0x04034B50
_CENTRAL_SIG = 0x02014B50
_END_SIG = 0x06054B50
_NPY_MAGIC = b"\x93NUMPY"


def _npy_bytes(a: np.ndarray) -> bytes:
    """Serialize one array in ``.npy`` format (version 1.0, C order)."""
    if not a.flags.c_contiguous:
        # NOT unconditional: np.ascontiguousarray promotes 0-d to 1-d
        a = np.ascontiguousarray(a)
    header = (
        "{'descr': %s, 'fortran_order': False, 'shape': %s, }"
        % (repr(np.lib.format.dtype_to_descr(a.dtype)), repr(a.shape))
    ).encode("latin1")
    # pad so magic+version+len+header is 64-aligned and ends with \n
    # (the .npy spec's alignment rule; np.load only literal_evals the dict,
    # so the exact padding is free-form)
    unpadded = len(_NPY_MAGIC) + 2 + 2 + len(header) + 1
    header += b" " * (-unpadded % 64) + b"\n"
    return b"".join(
        (_NPY_MAGIC, b"\x01\x00", struct.pack("<H", len(header)), header,
         a.tobytes())
    )


def save_npz(path: str, **arrays) -> None:
    """``np.savez`` equivalent (uncompressed), ~2-4x faster on small files.

    Output is a standard STORED zip readable by ``np.load``.  Object-dtype
    arrays fall back to ``np.savez`` (they need pickle framing).
    """
    vals = {k: np.asanyarray(v) for k, v in arrays.items()}
    if any(v.dtype.hasobject for v in vals.values()):
        # np.savez would pickle these — writing a file the paired
        # load_npz (allow_pickle=False, like np.load's default) refuses
        # to read.  No cache in this codebase stores objects; fail loudly
        # instead of writing an unreadable-by-policy artifact.
        raise TypeError(
            "save_npz does not accept object-dtype arrays (pickled members "
            "are rejected on load); use np.savez + np.load(allow_pickle=True) "
            "explicitly if you really need that"
        )
    if sum(v.nbytes for v in vals.values()) > (1 << 32) - (1 << 20):
        # this writer emits no zip64 records; past 4 GiB the offsets would
        # wrap silently.  Per-graph caches are ~KB; anything huge goes the
        # np.savez route (which switches to zip64 itself)
        np.savez(path, **arrays)
        return
    chunks = []
    central = []
    pos = 0
    for name, a in vals.items():
        data = _npy_bytes(a)
        fname = (name + ".npy").encode("ascii")
        crc = zlib.crc32(data)
        local = struct.pack(
            "<IHHHHHIIIHH", _LOCAL_SIG, 20, 0, 0, 0, 0,
            crc, len(data), len(data), len(fname), 0,
        )
        chunks += [local, fname, data]
        central.append((fname, crc, len(data), pos))
        pos += len(local) + len(fname) + len(data)
    cd_start = pos
    for fname, crc, size, offset in central:
        hdr = struct.pack(
            "<IHHHHHHIIIHHHHHII", _CENTRAL_SIG, 20, 20, 0, 0, 0, 0,
            crc, size, size, len(fname), 0, 0, 0, 0, 0, offset,
        )
        chunks += [hdr, fname]
        pos += len(hdr) + len(fname)
    chunks.append(
        struct.pack(
            "<IHHHHIIH", _END_SIG, 0, 0, len(central), len(central),
            pos - cd_start, cd_start, 0,
        )
    )
    blob = b"".join(chunks)
    with open(path, "wb") as f:
        f.write(blob)


def _parse_npy(buf: bytearray, start: int, size: int) -> np.ndarray:
    """One ``.npy`` member at ``buf[start:start+size]`` as a writable view."""
    if bytes(buf[start : start + 6]) != _NPY_MAGIC:
        raise ValueError("not a .npy member")
    major = buf[start + 6]
    if major == 1:
        (hlen,) = struct.unpack_from("<H", buf, start + 8)
        data_off = start + 10 + hlen
        header = bytes(buf[start + 10 : data_off])
    elif major == 2:
        (hlen,) = struct.unpack_from("<I", buf, start + 8)
        data_off = start + 12 + hlen
        header = bytes(buf[start + 12 : data_off])
    else:
        raise ValueError(f"unsupported .npy version {major}")
    meta = ast.literal_eval(header.decode("latin1"))
    dtype = np.dtype(meta["descr"])
    if dtype.hasobject:
        raise ValueError("object arrays need np.load")
    shape = meta["shape"]
    count = 1
    for s in shape:
        if not isinstance(s, int) or s < 0:
            # a corrupt header with a negative dim would flip `count`
            # negative, sail past the bounds check below (the LHS shrinks)
            # and frombuffer(count=-1) would span the rest of the file
            raise ValueError(f"invalid .npy shape {shape!r}")
        count *= s
    if data_off + count * dtype.itemsize > start + size:
        # header claims more data than the zip member holds: frombuffer
        # over the whole-file buffer would silently read into the NEXT
        # member — route corrupt files to the np.load fallback instead
        raise ValueError(".npy payload exceeds its zip member")
    arr = np.frombuffer(buf, dtype=dtype, count=count, offset=data_off)
    arr = arr.reshape(shape, order="F" if meta["fortran_order"] else "C")
    return arr


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """Read an uncompressed ``.npz`` into a dict of writable arrays.

    One file read, no zipfile objects, no CRC pass; arrays are
    ``np.frombuffer`` views over the single bytearray.  Anything
    unexpected (compressed members, zip64, comments, object arrays)
    falls back to ``np.load``.
    """
    with open(path, "rb") as f:
        buf = bytearray(f.read())
    try:
        return _load_from(buf)
    except Exception:
        # context manager: NpzFile holds an open fd, and thousands of
        # fallback loads (a directory of compressed caches) must not keep
        # one each until the garbage collector runs
        with np.load(path, allow_pickle=False) as data:
            return {k: data[k] for k in data.files}


def _load_from(buf: bytearray) -> Dict[str, np.ndarray]:
    if len(buf) < 22:
        raise ValueError("truncated zip")
    eocd = len(buf) - 22
    (sig, _, _, _, n_entries, _, cd_start, comment_len) = struct.unpack_from(
        "<IHHHHIIH", buf, eocd
    )
    if sig != _END_SIG or comment_len != 0:
        raise ValueError("no plain EOCD (zip64 or comment)")
    out: Dict[str, np.ndarray] = {}
    pos = cd_start
    for _ in range(n_entries):
        (csig, _, _, _, method, _, _, _, csize, usize, nlen, xlen, clen,
         _, _, _, offset) = struct.unpack_from("<IHHHHHHIIIHHHHHII", buf, pos)
        if csig != _CENTRAL_SIG:
            raise ValueError("bad central directory")
        if method != 0 or csize != usize:
            raise ValueError("compressed member")
        name = bytes(buf[pos + 46 : pos + 46 + nlen]).decode("utf-8")
        pos += 46 + nlen + xlen + clen
        # local header: name/extra lengths can differ from the central copy
        (lsig, _, _, lmethod, _, _, _, lcsize, _, lnlen, lxlen) = struct.unpack_from(
            "<IHHHHHIIIHH", buf, offset
        )
        if lsig != _LOCAL_SIG or lmethod != 0:
            raise ValueError("bad local header")
        data_start = offset + 30 + lnlen + lxlen
        key = name[:-4] if name.endswith(".npy") else name
        out[key] = _parse_npy(buf, data_start, csize)
    return out
