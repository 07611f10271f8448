"""Reader and writer of the FAISS IVFFlat file (counterpart of
`rvc_tpu/retrieval/faiss_io.py`, its Python parser).

Layout (faiss `impl/index_read.cpp` / `index_write.cpp`, v1.7.x):

    "IwFl" | d:i32 | ntotal:i64 | dummy:i64 x2 | is_trained:u8 |
    metric:i32 | nlist:i64 | nprobe:i64 |
    quantizer IndexFlat: "IxF2"/"IxFI" | header | codes vector (i64 count + raw) |
    direct map: type:u8 | i64 0 |
    "ilar" | nlist:i64 | code_size:i64 | "full" |
    sizes vector (i64 count + i64 x nlist) |
    per list: ids (i64 x n) then codes (u8 x n*code_size)

All fields little-endian. When the direct map does not parse, the reader
scans for the "ilar" marker, as the reference does. A file that does not
parse raises ValueError. The reference's native mmap parser
(`rvc_tpu/native`) is not ported.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from rvc_tpu_torch.retrieval.ivf import IVFFlatIndex

_DUMMY = 1 << 20


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def bytes_(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise ValueError(f"truncated FAISS index: {n} bytes wanted at offset {self.pos} "
                             f"of {len(self.data)}")
        v = self.data[self.pos: self.pos + n]
        self.pos += n
        return v

    def _unpack(self, fmt: str) -> int:
        return struct.unpack(fmt, self.bytes_(struct.calcsize(fmt)))[0]

    def i32(self) -> int:
        return self._unpack("<i")

    def i64(self) -> int:
        return self._unpack("<q")

    def u8(self) -> int:
        return self._unpack("<B")

    def fourcc(self) -> str:
        return self.bytes_(4).decode("latin1")


def _read_index_header(r: _Reader) -> Tuple[int, int, bool, int]:
    d = r.i32()
    ntotal = r.i64()
    r.i64()
    r.i64()
    is_trained = bool(r.u8())
    metric = r.i32()
    if metric > 1:
        r.bytes_(4)  # metric_arg float
    return d, ntotal, is_trained, metric


def _seek_ilar(r: _Reader, start: int) -> None:
    ilar = r.data.find(b"ilar", start)
    if ilar < 0:
        raise ValueError("'ilar' inverted lists marker not found")
    r.pos = ilar + 4


def read_faiss_index(path: str) -> IVFFlatIndex:
    with open(path, "rb") as f:
        data = f.read()
    r = _Reader(data)
    magic = r.fourcc()
    if magic != "IwFl":
        raise ValueError(f"not an IVFFlat index (magic {magic!r})")
    d, ntotal, _, metric = _read_index_header(r)
    nlist = r.i64()
    nprobe = r.i64()

    qmagic = r.fourcc()
    centroids = None
    if qmagic in ("IxF2", "IxFI", "IxFl"):
        qd, qn, _, _ = _read_index_header(r)
        count = r.i64()
        # codes vector: bytes if count == qn*qd*4, floats if count == qn*qd
        if count == qn * qd * 4:
            raw = r.bytes_(count)
        elif count == qn * qd:
            raw = r.bytes_(count * 4)
        else:
            raise ValueError(f"unexpected quantizer codes count {count}")
        centroids = np.frombuffer(raw, dtype="<f4").reshape(qn, qd).astype(np.float32)
        # direct map (type byte + i64 vector length), then "ilar"
        save = r.pos
        try:
            r.u8()
            r.bytes_(r.i64() * 8)
            direct_map_ok = r.fourcc() == "ilar"
        except ValueError:
            direct_map_ok = False
        if not direct_map_ok:
            _seek_ilar(r, save)
    else:
        _seek_ilar(r, 0)

    il_nlist = r.i64()
    code_size = r.i64()
    list_fmt = r.fourcc()
    if list_fmt != "full":
        raise ValueError(f"unsupported inverted list format {list_fmt!r}")
    n_sizes = r.i64()
    if n_sizes != il_nlist:
        raise ValueError(f"{n_sizes} list sizes for {il_nlist} lists")
    sizes = np.frombuffer(r.bytes_(8 * il_nlist), dtype="<i8")

    total = int(sizes.sum())
    dim = code_size // 4
    vectors = np.zeros((total, dim), dtype=np.float32)
    list_ids = np.zeros(total, dtype=np.int32)
    for li, n in enumerate(sizes):
        n = int(n)
        if n == 0:
            continue
        ids = np.frombuffer(r.bytes_(8 * n), dtype="<i8")
        if ids.min() < 0 or ids.max() >= total:
            raise ValueError(f"list {li}: vector ids outside 0..{total - 1}")
        vectors[ids] = np.frombuffer(r.bytes_(code_size * n), dtype="<f4").reshape(n, dim)
        list_ids[ids] = li

    if centroids is None:
        raise ValueError("quantizer centroids missing")
    return IVFFlatIndex(centroids=centroids, vectors=vectors, list_ids=list_ids,
                        nprobe=max(1, int(nprobe)), metric="l2" if metric == 1 else "ip")


def write_faiss_index(index: IVFFlatIndex, path: str) -> None:
    d = index.d
    metric = 1 if index.metric == "l2" else 0
    out = bytearray()

    def w(fmt, *v):
        out.extend(struct.pack(fmt, *v))

    def header(dd, nn, met):
        w("<i", dd)
        w("<q", nn)
        w("<q", _DUMMY)
        w("<q", _DUMMY)
        w("<B", 1)
        w("<i", met)

    out.extend(b"IwFl")
    header(d, index.ntotal, metric)
    w("<q", index.nlist)
    w("<q", index.nprobe)

    # quantizer: IndexFlat with the centroid codes as a uint8 vector
    out.extend(b"IxF2" if metric == 1 else b"IxFI")
    header(d, index.nlist, metric)
    cbytes = np.ascontiguousarray(index.centroids, dtype="<f4").tobytes()
    w("<q", len(cbytes))
    out.extend(cbytes)

    # direct map: NoMap
    w("<B", 0)
    w("<q", 0)

    # inverted lists
    out.extend(b"ilar")
    w("<q", index.nlist)
    w("<q", d * 4)
    out.extend(b"full")
    order = np.argsort(index.list_ids, kind="stable")
    sizes = np.bincount(index.list_ids, minlength=index.nlist).astype("<i8")
    w("<q", index.nlist)
    out.extend(sizes.tobytes())
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    for li in range(index.nlist):
        ids = order[offsets[li]: offsets[li + 1]].astype("<i8")
        out.extend(ids.tobytes())
        out.extend(np.ascontiguousarray(index.vectors[ids], dtype="<f4").tobytes())

    with open(path, "wb") as f:
        f.write(bytes(out))
